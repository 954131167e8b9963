"""Static shape-bucket grid for the serving engine: every served micro-batch
is padded up to one ``(batch_size, prompt_len)`` cell. A copy of
``perceiver_io_tpu/serving/buckets.py`` (pure shape arithmetic)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple


def _pow2_span(lo: int, hi: int) -> Tuple[int, ...]:
    """Powers of two starting at ``lo``, ending with ``hi`` itself."""
    vals = []
    v = max(1, int(lo))
    while v < hi:
        vals.append(v)
        v *= 2
    vals.append(int(hi))
    return tuple(vals)


@dataclass(frozen=True)
class BucketTable:
    """Grid of serving shapes. Both axes are strictly increasing; a request
    rounds up to the smallest bucket that fits."""

    prompt_lens: Tuple[int, ...]
    batch_sizes: Tuple[int, ...]

    def __post_init__(self):
        for name in ("prompt_lens", "batch_sizes"):
            vals = tuple(int(v) for v in getattr(self, name))
            if not vals or any(v <= 0 for v in vals) or vals != tuple(sorted(set(vals))):
                raise ValueError(
                    f"{name} must be a non-empty, positive, strictly "
                    f"increasing sequence, got {getattr(self, name)!r}"
                )
            object.__setattr__(self, name, vals)

    @classmethod
    def for_model(cls, model, *, max_batch_size: int = 8, min_prompt_len: int = 16) -> "BucketTable":
        """Power-of-two grid up to the model's context length."""
        n = int(model.max_seq_len)
        return cls(
            prompt_lens=_pow2_span(min(min_prompt_len, n), n),
            batch_sizes=_pow2_span(1, max_batch_size),
        )

    def prompt_bucket(self, length: int) -> int:
        """Smallest prompt bucket >= ``length``; raises when none fits."""
        for cap in self.prompt_lens:
            if cap >= length:
                return cap
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket "
            f"{self.prompt_lens[-1]}; extend the bucket table"
        )

    def batch_bucket(self, n: int) -> int:
        """Smallest batch bucket >= ``n``, else the largest bucket."""
        for cap in self.batch_sizes:
            if cap >= n:
                return cap
        return self.batch_sizes[-1]

    def grid(self) -> Iterator[Tuple[int, int]]:
        """All ``(batch_size, prompt_len)`` cells."""
        for b in self.batch_sizes:
            for length in self.prompt_lens:
                yield b, length

    def __len__(self) -> int:
        return len(self.prompt_lens) * len(self.batch_sizes)
