"""Exponential-backoff retry for transient data faults. A copy of
``perceiver_io_tpu/reliability/retry.py`` (a module without JAX).

- :func:`call_with_retry` retries a single call (the loader's per-example
  fetch).
- :func:`resilient_source` retries a *stream* (the streaming text
  pipeline's source): on a mid-iteration exception it re-opens the source
  and fast-forwards past the records already emitted, so downstream
  consumers see one uninterrupted, duplicate-free stream. It assumes the
  source replays deterministically; the fast-forward re-reads, so a retry
  costs O(position).

``sleep`` is injectable everywhere, so a test asserts the backoff schedule
without waiting for it; jitter (off by default) comes only from an injected
rng.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt ``k`` (0-based) sleeps
    ``min(backoff_base_s * backoff_factor**k, backoff_max_s)`` before
    retrying; after ``max_retries`` failed attempts the error propagates.

    ``jitter`` spreads retries so N clients backing off from one shared
    fault don't re-dispatch in lockstep (the serving fleet's re-dispatch
    storm after a replica failure, docs/serving.md): with ``jitter=j`` and
    an rng supplied to :meth:`delay_s`, the delay is scaled by a uniform
    factor in ``[1, 1 + j]``. It is OFF unless both are provided — the
    default schedule is a pure function of ``attempt``, so existing
    backoff-schedule chaos assertions stay bit-identical — and
    deterministic under a seeded ``random.Random``."""

    max_retries: int = 3
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    jitter: float = 0.0

    def __post_init__(self):
        if self.jitter < 0.0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")

    def delay_s(self, attempt: int, *, rng=None) -> float:
        delay = min(
            self.backoff_base_s * self.backoff_factor ** attempt,
            self.backoff_max_s,
        )
        if self.jitter > 0.0 and rng is not None:
            delay *= 1.0 + self.jitter * rng.random()
        return delay


def call_with_retry(
    fn: Callable,
    policy: RetryPolicy,
    *,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    rng=None,
):
    """Call ``fn()`` with up to ``policy.max_retries`` backed-off retries.
    ``rng`` (e.g. a seeded ``random.Random``) enables the policy's jitter;
    None keeps the deterministic un-jittered schedule."""
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on as e:
            if attempt >= policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay_s(attempt, rng=rng))
            attempt += 1


def resilient_source(
    source_fn: Callable[[], Iterable],
    policy: RetryPolicy,
    *,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    rng=None,
) -> Iterator:
    """Iterate ``source_fn()``, surviving mid-stream exceptions.

    On a failure, back off per ``policy``, re-invoke ``source_fn`` and skip
    the records already emitted (deterministic replay assumed), then resume
    yielding. The retry budget resets whenever a record is successfully
    emitted, so ``max_retries`` bounds *consecutive* failures, not total
    failures over an arbitrarily long stream.
    """
    emitted = 0
    attempt = 0
    while True:
        try:
            it = iter(source_fn())
            skipped = 0
            while skipped < emitted:  # fast-forward past what we already yielded
                next(it)
                skipped += 1
            for item in it:
                yield item
                emitted += 1
                attempt = 0
            return
        except StopIteration:
            # source shrank below the fast-forward point — nothing to resume
            return
        except policy.retry_on as e:
            if attempt >= policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay_s(attempt, rng=rng))
            attempt += 1
