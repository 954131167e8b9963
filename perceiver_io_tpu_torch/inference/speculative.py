"""Self-draft speculative decoding: up to ``k + 1`` tokens per verified forward.

Counterpart of ``perceiver_io_tpu/inference/speculative.py``. A round is:

- **draft** (:func:`propose_tokens`): ``k`` candidate tokens from a
  truncated stack, the first ``draft_layers`` self-attention layers of the
  model itself (no second checkpoint), each step advancing the window as
  the plain step would;
- **verify** (:func:`verify_lanes`): ONE full-model forward over ``k + 1``
  lanes stacked along the batch axis. Lane ``j`` is the right-aligned
  window, pad count and latent count the plain step would hold after
  emitting the first ``j + 1`` candidates, so its logits are the plain
  step's in every phase (latent growth, the ``m == max_latents`` boundary,
  a crossing mid-burst, the sliding window). The latent counts differ per
  row, so the latent stack's pad mask does too (on the card K1 reads it as
  a per-row pad mask);
- **accept** (:func:`accept_prefix`): the longest drafted prefix that
  matches the verified greedy tokens, plus the verified token after it:
  ``n_e`` in ``[1, k + 1]`` tokens a round.

Greedy output is therefore token-identical to the plain step; speculation
changes only how many forwards buy the tokens. Sampling and a repetition
penalty would break the identity and are refused (:func:`validate_spec`).
Whether a round pays is measured by
:func:`~perceiver_io_tpu_torch.inference.decode_strategy.autotune_speculation`.

Where JAX jits the round, the port runs it eagerly; the host reads the
candidates and ``n_e`` once a round and truncates bursts at EOS and
``max_new_tokens``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference.generate import (
    GenerationConfig,
    LatentCount,
    _decode_forward,
    _on_device,
    _stack_pad,
    _window_cross,
)
from perceiver_io_tpu_torch.inference.samplers import apply_min_new_tokens
from perceiver_io_tpu_torch.ops.position import RotaryEmbedding

_MODE_RE = re.compile(r"k(\d+)d(\d+)")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """``k`` drafted tokens a round from a ``draft_layers``-deep stack."""

    k: int
    draft_layers: int

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculation k must be >= 1, got {self.k}")
        if self.draft_layers < 1:
            raise ValueError(f"draft_layers must be >= 1, got {self.draft_layers}")

    @property
    def mode(self) -> str:
        return f"k{self.k}d{self.draft_layers}"


def parse_speculation(mode: Optional[str]) -> Optional[SpecConfig]:
    """``"off"``/None -> None; ``"k4d1"`` -> ``SpecConfig(4, 1)``."""
    if mode is None or mode == "off":
        return None
    match = _MODE_RE.fullmatch(mode)
    if match is None:
        raise ValueError(f"speculation mode must be 'off' or 'k<K>d<D>', got {mode!r}")
    return SpecConfig(int(match.group(1)), int(match.group(2)))


def validate_spec(spec: SpecConfig, model, config: GenerationConfig) -> None:
    """Refuse a geometry or config under which the tokens could differ from
    the plain step's, before anything runs."""
    num_layers = int(model.config.num_self_attention_layers)
    if spec.draft_layers > num_layers:
        raise ValueError(
            f"draft_layers={spec.draft_layers} exceeds the model's {num_layers}-layer stack; "
            "the draft must be a truncation"
        )
    if config.num_beams > 1:
        raise ValueError("speculation is greedy-only; num_beams must be 1")
    if config.sampling.do_sample:
        raise ValueError(
            "speculation is greedy-only: acceptance compares argmaxes, so do_sample=True "
            "cannot be token-identical — disable one of them"
        )
    if float(config.sampling.repetition_penalty) != 1.0:
        raise ValueError(
            "speculation requires repetition_penalty == 1.0: the greedy sampler applies the "
            "penalty before argmax, which the verify lanes do not model"
        )


def draft_forward(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: LatentCount,
                  draft_layers: int) -> torch.Tensor:
    """Truncated-stack forward: :func:`~.generate._decode_forward`'s
    embedding and cross layer, then only the first ``draft_layers``
    self-attention layers (rotary on the first layer only, as the stack
    applies it), then the head. With ``draft_layers`` the whole stack this
    is :func:`~.generate._decode_forward`.

    :return: next-token logits ``(b, vocab)``.
    """
    ar = mdl.perceiver_ar
    num_latents = mdl.max_latents
    x, _, _, frq = _window_cross(mdl, window, pad_count, m)
    stack_pad = _stack_pad(window.shape[0], num_latents, m, window.device)
    rot = RotaryEmbedding(frq[:, -num_latents:], right_align=True)
    for i, layer in enumerate(ar.self_attention.layers[:draft_layers]):
        x = layer(x, stack_pad, rot if i == 0 else None)
    return mdl.head(x[:, -1])


def _greedy(logits: torch.Tensor, steps: torch.Tensor, min_new: int, eos_token_id: int):
    """The plain step's choice: fp32 argmax (first index on ties) after the
    min-new-tokens EOS mask at each row's step."""
    return torch.argmax(apply_min_new_tokens(logits.float(), steps[:, None], min_new,
                                             eos_token_id), dim=-1)


def propose_tokens(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: torch.Tensor,
                   steps: torch.Tensor, logits: torch.Tensor, k: int, draft_layers: int,
                   min_new: int, eos_token_id: int) -> torch.Tensor:
    """Draft phase: ``(b, k+1)`` candidates. ``cand[:, 0]`` is exact, the
    greedy token of the verified ``logits``; ``cand[:, 1:]`` come from ``k``
    truncated-stack steps, each advancing the window, pad and latent count
    one shift as the plain step would."""
    num_latents = mdl.max_latents
    tok = _greedy(logits, steps, min_new, eos_token_id).to(window.dtype)
    cand = [tok]
    w, p, mm, st = window, pad_count, m, steps
    for _ in range(k):
        w = torch.cat([w[:, 1:], tok[:, None]], dim=1)
        p = (p - 1).clamp(min=0)
        mm = (mm + 1).clamp(max=num_latents)
        st = st + 1
        tok = _greedy(draft_forward(mdl, w, p, mm, draft_layers), st, min_new,
                      eos_token_id).to(window.dtype)
        cand.append(tok)
    return torch.stack(cand, dim=1)


def verify_lanes(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: torch.Tensor,
                 cand: torch.Tensor) -> torch.Tensor:
    """Verify phase: ONE full-model forward over the ``k+1`` lanes.

    Lane ``j`` is what the plain step would hold after emitting
    ``cand[:, :j+1]``: window ``ext[:, j+1 : j+1+n]`` (``ext`` = window and
    candidates), pad ``max(pad - (j+1), 0)``, latent count
    ``min(m + j + 1, max_latents)``. The lanes stack along the batch axis
    (row ``i * (k+1) + j``) into one ``(b*(k+1), n)`` call.

    :return: ``(b, k+1, vocab)`` lane logits in the model's type.
    """
    b, n = window.shape
    k1 = cand.shape[1]
    num_latents = mdl.max_latents
    ext = torch.cat([window, cand.to(window.dtype)], dim=1)
    lanes = torch.stack([ext[:, j + 1:j + 1 + n] for j in range(k1)], dim=1)
    offs = torch.arange(1, k1 + 1, device=window.device)
    lane_pad = (pad_count[:, None] - offs[None, :]).clamp(min=0)
    lane_m = (torch.as_tensor(m, device=window.device).expand(b)[:, None]
              + offs[None, :]).clamp(max=num_latents)
    lane_logits = _decode_forward(mdl, lanes.reshape(b * k1, n),
                                  lane_pad.reshape(b * k1).to(pad_count.dtype),
                                  lane_m.reshape(b * k1))
    return lane_logits.reshape(b, k1, -1)


def accept_prefix(lane_logits: torch.Tensor, cand: torch.Tensor, steps: torch.Tensor,
                  min_new: int, eos_token_id: int):
    """Accept phase: ``cand[:, j+1]`` is accepted iff it equals lane ``j``'s
    verified greedy token (at the step the plain engine would be at) and
    every earlier draft was. ``n_e = 1 + accepted``; the next round's logits
    are lane ``n_e - 1``'s, raw.

    :return: ``(n_e (b,), next_logits (b, vocab))``.
    """
    b, k1, vocab = lane_logits.shape
    k = k1 - 1
    if k > 0:
        st = steps[:, None] + torch.arange(1, k + 1, device=steps.device)[None, :]
        pred = _greedy(lane_logits[:, :k].reshape(b * k, vocab), st.reshape(b * k), min_new,
                       eos_token_id).reshape(b, k)
        match = (cand[:, 1:] == pred.to(cand.dtype)).long()
        n_e = 1 + torch.cumprod(match, dim=1).sum(dim=1)
    else:
        n_e = torch.ones((b,), dtype=torch.long, device=cand.device)
    next_logits = lane_logits[torch.arange(b, device=cand.device), n_e - 1]
    return n_e, next_logits


def advance_window(window: torch.Tensor, pad_count: torch.Tensor, m: torch.Tensor,
                   cand: torch.Tensor, n_e: torch.Tensor, num_latents: int):
    """The window state past ``n_e`` accepted tokens, as ``n_e`` plain steps
    would leave it. :return: ``(window, pad_count, m)``."""
    n = window.shape[1]
    ext = torch.cat([window, cand.to(window.dtype)], dim=1)
    idx = n_e[:, None] + torch.arange(n, device=window.device)[None, :]
    return (torch.gather(ext, 1, idx), (pad_count - n_e).clamp(min=0),
            (m + n_e).clamp(max=num_latents))


def speculative_generate(model, input_ids, config: GenerationConfig, spec: SpecConfig, *,
                         prompt_pad_count=None, device: DeviceLike = "cuda") -> torch.Tensor:
    """Greedy generation through draft/verify rounds; token-identical to
    :func:`~.generate.generate` by the lane construction. The host reads
    each round's candidates and ``n_e`` and stops a row at EOS or
    ``max_new_tokens``, mid-burst.

    :return: ``(b, max_new_tokens)`` ids on ``device`` (pad after EOS).
    """
    dev = resolve_device(device)
    if not _on_device(model, dev):
        raise ValueError(f"model lies on {model.device}, speculative_generate was asked for {dev}")
    validate_spec(spec, model, config)
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, prompt_len = input_ids.shape
    n, max_latents = model.max_seq_len, model.max_latents
    if not 0 < prompt_len <= n:
        raise ValueError(f"prompt length out of valid range [1..{n}]")
    num_latents = min(prompt_len, config.num_latents)
    if prompt_pad_count is None:
        prompt_pad_count = torch.zeros((b,), dtype=torch.long)
    min_new = config.min_new_tokens if config.eos_token_id is not None else 0
    eos = config.eos_token_id if config.eos_token_id is not None else 0

    window = torch.full((b, n), config.pad_token_id, dtype=torch.long, device=dev)
    window[:, n - prompt_len:] = input_ids
    pad = torch.as_tensor(prompt_pad_count, device=dev).long() + (n - prompt_len)
    m = torch.full((b,), num_latents, dtype=torch.long, device=dev)
    steps = torch.zeros((b,), dtype=torch.long, device=dev)
    emitted = [[] for _ in range(b)]
    done = [False] * b
    with torch.no_grad():
        logits = _decode_forward(model, window, pad, m)
        while not all(done):
            cand = propose_tokens(model, window, pad, m, steps, logits, spec.k,
                                  spec.draft_layers, min_new, eos)
            lane_logits = verify_lanes(model, window, pad, m, cand)
            n_e, logits = accept_prefix(lane_logits, cand, steps, min_new, eos)
            window, pad, m = advance_window(window, pad, m, cand, n_e, max_latents)
            steps = steps + n_e
            cand_np, n_e_np = cand.cpu().numpy(), n_e.cpu().numpy()  # host sync
            for row in range(b):
                if done[row]:
                    continue
                for token in cand_np[row, :int(n_e_np[row])]:
                    emitted[row].append(int(token))
                    if (config.eos_token_id is not None and token == config.eos_token_id) \
                            or len(emitted[row]) >= config.max_new_tokens:
                        done[row] = True
                        break
    out = np.full((b, config.max_new_tokens), config.pad_token_id, np.int64)
    for row in range(b):
        out[row, :len(emitted[row])] = emitted[row]
    return torch.from_numpy(out).to(device=dev, dtype=input_ids.dtype)
