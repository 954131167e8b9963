"""Scaled dot-product attention: the one attention primitive of every
Perceiver attention module.

Counterpart of ``perceiver_io_tpu/ops/attention.py``. Dispatch:

- ``impl="auto"`` on CUDA tensors launches the flash kernel
  (:mod:`perceiver_io_tpu_torch.ops.flash_attention`) for every shape,
  ``q_len = 1`` decode attends included; on CPU tensors it runs the plain
  path, as the JAX package runs its einsum path off the TPU.
- ``impl="flash"`` always goes through the kernel's wrapper (on the CPU that
  is the kernel's plain version).

The flash branch is differentiable (``FlashAttentionFunction``: the
backward kernels K2/K3 on the card, their plain version on the CPU); the
plain path is differentiated by autograd through the einsum.
- ``impl="xla"`` is the explicit plain path, named after the JAX einsum path
  it mirrors: fp32 logits, ``finfo(float32).min`` where-masking, the
  right-aligned causal mask ``j <= i + (j_len - i_len)``, fp32 softmax cast to
  ``v``'s type, serialised over head groups when ``max_heads_parallel`` is set.

A query row that sees no key differs between the two: the kernel returns
zeros, the plain path a uniform average over the masked keys. Such rows are
padding in every Perceiver model and are discarded.

Ring attention and attention dropout are not ported yet and raise (the
JAX flash path never takes dropout either).
"""
from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_tpu_torch.ops import flash_attention as _flash

_IMPLS = ("auto", "xla", "flash")


def _mask_value() -> float:
    return float(torch.finfo(torch.float32).min)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    max_heads_parallel: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over pre-projected heads.

    :param q: ``(b, h, i, ck)`` queries, pre-scaled by ``ck**-0.5`` and rotated.
    :param k: ``(b, h, j, ck)`` keys (rotated).
    :param v: ``(b, h, j, cv)`` values.
    :param pad_mask: optional bool ``(b, j)``; True marks padding.
    :param causal: right-aligned causal masking.
    :param max_heads_parallel: plain path only: at most this many heads at once.
    :param impl: ``"auto" | "xla" | "flash"``.
    :return: ``(b, h, i, cv)``.
    """
    if impl == "ring":
        raise NotImplementedError("ring attention is not ported yet")
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    if impl == "flash" or (impl == "auto" and q.is_cuda):
        return _flash.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), pad_mask=pad_mask, causal=causal
        )
    num_heads = q.shape[1]
    if max_heads_parallel is None or max_heads_parallel >= num_heads:
        return attention_plain(q, k, v, pad_mask, causal)
    chunks = []
    for h0 in range(0, num_heads, max_heads_parallel):
        h1 = min(h0 + max_heads_parallel, num_heads)
        chunks.append(attention_plain(q[:, h0:h1], k[:, h0:h1], v[:, h0:h1], pad_mask, causal))
    return torch.cat(chunks, dim=1)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pad_mask: Optional[torch.Tensor], causal: bool,
) -> torch.Tensor:
    """The einsum path (JAX ``_attention_xla``) without dropout."""
    i, j = q.shape[-2], k.shape[-2]
    logits = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask.bool()[:, None, None, :], _mask_value())
    if causal:
        allowed = torch.arange(j, device=q.device)[None, :] <= (
            torch.arange(i, device=q.device)[:, None] + (j - i)
        )
        logits = logits.masked_fill(~allowed[None, None], _mask_value())
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bhjc->bhic", attn, v)
