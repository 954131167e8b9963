"""Scaled dot-product attention: the one attention primitive of every
Perceiver attention module.

Counterpart of ``perceiver_io_tpu/ops/attention.py``. Dispatch
(:func:`kernel_takes`, a pure function of shapes, dtypes, ``causal`` and the key floor):

- ``impl="auto"`` on CUDA tensors launches the flash kernel
  (:mod:`perceiver_io_tpu_torch.ops.flash_attention`) wherever the JAX
  package's kernel test (``flash_attention.supported()``) passes but for its
  block divisibility, so ``q_len = 1`` decode attends and ragged lengths run
  the kernel too. Where JAX refuses for another reason (a q/k or v head dim
  under 32, types that differ or are not fp32/bf16, causal with fewer keys
  than queries) it takes the plain path, as JAX's ``auto`` takes its einsum
  path. Every ``(q/k, v)`` head-dim pair that JAX's kernel takes has a K1
  route: the tile routes' pairs (``flash_attention.HEAD_DIMS``) and the
  ``wide`` route for the rest. Below the key floor ``PERCEIVER_FLASH_MIN_KV``
  (:func:`flash_min_kv`, read at every call; unset or unparseable is 0) it
  takes the plain path, as JAX's ``_flash_eligible`` does. On CPU tensors
  ``auto`` runs the plain path, as the JAX package runs its einsum path off
  the TPU.
- ``impl="flash"`` goes through the kernel's wrapper (on the CPU that is the
  kernel's plain version), whatever the key floor; on a shape that JAX's
  kernel refuses for one of the reasons above it raises ``ValueError``, as
  JAX's does.

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

Attention dropout (train mode, ``dropout_rate > 0``) follows the JAX
package's dispatch (``_flash_eligible``): ``auto`` then takes the plain
path on the card too, since the flash kernel has no dropout, and
``impl="flash"`` with dropout raises ``ValueError``. The plain path drops
entries of the fp32 softmax, each kept with probability ``1 - p`` and scaled
by ``1 / (1 - p)``, before the cast to ``v``'s type; every keep-mask comes
from :func:`dropout_keep`, one draw per head group under
``max_heads_parallel``.

Under a mesh a rank draws its noise as the single-device run would draw
the global tensor and keeps its part of it (:func:`draw_view`: its batch
rows under data parallelism, its heads in a tensor-parallel attention), so
a sharded run's dropout equals the unsharded one's.

- ``impl="ring"`` runs ring attention
  (:func:`perceiver_io_tpu_torch.parallel.ring.ring_attention_sharded`)
  over the ambient mesh's ``seq`` axis (``with mesh:``), as the JAX
  package does. Without a mesh whose ``seq`` axis is larger than 1 it
  warns and takes the plain path (JAX's own behaviour: ring is the same
  function); with attention dropout it raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from perceiver_io_tpu_torch.ops import flash_attention as _flash

_IMPLS = ("auto", "xla", "flash")
#: JAX's kernel takes no head dim below this (``flash_attention.supported``)
MIN_HEAD_DIM = 32


def kernel_refusal(q_shape, k_shape, v_shape, q_dtype, k_dtype, v_dtype, causal: bool) -> Optional[str]:
    """Why the JAX package's flash kernel refuses this attend, or None when it
    takes it: JAX's ``flash_attention.supported()`` without its block
    divisibility test (the port's kernels take any length)."""
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4:
        return "q, k and v must be (b, h, n, d)"
    if q_dtype not in (torch.float32, torch.bfloat16) or k_dtype != q_dtype or v_dtype != q_dtype:
        return f"types {q_dtype}/{k_dtype}/{v_dtype}: the kernel takes one of float32 or bfloat16"
    if causal and k_shape[2] < q_shape[2]:
        return f"causal attention over {k_shape[2]} keys for {q_shape[2]} queries"
    if q_shape[3] < MIN_HEAD_DIM or v_shape[3] < MIN_HEAD_DIM:
        return f"head dims {q_shape[3]}/{v_shape[3]} below {MIN_HEAD_DIM}"
    return None


def flash_min_kv() -> int:
    """``PERCEIVER_FLASH_MIN_KV``: ``auto`` takes the plain path for fewer
    keys than this; unset or unparseable is 0 (JAX's ``_flash_eligible``)."""
    try:
        return int(os.environ.get("PERCEIVER_FLASH_MIN_KV", "0"))
    except ValueError:
        return 0


def kernel_takes(q_shape, k_shape, v_shape, q_dtype, k_dtype, v_dtype, causal: bool, min_kv: int = 0) -> bool:
    """Whether ``impl="auto"`` sends a CUDA attend of these shapes to K1:
    True where JAX's kernel takes it (:func:`kernel_refusal`) and the keys
    reach ``min_kv``, False where JAX's ``auto`` takes its einsum path. K1-K3
    take every such ``(d, dv)`` pair (the tile routes' and, for the rest,
    ``wide``)."""
    return (k_shape[2] >= min_kv
            and kernel_refusal(q_shape, k_shape, v_shape, q_dtype, k_dtype, v_dtype, causal) is None)


def _mask_value() -> float:
    return float(torch.finfo(torch.float32).min)


_VIEW: contextvars.ContextVar = contextvars.ContextVar("perceiver_draw_view", default={})


@contextlib.contextmanager
def draw_view(dim: int, offset: int, total: int):
    """Within the block, a draw of a tensor whose dim ``dim`` is this
    rank's part ``[offset, offset + n)`` of ``total`` draws the whole
    ``total`` and keeps the part (:func:`draw_shape`)."""
    token = _VIEW.set({**_VIEW.get(), dim: (offset, total)})
    try:
        yield
    finally:
        _VIEW.reset(token)


def draw_shape(shape) -> Tuple[tuple, tuple]:
    """``(shape to draw, index of this rank's part)`` for a draw of
    ``shape`` under the enclosing :func:`draw_view` blocks."""
    full, index = list(shape), [slice(None)] * len(shape)
    view: Dict[int, tuple] = _VIEW.get()
    for dim, (offset, total) in view.items():
        if dim < len(shape):
            full[dim] = total
            index[dim] = slice(offset, offset + shape[dim])
    return tuple(full), tuple(index)


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Bool keep-mask of dropout at ``rate``: each entry True with
    probability ``1 - rate`` (JAX ``jax.random.bernoulli(key, 1 - rate,
    shape)``, a uniform draw below ``1 - rate``). The one seam of every
    dropout draw in the port: a test replaces it to feed both packages the
    same masks."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with entries dropped at ``rate`` and the rest scaled by
    ``1 / (1 - rate)`` (flax ``nn.Dropout``); ``rate`` 0 returns ``x``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    full, index = draw_shape(x.shape)
    keep = dropout_keep(full, rate, generator, x.device)[index]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_heads_parallel: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over pre-projected heads.

    :param q: ``(b, h, i, ck)`` queries, pre-scaled by ``ck**-0.5`` and rotated.
    :param k: ``(b, h, j, ck)`` keys (rotated).
    :param v: ``(b, h, j, cv)`` values.
    :param pad_mask: optional bool ``(b, j)``; True marks padding.
    :param causal: right-aligned causal masking.
    :param dropout_rate: attention dropout (train mode); above 0 the plain
        path runs, drawing its masks from ``generator``.
    :param max_heads_parallel: plain path only: at most this many heads at once.
    :param impl: ``"auto" | "xla" | "flash" | "ring"``.
    :return: ``(b, h, i, cv)``.
    """
    if impl == "ring":
        if dropout_rate > 0.0:
            raise ValueError("ring attention does not support attention dropout")
        from perceiver_io_tpu_torch.parallel.mesh import current_mesh

        mesh = current_mesh()
        if mesh is not None and mesh.shape["seq"] > 1:
            from perceiver_io_tpu_torch.parallel.ring import ring_attention_sharded

            return ring_attention_sharded(q, k, v, mesh, axis_name="seq", pad_mask=pad_mask,
                                          causal=causal)
        warnings.warn(
            "impl='ring' without an active Mesh with a 'seq' axis of size > 1 — falling back "
            "to the plain einsum path; wrap the call in `with make_mesh(MeshConfig(seq=...)):` "
            "for sequence-parallel execution", UserWarning, stacklevel=2)
    elif impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "flash" and dropout_rate > 0.0:
        raise ValueError("flash attention does not support attention dropout")
    shapes = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, causal)
    refusal = kernel_refusal(*shapes) if impl == "flash" else None
    if refusal is not None:
        raise ValueError(
            f"flash attention requested but unsupported for shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)}: {refusal}"
        )
    if impl == "flash" or (impl == "auto" and q.is_cuda and dropout_rate == 0.0
                           and kernel_takes(*shapes, min_kv=flash_min_kv())):
        return _flash.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), pad_mask=pad_mask, causal=causal
        )
    num_heads = q.shape[1]
    if max_heads_parallel is None or max_heads_parallel >= num_heads:
        return attention_plain(q, k, v, pad_mask, causal, dropout_rate, generator)
    chunks = []
    for h0 in range(0, num_heads, max_heads_parallel):
        h1 = min(h0 + max_heads_parallel, num_heads)
        chunks.append(attention_plain(q[:, h0:h1], k[:, h0:h1], v[:, h0:h1], pad_mask, causal,
                                      dropout_rate, generator))
    return torch.cat(chunks, dim=1)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pad_mask: Optional[torch.Tensor], causal: bool,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The einsum path (JAX ``_attention_xla``): dropout acts on the fp32
    softmax, before its cast to ``v``'s type."""
    i, j = q.shape[-2], k.shape[-2]
    logits = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask.bool()[:, None, None, :], _mask_value())
    if causal:
        allowed = torch.arange(j, device=q.device)[None, :] <= (
            torch.arange(i, device=q.device)[:, None] + (j - i)
        )
        logits = logits.masked_fill(~allowed[None, None], _mask_value())
    attn = dropout(torch.softmax(logits, dim=-1), dropout_rate, generator).to(v.dtype)
    return torch.einsum("bhij,bhjc->bhic", attn, v)
