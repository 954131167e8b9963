"""Paged KV address arithmetic, int8 pool quantization, and the paged
cross-attention dispatchers.

Counterpart of ``perceiver_io_tpu/ops/paged_attention.py``. The slot
engine's paged layout (:mod:`perceiver_io_tpu_torch.serving.kv_pool`) keeps
every resident's cross-attention k/v in ONE flat token-major pool
``(pool_tokens, heads, head_dim)`` addressed through per-slot block tables;
block 0 is the null block, trash that no masked read uses.

Dispatch of :func:`paged_decode_attention` and :func:`paged_window_attention`:

- **CUDA tensors** launch K4, the ragged paged-attention kernel
  (:mod:`perceiver_io_tpu_torch.ops.ragged_attention`), which reads only the
  live pages through the block table, then ``project_out``. Rows whose
  table maps no page (idle slots) get length 0 and read nothing.
- **CPU tensors** run the gather reference: pages are gathered back into a
  dense ``(b, h, n, d)`` view and the caller's ``attend`` runs on it. Its
  masking is a select on the fp32 logits, so positions that read null-block
  trash contribute exactly what the dense layout's masked garbage does, and
  greedy output is identical to the dense layout — the JAX package's
  default path and its oracle.

Int8 pools (``kv_layout="paged_int8"``) carry per-(position, head) fp32
scales ``(pool_tokens, heads, 1)`` addressed by the same flat indices; a
never-written row has scale 0 and dequantizes to exactly 0.

On a serving mesh (:mod:`perceiver_io_tpu_torch.serving.sharding`) each
rank runs these dispatchers on its own shard: its slot rows' queries at its
share of the heads over its own pool allocated at that share, so K4 runs
per shard on contiguous local tensors and the output projection's
all-reduce (``project_out`` under ``tp``) joins the heads. That is what
JAX's ``gather_constraint`` and the ``shard_map`` around its kernel express
for one controller; there is no whole pool to constrain or slice here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from perceiver_io_tpu_torch.ops.ragged_attention import ragged_paged_attention


def flat_position_indices(table: torch.Tensor, block_size: int, n: int) -> torch.Tensor:
    """Pool indices for token positions ``0..n-1`` through a block table.

    :param table: ``(..., pages)`` int32 block ids (0 = null block).
    :param n: positions to address (``<= pages * block_size``).
    :return: ``(..., n)`` int32 indices into the flat token-major pool.
    """
    pos = torch.arange(n, dtype=torch.int32, device=table.device)
    return table[..., (pos // block_size).long()] * block_size + pos % block_size


def flat_write_indices(table: torch.Tensor, positions: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """Pool indices for per-row write ``positions`` (``(b, ...)``; row ``r``
    indexes its own table row). Same shape as ``positions``, int32."""
    b = table.shape[0]
    positions = positions.to(torch.int32)
    rows = torch.arange(b, device=table.device).reshape((b,) + (1,) * (positions.dim() - 1))
    return table[rows, (positions // block_size).long()] * block_size + positions % block_size


def quantize_kv(x: torch.Tensor):
    """Per-(position, head) symmetric int8 quantization over head_dim:
    scale ``absmax / 127``, round half to even (``torch.round``, as
    ``jnp.round``), clip to ``[-127, 127]``. An all-zero row gets scale 0 and
    quantized 0; the ``max(scale, 1e-30)`` guard keeps the divide finite.

    :return: ``(q, scale)``: int8 of ``x``'s shape, fp32 ``x.shape[:-1] + (1,)``.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)), -127.0, 127.0)
    return q.to(torch.int8), scale


def scatter_kv(pool: torch.Tensor, scale: Optional[torch.Tensor],
               flat_idx: torch.Tensor, values: torch.Tensor):
    """Write ``values`` into the pool at ``flat_idx`` **in place**,
    quantizing when the layout carries scales (then ``scale`` is written in
    place too). The one write primitive of every paged append site.

    :param pool: ``(pool_tokens, h, d)`` flat pool (int8 or float).
    :param scale: ``(pool_tokens, h, 1)`` fp32 scales, or None (exact layout:
        values are cast to the pool's type).
    :param flat_idx: ``(...,)`` flat pool indices.
    :param values: ``flat_idx.shape + (h, d)``.
    :return: ``(pool, scale)``, the same tensors, written.
    """
    idx = flat_idx.long()
    if scale is None:
        pool[idx] = values.to(pool.dtype)
        return pool, None
    q, s = quantize_kv(values)
    pool[idx] = q
    scale[idx] = s.to(scale.dtype)
    return pool, scale


def gather_kv(pool: torch.Tensor, flat_idx: torch.Tensor,
              scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """Gather pool rows into a dense per-slot view ``(b, h, n, d)``,
    dequantizing (``int8 * fp32`` in fp32, then ``out_dtype``) when the
    layout carries scales."""
    idx = flat_idx.long()
    g = pool[idx]
    if scale is not None:
        g = g.float() * scale[idx].float()
        if out_dtype is not None:
            g = g.to(out_dtype)
    return g.permute(0, 2, 1, 3)


def _live_lengths(table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Kernel lengths: 0 for rows whose first page is the null block (an
    idle slot maps nothing), so K4 reads no page for them."""
    return torch.where(table[:, 0] > 0, lengths, torch.zeros_like(lengths)).to(torch.int32)


def _kernel_attention(q, pool_k, pool_v, table, lengths, *, block_size, scale_k, scale_v,
                      project_out):
    if project_out is None:
        raise ValueError("the paged kernel path needs project_out")
    o = ragged_paged_attention(
        q.contiguous(), pool_k, pool_v, table.to(torch.int32).contiguous(),
        _live_lengths(table, lengths).contiguous(),
        block_size=block_size, scale_k=scale_k, scale_v=scale_v,
    )
    return project_out(o.to(q.dtype))


def paged_decode_attention(
    attend: Callable, q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    table: torch.Tensor, *, block_size: int, n: int, pad_mask: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, scale_k: Optional[torch.Tensor] = None,
    scale_v: Optional[torch.Tensor] = None, project_out: Optional[Callable] = None,
) -> torch.Tensor:
    """One decode step's cross attention over the paged pool.

    :param attend: the caller's attend (``mha.attend``, output projection
        included): the gather path runs it on the dense view.
    :param q: ``(b, h, 1, d)`` pre-scaled, pre-rotated query.
    :param table: ``(b, pages)`` block table rows.
    :param n: dense context length addressed by the gather path.
    :param pad_mask: ``(b, n)`` True = masked (gather path).
    :param lengths: ``(b,)`` valid-token counts including the position
        written this step (kernel path).
    :param project_out: ``mha.project_out`` (kernel path).
    :return: projected attention output, as ``attend``'s.
    """
    if q.is_cuda:
        if lengths is None:
            raise ValueError("the paged kernel path needs lengths")
        return _kernel_attention(q, pool_k, pool_v, table, lengths, block_size=block_size,
                                 scale_k=scale_k, scale_v=scale_v, project_out=project_out)
    flat = flat_position_indices(table, block_size, n)
    out_dtype = q.dtype if scale_k is not None else None
    k = gather_kv(pool_k, flat, scale_k, out_dtype)
    v = gather_kv(pool_v, flat, scale_v, out_dtype)
    return attend(q, k, v, pad_mask=pad_mask)


def paged_window_attention(
    attend: Callable, q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    table: torch.Tensor, *, block_size: int, n: int, pad_count: torch.Tensor,
    scale_k: Optional[torch.Tensor] = None, scale_v: Optional[torch.Tensor] = None,
    project_out: Optional[Callable] = None,
) -> torch.Tensor:
    """Window-aligned cross attention of the latent queries over the whole
    ``n``-slot window, front-padded by ``pad_count`` slots (the boundary
    step).

    Gather path: slot ``i`` reads pool position ``max(i - pad, 0)`` and the
    attend's pad and right-aligned causal masks work in slot space. Kernel
    path: dropping the pad slots shifts keys and queries together, so K4's
    position bound over the live span ``[0, n - pad_count)`` is the same mask.
    """
    if q.is_cuda:
        lengths = n - pad_count
        return _kernel_attention(q, pool_k, pool_v, table, lengths, block_size=block_size,
                                 scale_k=scale_k, scale_v=scale_v, project_out=project_out)
    slot_abs = (torch.arange(n, device=q.device)[None, :] - pad_count[:, None]).clamp(min=0)
    flat = flat_write_indices(table, slot_abs, block_size)
    out_dtype = q.dtype if scale_k is not None else None
    k = gather_kv(pool_k, flat, scale_k, out_dtype)
    v = gather_kv(pool_v, flat, scale_v, out_dtype)
    pad_mask = torch.arange(n, device=q.device)[None, :] < pad_count[:, None]
    return attend(q, k, v, pad_mask=pad_mask)
