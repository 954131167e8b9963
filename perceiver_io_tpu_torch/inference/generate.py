"""Autoregressive generation for Perceiver AR sequence models: greedy and
sampled decoding (``num_beams > 1`` dispatches to :mod:`.beam`).

Counterpart of ``perceiver_io_tpu/inference/generate.py``, with the same
right-aligned static window and the same phase plan:

- the token window is always ``(b, max_seq_len)``, left padding tracked by
  ``pad_count``; the latent segment is the last ``max_latents`` slots, of
  which the last ``m`` are real latents. Rows that are not yet latents are
  computed and discarded, and their keys are masked, so masks and garbage
  rows match the JAX program exactly;
- phase 1, latent growth (:func:`_decode_step`): only the new token runs
  through the model, over the cross and per-layer stack caches;
- phase 2, prefix growth (:func:`_decode_step_boundary`): the oldest latent
  migrates to the prefix each step, its k/v re-projected ``kv_norm``-side;
  the latents and the stack are recomputed over the cached keys;
- phase 3, sliding window (:func:`_decode_forward`): a full recompute per
  token, forced by the window-relative learned position embedding.

Where JAX runs one ``lax.scan`` per phase, the port runs a Python loop over
the same fixed-shape step. JAX's functional cache updates become in-place
writes into the cache tensors (``index_put_`` through indexing assignment);
each is marked "in place" below. The only host read is of the prompt pad
counts, before the loop.

The slot engine (:mod:`perceiver_io_tpu_torch.serving.slots`) advances rows
that sit at different steps: :func:`_slot_decode_step` takes per-row
``length``/``m`` vectors, and :func:`_slot_decode_step_paged` /
:func:`_decode_step_boundary_paged` run the two cached steps over the
block-paged KV pool. Where JAX computes two steps on every row and selects
per row, the port's in-place steps take ``write_ok`` and write only the rows
each step owns. It admits long prompts in pieces: :func:`_prefill_chunk_kv`
projects a chunk of prefix positions, and :func:`_prefill_finalize` (staged
dense caches) or :func:`_prefill_finalize_paged` (the pool, where shared
prefix pages already sit) completes the row. On a serving mesh
(:mod:`perceiver_io_tpu_torch.serving.sharding`) each of these helpers runs
on one rank's shard: its slot rows and, through the model's tensor-parallel
``tp`` (``project_q`` / ``project_kv`` / ``project_out`` / ``attend`` /
``mlp``), its share of the heads; every head count is read off the
projections' outputs or the caches, and the LM head is replicated.

The boundary phase's step is a measured choice
(:mod:`~perceiver_io_tpu_torch.inference.decode_strategy`): ``"auto"`` reads
the registry verdict and falls back to the cached step.

A sampled step draws one ``(b, V)`` Gumbel tensor from the caller's
``torch.Generator`` (:func:`~.samplers.gumbel_noise`), where JAX draws from
``jax.random.split(rng, max_new_tokens)[t]``. The executor cache is not
ported (nothing compiles per shape in PyTorch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference import decode_strategy as decode_strategy_mod
from perceiver_io_tpu_torch.inference.samplers import (
    SamplingConfig,
    apply_min_new_tokens,
    default_generator,
    sample_logits,
)
from perceiver_io_tpu_torch.models.core.modules import layer_norm
from perceiver_io_tpu_torch.ops import paged_attention as paged
from perceiver_io_tpu_torch.ops.position import RotaryEmbedding, positions

#: a latent count: one host int for every row, or a per-row ``(b,)`` tensor
LatentCount = Union[int, torch.Tensor]


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    num_latents: int = 1
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    sampling: SamplingConfig = SamplingConfig()
    #: beam width; > 1 dispatches :func:`generate` to beam search
    num_beams: int = 1
    #: HF exponent on generated length when beam search ranks hypotheses
    length_penalty: float = 1.0
    #: EOS is masked to -inf until this many new tokens exist
    min_new_tokens: int = 0


def _per_row(m: LatentCount) -> bool:
    return isinstance(m, torch.Tensor) and m.dim() > 0


def _window_cross(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: LatentCount):
    """Embedding and cross-attention layer over the right-aligned window.

    :param m: the true latent count, a host int or per-row ``(b,)``.
    :return: ``(x, k, v, frq)``: the latent segment after the cross layer,
        the window-slot keys/values, and the rotary angles.
    """
    ar = mdl.perceiver_ar
    b, n = window.shape
    num_latents = mdl.max_latents
    layer = ar.cross_attention
    mha = layer.cross_attn.attention
    pad_mask = torch.arange(n, device=window.device)[None, :] < pad_count[:, None]
    emb, frq = ar.input_adapter(window, abs_pos=positions(b, n, shift=pad_count[:, None]))
    # latent-classified keys are q_norm'ed, prefix keys kv_norm'ed: the
    # boundary is dynamic, so select by mask
    ca = layer.cross_attn
    slots = torch.arange(n, device=window.device)
    if _per_row(m):
        is_latent = (slots >= n - num_latents)[None, :] & (slots[None, :] >= n - m[:, None])
    else:
        is_latent = ((slots >= n - num_latents) & (slots >= n - m))[None, :]
    x_q_all = layer_norm(ca.q_norm, emb, ca.dtype)
    x_kv = torch.where(is_latent[..., None], x_q_all, layer_norm(ca.kv_norm, emb, ca.dtype))
    rot = RotaryEmbedding(frq, right_align=True)
    q = mha.project_q(x_q_all[:, -num_latents:], rot)
    k, v = mha.project_kv(x_kv, rot)
    x = mha.attend(q, k, v, pad_mask=pad_mask) + emb[:, -num_latents:]
    x = layer.mlp(x) + x
    return x, k, v, frq


def _stack_pad(b: int, num_latents: int, m: LatentCount, device) -> torch.Tensor:
    """``(b, num_latents)`` True at latent-segment slots that are not yet
    real latents (``m`` a host int or per-row ``(b,)``)."""
    seg = torch.arange(num_latents, device=device)
    if _per_row(m):
        return seg[None, :] < (num_latents - m)[:, None]
    return (seg < num_latents - m)[None].expand(b, num_latents)


def _decode_forward(mdl, window: torch.Tensor, pad_count: torch.Tensor,
                    m: LatentCount) -> torch.Tensor:
    """Static-shape forward over the right-aligned window; next-token logits
    ``(b, vocab)`` for the last position.

    :param window: ``(b, N)`` tokens, right-aligned, left pads arbitrary ids.
    :param pad_count: ``(b,)`` left-pad slots per row.
    :param m: true latent count (the last ``m`` window positions): a host
        int, or per-row ``(b,)`` (the speculative verify lanes give each row
        its own count; the int path is unchanged).
    """
    ar = mdl.perceiver_ar
    b = window.shape[0]
    num_latents = mdl.max_latents
    x, _, _, frq = _window_cross(mdl, window, pad_count, m)
    x = ar.self_attention(
        x, _stack_pad(b, num_latents, m, window.device),
        RotaryEmbedding(frq[:, -num_latents:], right_align=True),
    )
    return mdl.head(x[:, -1])


def _latent_stack_capture(ar, x, stack_pad, rot_latent, seg_idx):
    """Self-attention stack over the latent segment, capturing per-layer k/v
    at the real latents' segment slots ``seg_idx`` (rotary on layer 0 only).

    :return: ``(x, stack_k, stack_v)``.
    """
    stack_k, stack_v = [], []
    for i, sa_layer in enumerate(ar.self_attention.layers):
        sa = sa_layer.self_attn
        r = rot_latent if i == 0 else None
        normed = layer_norm(sa.norm, x, sa.dtype)
        q_s = sa.attention.project_q(normed, r)
        k_s, v_s = sa.attention.project_kv(normed, r)
        stack_k.append(k_s.index_select(2, seg_idx))
        stack_v.append(v_s.index_select(2, seg_idx))
        x = sa.attention.attend(q_s, k_s, v_s, pad_mask=stack_pad) + x
        x = sa_layer.mlp(x) + x
    return x, stack_k, stack_v


def _decode_prefill(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: int):
    """Forward over the right-aligned window that also builds the decode
    caches for latent growth, **left-aligned by token index**
    ``p = slot - pad_count``:

    - ``cross_k/v`` ``(b, h, N, d)``: cross keys/values of every real token in
      its boundary-side normalisation;
    - ``stack_k/v``: per layer ``(b, h, max_latents, d)`` over the ``m`` real
      latents, left-aligned by latent age.

    :return: ``(logits, cache, length (b,), m)``.
    """
    b, n = window.shape
    dev = window.device
    x, k, v, frq = _window_cross(mdl, window, pad_count, m)

    # left-align the window-slot cross k/v by token index
    slot_idx = (torch.arange(n, device=dev)[None, :] + pad_count[:, None]).clamp(0, n - 1)
    idx = slot_idx[:, None, :, None]
    cross_k = torch.gather(k, 2, idx.expand(b, k.shape[1], n, k.shape[3]))
    cross_v = torch.gather(v, 2, idx.expand(b, v.shape[1], n, v.shape[3]))
    length = n - pad_count

    logits, stack_k, stack_v = _capture_stack(mdl, x, frq[:, -mdl.max_latents:], m)
    cache = {"cross_k": cross_k, "cross_v": cross_v, "stack_k": stack_k, "stack_v": stack_v}
    return logits, cache, length, m


def _capture_stack(mdl, x: torch.Tensor, frq_lat: torch.Tensor, m: int):
    """The self-attention stack over the latent segment ``x`` (after the
    cross layer), capturing per-layer caches over the ``m`` real latents,
    left-aligned by latent age; then the head.

    :return: ``(logits, stack_k, stack_v)``.
    """
    b, num_latents = x.shape[:2]
    dev = x.device
    seg_idx = (num_latents - m + torch.arange(num_latents, device=dev)).clamp(0, num_latents - 1)
    x, stack_k, stack_v = _latent_stack_capture(
        mdl.perceiver_ar, x, _stack_pad(b, num_latents, m, dev),
        RotaryEmbedding(frq_lat, right_align=True), seg_idx,
    )
    return mdl.head(x[:, -1]), stack_k, stack_v


def _prefill_chunk_kv(mdl, tokens: torch.Tensor, offset: int):
    """Cross k/v (``kv_norm``-side) of ``C`` consecutive **prefix** token
    positions ``offset .. offset + C - 1``: the unit of chunked prefill.

    The prefill's cross cache is per-position math (embedding at the token's
    absolute index, ``kv_norm``, projection with rotary at angle ``p``), so a
    chunk computes the values the one-shot :func:`_decode_prefill` leaves at
    those positions, and the slot engine can split a long admission into
    pieces interleaved with the residents' decode steps.

    :param tokens: ``(b, C)`` token ids.
    :return: ``(k, v)``, each ``(b, h, C, d)``.
    """
    ar = mdl.perceiver_ar
    b, c = tokens.shape
    pos = (offset + torch.arange(c, device=tokens.device))[None, :].expand(b, c)
    emb, frq = ar.input_adapter(tokens, abs_pos=pos)
    ca = ar.cross_attention.cross_attn
    return ca.attention.project_kv(layer_norm(ca.kv_norm, emb, ca.dtype), RotaryEmbedding(frq))


def _finalize_latents(mdl, window: torch.Tensor, pad_count: torch.Tensor):
    """The latent segment of a chunked prefill's finalize: its slots' true
    token indices, ``q_norm``-side k/v and queries.

    :return: ``(idx (b, I), k_lat, v_lat (b, h, I, d), q, emb_lat, frq_lat)``;
        ``idx`` clamps pad slots (prompt shorter than the segment) to 0.
    """
    ar = mdl.perceiver_ar
    n = window.shape[1]
    num_latents = mdl.max_latents
    ca = ar.cross_attention.cross_attn
    mha = ca.attention
    p_seg = torch.arange(n - num_latents, n, device=window.device)[None, :] - pad_count[:, None]
    emb_lat, frq_lat = ar.input_adapter(window[:, n - num_latents:], abs_pos=p_seg.clamp(min=0))
    x_q_lat = layer_norm(ca.q_norm, emb_lat, ca.dtype)
    k_lat, v_lat = mha.project_kv(x_q_lat, RotaryEmbedding(frq_lat))
    q = mha.project_q(x_q_lat, RotaryEmbedding(frq_lat, right_align=True))
    return p_seg.clamp(0, n - 1), k_lat, v_lat, q, emb_lat, frq_lat


def _finalize_stack(mdl, attn: torch.Tensor, emb_lat: torch.Tensor, frq_lat: torch.Tensor, m: int):
    """Cross-layer residual and MLP, then :func:`_capture_stack`."""
    x = attn + emb_lat
    x = mdl.perceiver_ar.cross_attention.mlp(x) + x
    return _capture_stack(mdl, x, frq_lat, m)


def _prefill_finalize(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: int,
                      cross_k: torch.Tensor, cross_v: torch.Tensor):
    """Complete a chunked prefill whose prefix cross k/v were staged by
    :func:`_prefill_chunk_kv` calls into ``cross_k/v`` ``(b, h, N, d)``
    (left-aligned by token index): write the ``m`` real latents'
    ``q_norm``-side k/v there **in place** (the other segment slots keep
    their staged entries, as JAX's ``mode="drop"`` scatter does), attend the
    latent segment over the cache gathered back into window-slot order, and
    run the stack capturing its caches.

    :param m: the true latent count (a host int).
    :return: ``(logits, cache, length, m)``, :func:`_decode_prefill`'s contract.
    """
    b, n = window.shape
    num_latents = mdl.max_latents
    idx, k_lat, v_lat, q, emb_lat, frq_lat = _finalize_latents(mdl, window, pad_count)
    real = slice(num_latents - m, num_latents)
    rows = torch.arange(b, device=window.device)[:, None]
    _put_rows(cross_k, rows, idx[:, real], k_lat[:, :, real].transpose(1, 2), None)
    _put_rows(cross_v, rows, idx[:, real], v_lat[:, :, real].transpose(1, 2), None)
    mha = mdl.perceiver_ar.cross_attention.cross_attn.attention
    attn = _window_attend(mha, q, cross_k, cross_v, pad_count)
    logits, stack_k, stack_v = _finalize_stack(mdl, attn, emb_lat, frq_lat, m)
    cache = {"cross_k": cross_k, "cross_v": cross_v, "stack_k": stack_k, "stack_v": stack_v}
    return logits, cache, n - pad_count, m


def _prefill_finalize_paged(mdl, window: torch.Tensor, pad_count: torch.Tensor, m: int,
                            pool_k: torch.Tensor, pool_v: torch.Tensor, table_row: torch.Tensor,
                            block_size: int, scale_k: Optional[torch.Tensor] = None,
                            scale_v: Optional[torch.Tensor] = None):
    """:func:`_prefill_finalize` over the block-paged pool, whose prefix
    cross k/v are **already resident**: shared blocks another request
    published and this admission's own staged chunks. The ``m`` real
    latents' k/v scatter **in place** through the slot's block table
    (quantized under int8 scales); the other segment slots route to the null
    block, so staged and shared prefix values survive. The window attend
    goes through
    :func:`~perceiver_io_tpu_torch.ops.paged_attention.paged_window_attention`
    (K4 on the card, the gather reference on the CPU).

    :param table_row: ``(pages,)`` or ``(b, pages)`` block table.
    :return: ``(logits, cache, length, m)``; ``cache`` holds the stack only.
    """
    n = window.shape[1]
    num_latents = mdl.max_latents
    table = table_row[None] if table_row.dim() == 1 else table_row
    idx, k_lat, v_lat, q, emb_lat, frq_lat = _finalize_latents(mdl, window, pad_count)
    is_real = torch.arange(num_latents, device=window.device)[None, :] >= num_latents - m
    flat = paged.flat_write_indices(table, idx, block_size)
    flat = torch.where(is_real, flat, (idx % block_size).to(flat.dtype))  # null block
    paged.scatter_kv(pool_k, scale_k, flat, k_lat.transpose(1, 2))
    paged.scatter_kv(pool_v, scale_v, flat, v_lat.transpose(1, 2))
    mha = mdl.perceiver_ar.cross_attention.cross_attn.attention
    attn = paged.paged_window_attention(
        mha.attend, q, pool_k, pool_v, table, block_size=block_size, n=n, pad_count=pad_count,
        scale_k=scale_k, scale_v=scale_v, project_out=mha.project_out,
    )
    logits, stack_k, stack_v = _finalize_stack(mdl, attn, emb_lat, frq_lat, m)
    return logits, {"stack_k": stack_k, "stack_v": stack_v}, n - pad_count, m


def _put_rows(cache: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
              values: torch.Tensor, write_ok: Optional[torch.Tensor]) -> None:
    """``cache[rows, :, idx] = values`` **in place**; rows whose ``write_ok``
    is False keep their old entries (None: every row writes). The in-place
    form of JAX's per-row ``where`` select between two steps' caches."""
    values = values.to(cache.dtype)
    if write_ok is not None:
        keep = write_ok.reshape(write_ok.shape + (1,) * (values.dim() - 1))
        values = torch.where(keep, values, cache[rows, :, idx])
    cache[rows, :, idx] = values


def _boundary_update(mdl, window: torch.Tensor, pad_count: torch.Tensor, length: torch.Tensor):
    """The cache writes and latent queries of a prefix-growth step.

    The new token enters as the freshest latent (``q_norm``-side k/v at index
    ``length``, clamped to ``N - 1`` for idle slots whose counter saturated)
    and the oldest latent (index ``N - max_latents - 1 - pad_count``) becomes
    prefix (``kv_norm``-side k/v).

    :return: ``(write_idx (b, 2), k_upd, v_upd (b, 2, h, d), q, emb_lat,
        frq_lat)``.
    """
    ar = mdl.perceiver_ar
    n = window.shape[1]
    num_latents = mdl.max_latents
    dev = window.device
    ca = ar.cross_attention.cross_attn
    mha = ca.attention

    mig_abs = ((n - num_latents - 1) - pad_count[:, None]).clamp(min=0)
    write_idx = torch.cat([mig_abs, length.clamp(max=n - 1)[:, None]], dim=1)  # always distinct

    lat_abs = (torch.arange(n - num_latents, n, device=dev)[None, :] - pad_count[:, None]).clamp(min=0)
    emb_lat, frq_lat = ar.input_adapter(window[:, n - num_latents:], abs_pos=lat_abs)
    x_q_lat = layer_norm(ca.q_norm, emb_lat, ca.dtype)

    emb_mig, frq_mig = ar.input_adapter(window[:, n - num_latents - 1:n - num_latents], abs_pos=mig_abs)
    k_mig, v_mig = mha.project_kv(layer_norm(ca.kv_norm, emb_mig, ca.dtype), RotaryEmbedding(frq_mig))
    k_new, v_new = mha.project_kv(x_q_lat[:, -1:], RotaryEmbedding(frq_lat[:, -1:]))
    k_upd = torch.cat([k_mig, k_new], dim=2).transpose(1, 2)
    v_upd = torch.cat([v_mig, v_new], dim=2).transpose(1, 2)
    q = mha.project_q(x_q_lat, RotaryEmbedding(frq_lat, right_align=True))
    return write_idx, k_upd, v_upd, q, emb_lat, frq_lat


def _boundary_finish(mdl, attn: torch.Tensor, emb_lat: torch.Tensor, frq_lat: torch.Tensor):
    """Cross-layer residual and MLP, then the whole self-attention stack over
    the ``max_latents`` latents (all real); next-token logits ``(b, vocab)``."""
    ar = mdl.perceiver_ar
    x = attn + emb_lat
    x = ar.cross_attention.mlp(x) + x
    stack_pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    x = ar.self_attention(x, stack_pad, RotaryEmbedding(frq_lat, right_align=True))
    return mdl.head(x[:, -1])


def _decode_step_boundary(mdl, window: torch.Tensor, pad_count: torch.Tensor,
                          cross_k: torch.Tensor, cross_v: torch.Tensor, length: torch.Tensor,
                          write_ok: Optional[torch.Tensor] = None):
    """One cached prefix-growth step (latent count pinned at ``max_latents``).

    The migration and append writes (:func:`_boundary_update`) land in one
    scatter per cache array, **in place**; ``write_ok`` (per-row bool) keeps
    the old entries of rows this step does not own. The attend runs over the
    cache gathered back into window-slot order, so masks match
    :func:`_decode_forward`.

    :param window: ``(b, N)`` tokens, new token last.
    :param pad_count: ``(b,)`` left-pad counts after the append.
    :param length: ``(b,)`` real-token count before the append.
    :return: ``(logits, cross_k, cross_v, length + 1)``.
    """
    rows = torch.arange(window.shape[0], device=window.device)
    write_idx, k_upd, v_upd, q, emb_lat, frq_lat = _boundary_update(mdl, window, pad_count, length)
    _put_rows(cross_k, rows[:, None], write_idx, k_upd, write_ok)
    _put_rows(cross_v, rows[:, None], write_idx, v_upd, write_ok)
    mha = mdl.perceiver_ar.cross_attention.cross_attn.attention
    attn = _window_attend(mha, q, cross_k, cross_v, pad_count)
    return _boundary_finish(mdl, attn, emb_lat, frq_lat), cross_k, cross_v, length + 1


def _window_attend(mha, q: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                   pad_count: torch.Tensor) -> torch.Tensor:
    """Attend the latent queries over a token-indexed cross cache gathered
    back into window-slot order (slot ``i`` reads token ``max(i - pad, 0)``;
    the pad mask drops the pad slots), so masks match :func:`_decode_forward`."""
    b, h, n, d = cross_k.shape
    slot_abs = (torch.arange(n, device=q.device)[None, :] - pad_count[:, None]).clamp(min=0)
    idx = slot_abs[:, None, :, None]
    k_slots = torch.gather(cross_k, 2, idx.expand(b, h, n, d))
    v_slots = torch.gather(cross_v, 2, idx.expand(b, cross_v.shape[1], n, cross_v.shape[3]))
    pad_mask = torch.arange(n, device=q.device)[None, :] < pad_count[:, None]
    return mha.attend(q, k_slots, v_slots, pad_mask=pad_mask)


def _decode_step_boundary_paged(mdl, window: torch.Tensor, pad_count: torch.Tensor,
                                pool_k: torch.Tensor, pool_v: torch.Tensor,
                                block_table: torch.Tensor, length: torch.Tensor, block_size: int,
                                write_ok: Optional[torch.Tensor] = None,
                                scale_k: Optional[torch.Tensor] = None,
                                scale_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_decode_step_boundary` over the block-paged pool: the two
    writes become table-translated pool scatters (**in place**, quantizing
    when ``scale_k``/``scale_v`` are given), and the window attend goes
    through :func:`~perceiver_io_tpu_torch.ops.paged_attention.paged_window_attention`
    (K4 on the card, the gather reference on the CPU). ``write_ok`` routes
    the writes of rows this step does not own to the null block.

    :return: next-token logits ``(b, vocab)``.
    """
    n = window.shape[1]
    write_idx, k_upd, v_upd, q, emb_lat, frq_lat = _boundary_update(mdl, window, pad_count, length)
    flat = paged.flat_write_indices(block_table, write_idx, block_size)
    if write_ok is not None:
        flat = torch.where(write_ok[:, None], flat, flat % block_size)  # null block
    paged.scatter_kv(pool_k, scale_k, flat, k_upd)
    paged.scatter_kv(pool_v, scale_v, flat, v_upd)
    mha = mdl.perceiver_ar.cross_attention.cross_attn.attention
    attn = paged.paged_window_attention(
        mha.attend, q, pool_k, pool_v, block_table, block_size=block_size, n=n,
        pad_count=pad_count, scale_k=scale_k, scale_v=scale_v, project_out=mha.project_out,
    )
    return _boundary_finish(mdl, attn, emb_lat, frq_lat)


def _slot_stack_step(mdl, x: torch.Tensor, rot: RotaryEmbedding, stack: dict, m: torch.Tensor,
                     write_ok: Optional[torch.Tensor]) -> torch.Tensor:
    """The latent stack of a per-row decode step: each row appends its new
    latent's k/v at its own index ``min(m, I - 1)`` (**in place**; rows
    without ``write_ok`` keep their entries) and attends over its first
    ``m + 1`` entries. :return: next-token logits."""
    b = x.shape[0]
    num_latents = mdl.max_latents
    dev = x.device
    rows = torch.arange(b, device=dev)
    wm = m.clamp(max=num_latents - 1)
    stack_future = torch.arange(num_latents, device=dev)[None, :] > m[:, None]
    for i, sa_layer in enumerate(mdl.perceiver_ar.self_attention.layers):
        sa = sa_layer.self_attn
        normed = layer_norm(sa.norm, x, sa.dtype)
        q_s = sa.attention.project_q(normed, rot if i == 0 else None)
        k_s, v_s = sa.attention.project_kv(normed, rot if i == 0 else None)
        _put_rows(stack["stack_k"][i], rows, wm, k_s[:, :, 0], write_ok)
        _put_rows(stack["stack_v"][i], rows, wm, v_s[:, :, 0], write_ok)
        x = sa.attention.attend(q_s, stack["stack_k"][i], stack["stack_v"][i],
                                pad_mask=stack_future) + x
        x = sa_layer.mlp(x) + x
    return mdl.head(x[:, 0])


def _slot_token(mdl, token: torch.Tensor, length: torch.Tensor):
    """Embedding and cross projections of each row's new token at its write
    index ``min(length, N - 1)`` (no-op clamp for active rows; idle slots'
    counters saturate)."""
    ca = mdl.perceiver_ar.cross_attention.cross_attn
    wl = length.clamp(max=mdl.max_seq_len - 1)
    emb, frq = mdl.perceiver_ar.input_adapter(token[:, None], abs_pos=wl[:, None])
    rot = RotaryEmbedding(frq)
    x_q = layer_norm(ca.q_norm, emb, ca.dtype)  # a fresh latent: q_norm on both sides
    q = ca.attention.project_q(x_q, rot)
    k_new, v_new = ca.attention.project_kv(x_q, rot)
    return wl, emb, rot, q, k_new, v_new


def _slot_decode_step(mdl, token: torch.Tensor, cache: dict, length: torch.Tensor,
                      m: torch.Tensor, write_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cached latent-growth step: only the new token runs through the
    model, attending over the caches. ``length`` and ``m`` are per-row
    ``(b,)`` vectors (the slot engine's rows are admitted at different times;
    ``generate()`` passes one ``m`` for every row), write indices are clamped
    (``min(length, N-1)``, ``min(m, I-1)``) and the stack append is a per-row
    scatter. Cache writes are **in place**; ``write_ok`` keeps the entries of
    rows this step does not own.

    :param cache: ``cross_k/v`` ``(b, h, N, d)`` and ``stack_k/v`` lists.
    :return: next-token logits ``(b, vocab)``.
    """
    n = cache["cross_k"].shape[2]
    layer = mdl.perceiver_ar.cross_attention
    mha = layer.cross_attn.attention
    wl, emb, rot, q, k_new, v_new = _slot_token(mdl, token, length)
    rows = torch.arange(token.shape[0], device=token.device)
    _put_rows(cache["cross_k"], rows, wl, k_new[:, :, 0], write_ok)
    _put_rows(cache["cross_v"], rows, wl, v_new[:, :, 0], write_ok)
    future = torch.arange(n, device=token.device)[None, :] > length[:, None]  # not yet written
    x = mha.attend(q, cache["cross_k"], cache["cross_v"], pad_mask=future) + emb
    x = layer.mlp(x) + x
    return _slot_stack_step(mdl, x, rot, cache, m, write_ok)


def _decode_step(mdl, token: torch.Tensor, cache: dict, length: torch.Tensor, m: int):
    """:func:`_slot_decode_step` with every row at latent count ``m``, the
    step of :func:`generate`'s latent-growth phase.

    :return: ``(logits, cache, length + 1, m + 1)``.
    """
    logits = _slot_decode_step(mdl, token, cache, length, torch.full_like(length, m))
    return logits, cache, length + 1, m + 1


def _slot_decode_step_paged(mdl, token: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                            block_table: torch.Tensor, stack_cache: dict, length: torch.Tensor,
                            m: torch.Tensor, block_size: int,
                            write_ok: Optional[torch.Tensor] = None,
                            scale_k: Optional[torch.Tensor] = None,
                            scale_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_slot_decode_step` over the block-paged pool: the append is a
    table-translated pool scatter (**in place**, quantized under int8
    scales; ``write_ok`` routes the other rows' appends to the null block)
    and the cross attend goes through
    :func:`~perceiver_io_tpu_torch.ops.paged_attention.paged_decode_attention`
    (K4 on the card, the gather reference on the CPU). The latent stack
    stays dense.

    :return: next-token logits ``(b, vocab)``.
    """
    n = mdl.max_seq_len
    layer = mdl.perceiver_ar.cross_attention
    mha = layer.cross_attn.attention
    wl, emb, rot, q, k_new, v_new = _slot_token(mdl, token, length)
    flat = paged.flat_write_indices(block_table, wl, block_size)
    if write_ok is not None:
        flat = torch.where(write_ok, flat, flat % block_size)  # null block
    paged.scatter_kv(pool_k, scale_k, flat, k_new[:, :, 0])
    paged.scatter_kv(pool_v, scale_v, flat, v_new[:, :, 0])
    future = torch.arange(n, device=token.device)[None, :] > length[:, None]
    attn = paged.paged_decode_attention(
        mha.attend, q, pool_k, pool_v, block_table, block_size=block_size, n=n,
        pad_mask=future, lengths=(length + 1).clamp(max=n), scale_k=scale_k, scale_v=scale_v,
        project_out=mha.project_out,
    )
    x = attn + emb
    x = layer.mlp(x) + x
    return _slot_stack_step(mdl, x, rot, stack_cache, m, write_ok)


def _on_device(model, dev: torch.device) -> bool:
    have = model.device
    return have.type == dev.type and (dev.index is None or have.index == dev.index)


def generate(model, input_ids, config: GenerationConfig, *,
             generator: Optional[torch.Generator] = None,
             prompt_pad_count=None, use_cache: bool = True,
             decode_strategy=None, device: DeviceLike = "cuda") -> torch.Tensor:
    """Generate ``config.max_new_tokens`` tokens after ``input_ids``.

    :param model: an ``AutoregressiveSequenceModel`` on ``device``.
    :param input_ids: ``(b, prompt_len)`` prompt, left-padded if ragged.
    :param generator: the sampled steps' draws (``do_sample=True``); None
        is a generator on ``device`` seeded 0, as JAX defaults to
        ``PRNGKey(0)``. Each step draws one ``(b, V)`` noise tensor.
    :param prompt_pad_count: ``(b,)`` left-pad counts for ragged prompts.
    :param decode_strategy: ``"auto" | "cached" | "recompute"``, a
        :class:`~.decode_strategy.DecodeStrategy`, or None (the
        ``PERCEIVER_DECODE_STRATEGY`` env var, else ``"auto"``). Beam search
        ignores it (it recomputes the window every step, as in JAX).
    :return: ``(b, max_new_tokens)`` ids on ``device`` (pad after EOS).
    """
    dev = resolve_device(device)
    if not _on_device(model, dev):
        raise ValueError(f"model lies on {model.device}, generate was asked for {dev}")
    if config.num_beams > 1:
        from perceiver_io_tpu_torch.inference.beam import beam_search

        return beam_search(model, input_ids, config, num_beams=config.num_beams,
                           length_penalty=config.length_penalty,
                           prompt_pad_count=prompt_pad_count, device=dev)
    if config.sampling.do_sample and generator is None:
        generator = default_generator(dev)
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, prompt_len = input_ids.shape
    n = model.max_seq_len
    max_latents = model.max_latents
    if not 0 < prompt_len <= n:
        raise ValueError(f"prompt length out of valid range [1..{n}]")
    if not 0 < config.num_latents <= max_latents:
        raise ValueError(f"num_latents={config.num_latents} out of valid range [1..{max_latents}]")
    num_latents = min(prompt_len, config.num_latents)
    prefix_len = prompt_len - num_latents
    if prefix_len > model.max_prefix_len:
        raise ValueError(
            f"for sequence length {prompt_len}, num_latents must be >= "
            f"{num_latents + prefix_len - model.max_prefix_len}"
        )
    if prompt_pad_count is None:
        pad_host = np.zeros((b,), np.int64)
    else:
        pad_host = np.asarray(torch.as_tensor(prompt_pad_count).cpu(), np.int64)

    # Phase plan (module docstring), fixed on the host before the loop.
    strat = decode_strategy_mod.resolve(decode_strategy, model)
    latent_cached = use_cache and strat.latent == "cached"
    s1 = min(config.max_new_tokens, max_latents - num_latents, n - prompt_len) if latent_cached else 0
    phase2_ok = use_cache and strat.boundary_cached and bool((pad_host <= prefix_len).all())
    s2 = min(config.max_new_tokens, n - prompt_len) if phase2_ok else s1
    s2 = max(s1, s2)

    with torch.no_grad():
        return _run(model, config, input_ids, torch.as_tensor(pad_host, device=dev),
                    num_latents, s1, s2, generator)


def _run(model, config: GenerationConfig, input_ids, prompt_pad_count, num_latents, s1, s2,
         generator: Optional[torch.Generator]):
    b, prompt_len = input_ids.shape
    n = model.max_seq_len
    max_latents = model.max_latents
    dev = input_ids.device
    eos = config.eos_token_id
    min_new = min(config.min_new_tokens, config.max_new_tokens) if eos is not None else 0

    def choose(logits, t, window, pad_count):
        # one sample_logits call a step: a sampled step draws one (b, V) noise
        logits = apply_min_new_tokens(logits, t, min_new, eos or 0)
        if config.sampling.repetition_penalty == 1.0:
            return sample_logits(logits, config.sampling, generator=generator)
        pads = torch.arange(n, device=dev)[None, :] < pad_count[:, None]
        return sample_logits(logits, config.sampling, window, pads, generator=generator)

    def advance(window, pad_count, finished, token):
        if eos is not None:
            token = torch.where(finished, torch.full_like(token, config.pad_token_id), token)
            finished = finished | (token == eos)
        window = torch.cat([window[:, 1:], token[:, None].to(window.dtype)], dim=1)
        return window, (pad_count - 1).clamp(min=0), finished, token

    # right-align the prompt into the full-size window
    window = torch.full((b, n), config.pad_token_id, dtype=input_ids.dtype, device=dev)
    window[:, n - prompt_len:] = input_ids
    pad_count = prompt_pad_count + (n - prompt_len)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    m = num_latents
    tokens = []
    if s2 > 0:
        logits, cache, length, _ = _decode_prefill(model, window, pad_count, m)

    for t in range(s1):
        token = choose(logits, t, window, pad_count)
        window, pad_count, finished, token = advance(window, pad_count, finished, token)
        logits, cache, length, m = _decode_step(model, token, cache, length, m)
        tokens.append(token)

    if s2 > s1:
        cross_k, cross_v = cache["cross_k"], cache["cross_v"]
        for t in range(s1, s2):
            token = choose(logits, t, window, pad_count)
            window, pad_count, finished, token = advance(window, pad_count, finished, token)
            logits, cross_k, cross_v, length = _decode_step_boundary(
                model, window, pad_count, cross_k, cross_v, length
            )
            tokens.append(token)
        m = max_latents

    for t in range(s2, config.max_new_tokens):
        logits = _decode_forward(model, window, pad_count, m)
        token = choose(logits, t, window, pad_count)
        window, pad_count, finished, token = advance(window, pad_count, finished, token)
        m = min(m + 1, max_latents)
        tokens.append(token)

    return torch.stack(tokens, dim=1).to(input_ids.dtype)
