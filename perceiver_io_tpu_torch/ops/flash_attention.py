"""Flash attention with Perceiver masking, forward and backward: the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd Function
that joins them.

Counterpart of the Pallas TPU kernels ``_forward`` (K1), ``_backward_dq``
(K2) and ``_backward_dkv`` (K3) and of the ``custom_vjp`` around them in
``perceiver_io_tpu/ops/flash_attention.py``. The forward (K1) has four
Hopper ``sm_90a`` designs behind one wrapper, picked by :func:`_fwd_route`
from the query length, the head dims and the type alone, and two more
reached only by name:

- ``split`` (``csrc/flash_attention_fwd_split.cu``), at most 16 query rows
  (decode attends), fp32 or bf16: the keys cut into 64-key splits, one block
  per (split, head, batch) writing fp32 partials, and a merge launch;
- ``wgmma`` (``csrc/flash_attention_fwd_wgmma.cu``), bf16 with more rows:
  tensor-core tiles fed by TMA, a 64-row consumer warpgroup and a producer
  warp per block;
- ``tf32x3`` (``csrc/flash_attention_fwd_tf32.cu``), fp32 with more rows:
  both products as three TF32 products each on ``mma.sync`` (operands split
  into TF32 hi and lo parts, fp32-accurate; TF32 arithmetic itself stays
  off), eight warps per 64-row tile, two online-softmax states per row
  merged at the end, tiles staged with ``cp.async``, ``p`` kept in
  registers;
- ``wide_mma`` (``csrc/flash_attention_fwd_wide_mma.cu`` +
  ``csrc/wide_mma.cuh``), fp32 or bf16, for every ``(d, dv)`` pair that the
  three above do not instantiate (the image classifier's 261 and 1024, 131
  on MNIST): d and dv at run time, both products on ``mma.sync`` (bf16
  m16n8k16; fp32 as ``tf32x3``'s three TF32 products), tiles staged at any
  alignment; where both widths fit :data:`WIDE_MMA_GROUP` columns a warp
  holds its whole output row and ``p`` stays in registers (128-row query
  tiles in bf16, 64 in fp32, 16 where ``i <= 16``), else 16-row tiles
  whose 8 warps split the output's columns, the scores computed once for
  all of them; the keys cut into splits whose fp32 partials a merge launch
  joins (:func:`_wide_mma_fwd_plan`);
- ``wide`` (``csrc/flash_attention_fwd_wide.cu``), fp32 or bf16, any pair:
  64 x 64 tiles on the CUDA cores in fp32, the output in column groups of at
  most :data:`WIDE_GROUP`, the keys cut into splits (:func:`_wide_splits`);
  the first design at those pairs;
- ``simt`` (``csrc/flash_attention_fwd.cu``), fp32 or bf16: 64 x 64 tiles
  on the CUDA cores, the first design.

``wide`` and ``simt`` are reached only by name through :func:`_fwd_launch`
(to time them against the others).

Every route computes attention over pre-scaled queries with

- the right-aligned causal mask ``col <= row + (j - i)`` (Perceiver AR
  latents attend over ``[prefix || latents]``), skipping kv tiles wholly
  above the shifted diagonal;
- an optional ``(b, j)`` key pad mask (True = pad);
- fp32 accumulation, output in the input type, and the fp32 logsumexp
  ``(b, h, i)``;
- **zero output for a query row that sees no key** (the TPU kernel's dead-row
  semantics; the einsum path instead softmaxes such a row uniformly);
- ``v`` of a head dim of its own, ``dv`` (the Perceiver IO families set q/k
  and v channels apart): the split, wgmma and tf32x3 routes instantiate the
  ``(d, dv)`` pairs of :data:`HEAD_DIMS` (``csrc/head_dims.cuh``), the
  ``wide_mma`` and ``wide`` routes take every other pair, the ``simt``
  kernels :data:`SIMT_HEAD_DIMS` (``dv == d`` only).

The backward kernels recompute ``p = exp(s - lse)`` under the same masks
(by select), take ``ds = p * (do . v^T - delta)`` with
``delta = rowsum(o * do)`` in fp32, and give ``dq = ds . k`` (K2),
``dv = p^T . do`` and ``dk = ds^T . q`` (K3), with ``p`` and ``ds`` cast to
the input type before each product as on the TPU. A dead row gets
``dq = 0`` and a key that no row sees ``dk = dv = 0``. K2 and K3 each have
five Hopper ``sm_90a`` designs; :func:`_bwd_route` picks one of the first
three from the head dims and the type alone:

- ``wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``), bf16: the five
  products on the tensor cores over TMA-fed tiles, ``p`` and ``ds`` packed
  to bf16 in registers as the A operand of the second products, a 64-row
  consumer warpgroup and a producer warp per block;
- ``tf32x3`` (``csrc/flash_attention_bwd_tf32.cu``), fp32: each fp32
  product as three TF32 products on ``mma.sync`` (operands split into
  TF32 hi and lo parts in registers, fp32-accurate; TF32 arithmetic itself
  stays off), eight warps per 64-row tile, tiles staged with ``cp.async``,
  ``p`` and ``ds`` kept in registers;
- ``wide_mma`` (``csrc/flash_attention_bwd_wide_mma.cu`` +
  ``csrc/mma_bf16.cuh``), fp32 or bf16, for the pairs outside
  :data:`HEAD_DIMS`: d and dv at run time, the products on ``mma.sync``
  (bf16 m16n8k16; fp32 as ``tf32x3``'s three TF32 products), tiles staged
  at any alignment, 16-row query tiles where ``i <= 16``; K2 over key
  splits whose fp32 partial ``dq`` a second launch sums, K3 one block per
  (64-key tile, column group) computing the scores once for ``dv`` and
  ``dk``; :func:`_wide_mma_plan` sizes both;
- ``wide`` (``csrc/flash_attention_bwd_wide.cu``), fp32 or bf16, any pair:
  the CUDA-core tiles of K1's ``wide``, the first design at those pairs;
- ``simt`` (``csrc/flash_attention_bwd.cu``), fp32 or bf16: 64 x 64 tiles
  on the CUDA cores, the first design.

``wide`` and ``simt`` are reached only by name through :func:`_bwd_launch`
(to time them against the others).

:func:`flash_attention` goes through :class:`FlashAttentionFunction`, so it
is differentiable. Every wrapper launches its kernel for CUDA tensors and
raises on what the kernel does not take; for CPU tensors it runs the plain
version (:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`), which repeats the kernel's
arithmetic. There is no fallback from a CUDA tensor to a plain version.
A route whose kernel refuses an input (a type or row count it does not
take, a head dim it does not instantiate, a base not 16-byte aligned for the
split, wgmma and tf32x3 routes, a failed launch) raises; a CUDA tensor never
drops to another route.
Launches are counted on ``flash_attention.launches`` (K1's calls, with
``flash_attention.route_launches`` per route, and
``flash_attention.kernel_launches`` the device kernels they launch: two per
split-, wide_mma- or wide-route call, partials and merge, one per other
call),
``flash_attention_bwd_dq.launches`` (K2) and
``flash_attention_bwd_dkv.launches`` (K3), each with ``route_launches`` per
backward route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

#: The TPU kernel's large-but-finite mask value (``flash_attention.py:47``).
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K1's designs (:func:`_fwd_route` picks one of the first four)
ROUTES = ("split", "wgmma", "tf32x3", "wide_mma", "wide", "simt")
#: the most query rows the split route takes
SPLIT_MAX_ROWS = 16
#: device kernels one call of each route launches
ROUTE_KERNELS = {"split": 2, "wgmma": 1, "tf32x3": 1, "wide_mma": 2, "wide": 2, "simt": 1}
#: K2's and K3's designs (:func:`_bwd_route` picks one of the first three)
BWD_ROUTES = ("wgmma", "tf32x3", "wide_mma", "wide", "simt")
#: the (q/k head dim, v head dim) pairs the ``split``, ``wgmma`` and
#: ``tf32x3`` kernels of K1-K3 instantiate (``csrc/head_dims.cuh``, which
#: their dispatch expands): ``(d, d)`` for the Perceiver AR families, d = 32
#: with v's own width for the masked LM at language-perceiver width, and
#: (160, 160) for the text families at the JAX CLI's defaults; every other
#: pair takes the ``wide_mma`` routes
HEAD_DIMS = ((32, 32), (32, 96), (32, 160), (64, 64), (96, 96), (112, 112), (128, 128), (160, 160))
#: the pairs of the ``simt`` kernels, reached by name only
SIMT_HEAD_DIMS = ((64, 64), (112, 112), (128, 128))
#: the most output columns a ``wide`` block accumulates (``csrc/wide.cuh``
#: GROUP): a wider output is cut into column groups
WIDE_GROUP = 288
#: the blocks a ``wide`` launch aims at per batch row: two on each of the
#: H100's 132 SMs
WIDE_FILL = 264
#: the ``wide_mma`` route's tiles (``csrc/flash_attention_bwd_wide_mma.cu``):
#: the most output columns a warp accumulates (GROUP; a wider output is cut
#: into column groups), the head-dim columns of a staged score step when
#: whole rows are not staged (CHUNK), the keys of a K3 tile and of a K2 tile
#: (KEYS; KEYS_SMALL for K2 in bf16 at 16-row query tiles), the query rows
#: of a tile where ``i > 16`` by type (ROWS_BF16, ROWS_FP32) and where
#: ``i <= 16`` (ROWS_SMALL), and the K2 blocks its key splits aim at per
#: batch row: two waves of the H100's 132 SMs at one block an SM
WIDE_MMA_GROUP = 272
WIDE_MMA_CHUNK = 64
WIDE_MMA_KEYS = 64
WIDE_MMA_KEYS_SMALL = 128
WIDE_MMA_ROWS = {torch.bfloat16: 64, torch.float32: 32}
WIDE_MMA_ROWS_SMALL = 16
WIDE_MMA_FILL = 264
#: K1's ``wide_mma`` tiles (``csrc/flash_attention_fwd_wide_mma.cu``), beside
#: the constants above (GROUP, CHUNK, KEYS, KEYS_SMALL and ROWS_SMALL, which
#: it shares): the query rows of a tile where a warp holds its whole
#: output row and ``i > 16``, by type (ROWS_BF16: 16 a warp; ROWS_FP32: two
#: warps on each 16 rows), and the warps of a block, which split a wider
#: output's columns (so a block holds WARPS x GROUP columns); and the blocks
#: of a wave (the H100's 132 SMs at one block an SM), of which its key
#: splits give each batch row whole waves
WIDE_MMA_FWD_ROWS = {torch.bfloat16: 128, torch.float32: 64}
WIDE_MMA_WARPS = 8
WIDE_MMA_FWD_WAVE = 132
_FWD = {}
_BWD = {}


def _allowed(q: torch.Tensor, j: int, pad_mask: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """The kernels' mask: ``(b or 1, 1, i, j)`` bool, True = the query sees the key."""
    i = q.shape[2]
    allowed = torch.ones(i, j, dtype=torch.bool, device=q.device)[None, None]
    if pad_mask is not None:
        allowed = allowed & ~pad_mask.bool()[:, None, None, :]
    if causal:
        cols = torch.arange(j, device=q.device)[None, :]
        rows = torch.arange(i, device=q.device)[:, None]
        allowed = allowed & (cols <= rows + (j - i))[None, None]
    return allowed


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: same masks, same mask
    constant, same dead-row zeros, ``p`` cast to ``v``'s type before the
    ``p @ v`` product.

    :return: ``(o, lse)`` — ``o`` ``(b, h, i, dv)`` (``v``'s head dim) in
        ``q``'s type, ``lse`` ``(b, h, i)`` fp32.
    """
    s = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    allowed = _allowed(q, k.shape[2], pad_mask, causal)
    s = torch.where(allowed, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhij,bhjc->bhic", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.where(l > 0, acc / safe_l, torch.zeros_like(acc))
    lse = (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_split_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False, split: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split route's arithmetic written out in PyTorch (for the tests):
    per split of ``split`` keys the partials ``m_s`` (``MASK_VALUE`` where the
    row sees none of its keys), ``l_s = sum p`` and ``acc_s = p . v`` with
    ``p = exp(s - m_s)`` cast to ``v``'s type for the product, then the
    merge ``m = max m_s``, ``l = sum l_s e^(m_s - m)``,
    ``o = sum acc_s e^(m_s - m) / l`` over the splits with ``l_s > 0``. A row
    that sees no key gets ``o = 0`` and ``lse = MASK_VALUE``.

    :return: ``(o, lse)`` as :func:`flash_attention_reference`.
    """
    s = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    allowed = _allowed(q, k.shape[2], pad_mask, causal).expand_as(s)
    ms, ls, accs = [], [], []
    for c0 in range(0, k.shape[2], split):
        s_c = torch.where(allowed[..., c0:c0 + split], s[..., c0:c0 + split], float("-inf"))
        m_c = s_c.amax(dim=-1, keepdim=True)
        seen = m_c > float("-inf")
        p = torch.exp(s_c - torch.where(seen, m_c, 0.0))  # masked keys: exp(-inf) = 0
        ms.append(torch.where(seen, m_c, MASK_VALUE))
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhij,bhjc->bhic", p.to(v.dtype).float(), v[:, :, c0:c0 + split].float()))
    m_s, l_s, acc_s = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = l_s > 0
    m = torch.where(live, m_s, float("-inf")).amax(dim=0)
    w = torch.where(live, torch.exp(m_s - m), 0.0)
    l, acc = (l_s * w).sum(dim=0), (acc_s * w).sum(dim=0)
    seen = l > 0
    safe_l = torch.where(seen, l, 1.0)
    o = torch.where(seen, acc / safe_l, 0.0)
    lse = torch.where(seen, m + torch.log(safe_l), MASK_VALUE)[..., 0]
    return o.to(q.dtype), lse


def _probabilities(q, k, v, lse, delta, do, pad_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' ``p`` and ``ds``, fp32 ``(b, h, i, j)``. The
    mask is a select: ``exp(s - lse)`` overflows on a dead row, whose lse is
    the mask value, and the select keeps it out."""
    s = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    allowed = _allowed(q, k.shape[2], pad_mask, causal)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bhic,bhjc->bhij", do.float(), v.float())
    ds = torch.where(allowed, p * (dp - delta[..., None]), torch.zeros_like(s))
    return p, ds


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(o * do)`` in fp32, ``(b, h, i)``: the backward's row
    term, computed outside the kernels as the JAX package does."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_attention_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    do: torch.Tensor, *, pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Plain version of K2: ``dq = ds . k`` with ``ds`` cast to ``k``'s type
    and an fp32 sum; ``dq`` in ``q``'s type."""
    _, ds = _probabilities(q, k, v, lse, delta, do, pad_mask, causal)
    dq = torch.einsum("bhij,bhjc->bhic", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    do: torch.Tensor, *, pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``dk = ds^T . q`` and ``dv = p^T . do`` with ``p``
    and ``ds`` cast to ``q``'s type and fp32 sums; in ``k``'s and ``v``'s types."""
    p, ds = _probabilities(q, k, v, lse, delta, do, pad_mask, causal)
    dk = torch.einsum("bhij,bhic->bhjc", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhij,bhic->bhjc", p.to(q.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (not autograd): the same
    arithmetic written out, with the same casts and selects.

    :param o: the forward's output; ``lse`` its fp32 ``(b, h, i)`` logsumexp.
    :param do: the output's cotangent ``(b, h, i, dv)``.
    :return: ``(dq, dk, dv)`` in ``q``'s, ``k``'s and ``v``'s types.
    """
    delta = attention_delta(o, do)
    kw = dict(pad_mask=pad_mask, causal=causal)
    dq = flash_attention_bwd_dq_reference(q, k, v, lse, delta, do, **kw)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, lse, delta, do, **kw))


def _fwd_route(i: int, dtype: torch.dtype, d: int, dv: int) -> str:
    """K1's design for a query of ``i`` rows in ``dtype`` at head dims
    ``(d, dv)``: ``wide_mma`` for a pair outside :data:`HEAD_DIMS`, else
    ``split`` for decode attends (``i <= 16``), ``wgmma`` for bf16 and
    ``tf32x3`` for fp32. The choice depends on nothing else (not the batch),
    so a row's result does not either."""
    if (d, dv) not in HEAD_DIMS:
        return "wide_mma"
    if i <= SPLIT_MAX_ROWS:
        return "split"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _wide_splits(i: int, j: int, h: int, width: int) -> Tuple[int, int]:
    """``(n_splits, tiles_per_split)`` of a ``wide`` launch whose output is
    ``width`` wide (``dv`` for K1, ``d`` for K2): the ``ceil(j / 64)`` key
    tiles cut so that the row tiles x column groups x heads x splits of one
    batch row reach :data:`WIDE_FILL` blocks, no split empty. The batch
    does not enter, so a row's result does not depend on it."""
    key_tiles = -(-j // 64)
    blocks = -(-i // 64) * -(-width // WIDE_GROUP) * h
    n = max(1, min(key_tiles, -(-WIDE_FILL // blocks)))
    per = -(-key_tiles // n)
    return -(-key_tiles // per), per


class WideMmaPlan(NamedTuple):
    """The ``wide_mma`` launches' shapes for one call (:func:`_wide_mma_plan`)."""

    rows: int                #: query rows of a tile
    dq_keys: int             #: keys of a K2 tile
    dq_groups: int           #: column groups of dq (one K2 block each per row tile and split)
    dq_splits: int           #: K2's key splits, summed in order by its second launch
    dq_tiles_per_split: int  #: key tiles a split takes (the last may take fewer, none empty)
    dkv_groups: int          #: K3's column groups, each over its columns of dv and of dk
    fused: bool              #: whole rows of q, k, v and do staged (else CHUNK-column steps)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


class WideMmaFwdPlan(NamedTuple):
    """K1's ``wide_mma`` launch shapes for one call (:func:`_wide_mma_fwd_plan`)."""

    rows: int             #: query rows of a tile
    keys: int             #: keys of a tile
    col_blocks: int       #: blocks over the output's columns (1 where a warp holds a whole row)
    splits: int           #: key splits, merged in split order by the second launch
    tiles_per_split: int  #: key tiles a split takes (the last may take fewer, none empty)
    fused: bool           #: whole rows staged and a warp holding its whole output row (else the column split)


def _wide_mma_columns(width: int, groups: int) -> Tuple[Tuple[int, int], ...]:
    """The ``[start, stop)`` columns of each group of an output ``width``
    wide cut into ``groups`` (the kernels' ``group_width``): groups of
    ``round16(ceil(width / groups))`` columns, the last shorter (or empty)."""
    w = _round16(-(-width // groups))
    return tuple((min(g * w, width), min((g + 1) * w, width)) for g in range(groups))


def _wide_mma_plan(i: int, j: int, h: int, d: int, dv: int, dtype: torch.dtype) -> WideMmaPlan:
    """The ``wide_mma`` route's shapes for ``i`` queries over ``j`` keys
    with ``h`` heads at head dims ``(d, dv)`` in ``dtype``, used by both
    launches and checked by the kernels: 16-row query tiles where
    ``i <= 16`` (mma's m16), else :data:`WIDE_MMA_ROWS`; column groups of
    at most :data:`WIDE_MMA_GROUP` (dq over d; dk and dv over the wider of
    d and dv, a group serving its columns of both); K2's key tiles cut into
    splits so that the row tiles x groups x heads x splits of one batch row
    reach :data:`WIDE_MMA_FILL` blocks, no split empty. The batch does not
    enter, so a row's result does not depend on it."""
    rows = WIDE_MMA_ROWS_SMALL if i <= WIDE_MMA_ROWS_SMALL else WIDE_MMA_ROWS[dtype]
    keys = WIDE_MMA_KEYS_SMALL if dtype == torch.bfloat16 and rows == WIDE_MMA_ROWS_SMALL else WIDE_MMA_KEYS
    dq_groups = -(-d // WIDE_MMA_GROUP)
    key_tiles = -(-j // keys)
    blocks = -(-i // rows) * dq_groups * h
    n = max(1, min(key_tiles, -(-WIDE_MMA_FILL // blocks)))
    per = -(-key_tiles // n)
    return WideMmaPlan(rows=rows, dq_keys=keys, dq_groups=dq_groups, dq_splits=-(-key_tiles // per),
                       dq_tiles_per_split=per, dkv_groups=max(dq_groups, -(-dv // WIDE_MMA_GROUP)),
                       fused=_round16(d) <= WIDE_MMA_GROUP and _round16(dv) <= WIDE_MMA_GROUP)


def _wide_mma_fwd_plan(i: int, j: int, h: int, d: int, dv: int, dtype: torch.dtype) -> WideMmaFwdPlan:
    """K1's ``wide_mma`` shapes for ``i`` queries over ``j`` keys with ``h``
    heads at head dims ``(d, dv)`` in ``dtype``. The launch passes the
    splits, which the kernel checks; the kernel derives the rest (rows,
    keys, column blocks) from its own constants, which these mirror. Where both widths fit :data:`WIDE_MMA_GROUP`
    columns ("fused"), a warp holds its whole output row: query tiles of
    :data:`WIDE_MMA_FWD_ROWS` rows by type, 16 where ``i <= 16`` (mma's m16), and
    key tiles of :data:`WIDE_MMA_KEYS` (:data:`WIDE_MMA_KEYS_SMALL` in bf16 at
    16 rows: 16 keys a warp). Else 16-row tiles over 64-key tiles whose
    :data:`WIDE_MMA_WARPS` warps split the output's columns, in as many
    column blocks as their accumulators force (``WARPS x GROUP`` columns a
    block). The key tiles are cut into splits so that the row tiles x
    column blocks x heads x splits of one batch row fill whole waves of
    :data:`WIDE_MMA_FWD_WAVE` blocks (one wave, or the fewest whole waves
    short of two), no split empty (:func:`_wide_mma_fwd_target`). The batch
    does not enter, so a row's result does not depend on it."""
    fused = _round16(d) <= WIDE_MMA_GROUP and _round16(dv) <= WIDE_MMA_GROUP
    rows = WIDE_MMA_FWD_ROWS[dtype] if fused and i > WIDE_MMA_ROWS_SMALL else WIDE_MMA_ROWS_SMALL
    small_bf16 = fused and rows == WIDE_MMA_ROWS_SMALL and dtype == torch.bfloat16
    keys = WIDE_MMA_KEYS_SMALL if small_bf16 else WIDE_MMA_KEYS
    col_blocks = 1 if fused else -(-dv // (WIDE_MMA_WARPS * WIDE_MMA_GROUP))
    key_tiles = -(-j // keys)
    n = _wide_mma_fwd_target(-(-i // rows) * col_blocks * h, key_tiles)
    per = -(-key_tiles // n)
    return WideMmaFwdPlan(rows=rows, keys=keys, col_blocks=col_blocks, splits=-(-key_tiles // per),
                          tiles_per_split=per, fused=fused)


def _wide_mma_fwd_target(blocks: int, key_tiles: int) -> int:
    """The key splits K1's ``wide_mma`` plan aims at for a batch row of
    ``blocks`` blocks before the splits: enough for a wave of
    :data:`WIDE_MMA_FWD_WAVE` blocks, then more until the row's blocks are a
    whole number of waves or reach two waves; at most ``key_tiles``."""
    n = -(-WIDE_MMA_FWD_WAVE // blocks)
    while blocks * n % WIDE_MMA_FWD_WAVE and blocks * n < 2 * WIDE_MMA_FWD_WAVE:
        n += 1
    return max(1, min(key_tiles, n))


def flash_attention_wide_mma_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``wide_mma`` route's split-and-merge written out in PyTorch (for
    the tests): :func:`flash_attention_split_reference` over the key ranges
    of :func:`_wide_mma_fwd_plan`'s splits (``keys x tiles_per_split`` keys
    each, the last shorter).

    :return: ``(o, lse)`` as :func:`flash_attention_reference`.
    """
    plan = _wide_mma_fwd_plan(q.shape[2], k.shape[2], q.shape[1], q.shape[3], v.shape[3], q.dtype)
    return flash_attention_split_reference(q, k, v, pad_mask=pad_mask, causal=causal,
                                           split=plan.keys * plan.tiles_per_split)


#: per route: (library source, C entry, pointer args, int args)
_FWD_ENTRIES = {
    "simt": ("flash_attention_fwd", "flash_attention_fwd", 6, 7),
    "wgmma": ("flash_attention_fwd_wgmma", "flash_attention_fwd_wgmma", 6, 7),
    "tf32x3": ("flash_attention_fwd_tf32", "flash_attention_fwd_tf32x3", 6, 7),
    "split": ("flash_attention_fwd_split", "flash_attention_fwd_split", 8, 9),
    "wide_mma": ("flash_attention_fwd_wide_mma", "flash_attention_fwd_wide_mma", 8, 10),
    "wide": ("flash_attention_fwd_wide", "flash_attention_fwd_wide", 8, 10),
}


#: K1's routes that take q, k and v at any alignment
_ANY_ALIGNMENT = ("simt", "wide_mma", "wide")


def _head_dims_of(route: str):
    return SIMT_HEAD_DIMS if route == "simt" else HEAD_DIMS


def _check_head_dims(route: str, d: int, dv: int) -> None:
    """Raise before a route's library loads when it does not instantiate
    ``(d, dv)``: the ``simt`` kernels take v of q's head dim only; the
    ``wide`` and ``wide_mma`` routes take every pair."""
    if route not in ("wide", "wide_mma") and (d, dv) not in _head_dims_of(route):
        what = "v of q's head dim and " if route == "simt" and dv != d else ""
        raise ValueError(f"head dims (d, dv) = {(d, dv)} are not instantiated by the {route} kernel, "
                         f"which takes {what}the pairs {_head_dims_of(route)}")


def _fwd_kernel(route: str):
    """A route's C entry (and, for ``split``, its split size), loaded (and
    built) on first use."""
    if route not in _FWD:
        from perceiver_io_tpu_torch import _build

        source, entry, n_ptr, n_int = _FWD_ENTRIES[route]
        lib = _build.load(source)
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        split = lib.flash_attention_fwd_split_size() if route == "split" else None
        _FWD[route] = (fn, split)
    return _FWD[route]


def _bwd_route(dtype: torch.dtype, d: int, dv: int) -> str:
    """K2's and K3's design for inputs of ``dtype`` at head dims ``(d, dv)``:
    ``wide_mma`` for a pair outside :data:`HEAD_DIMS`, else ``wgmma`` for
    bf16 and ``tf32x3`` for fp32. The choice depends on nothing else."""
    if (d, dv) not in HEAD_DIMS:
        return "wide_mma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


#: per backward route: (library source, suffix of its C entries)
_BWD_ENTRIES = {
    "simt": ("flash_attention_bwd", ""),
    "wgmma": ("flash_attention_bwd_wgmma", "_wgmma"),
    "tf32x3": ("flash_attention_bwd_tf32", "_tf32x3"),
    "wide_mma": ("flash_attention_bwd_wide_mma", "_wide_mma"),
    "wide": ("flash_attention_bwd_wide", "_wide"),
}
#: per backward route taking any pair: the int arguments its K2 and K3
#: entries take after ``(d, dv)`` (K2 also takes a scratch pointer)
_BWD_PLAN_INTS = {"wide": (2, 0), "wide_mma": (4, 2)}
#: the type each tensor-core route takes (K1's and K2/K3's alike; the
#: others take fp32 and bf16)
_ROUTE_DTYPE = {"wgmma": torch.bfloat16, "tf32x3": torch.float32}


def _bwd_kernels(route: str):
    """A backward route's K2 and K3 C entries, loaded (and built) on first
    use. The entries but ``simt``'s take ``dv`` after ``d``; the ``simt``
    ones take ``d`` alone; ``wide``'s and ``wide_mma``'s also take their
    plan (:data:`_BWD_PLAN_INTS`), and their K2 a scratch pointer."""
    if route not in _BWD:
        from perceiver_io_tpu_torch import _build

        source, suffix = _BWD_ENTRIES[route]
        lib = _build.load(source)
        dq, dkv = getattr(lib, f"flash_attention_bwd_dq{suffix}"), getattr(lib, f"flash_attention_bwd_dkv{suffix}")
        n_int = 7 if route == "simt" else 8
        dq_ints, dkv_ints = _BWD_PLAN_INTS.get(route, (0, 0))
        dq.argtypes = ([ctypes.c_void_p] * (8 + (route in _BWD_PLAN_INTS)) + [ctypes.c_int] * (n_int + dq_ints)
                       + [ctypes.c_void_p])
        dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (n_int + dkv_ints) + [ctypes.c_void_p]
        dq.restype = dkv.restype = ctypes.c_int
        _BWD[route] = (dq, dkv)
    return _BWD[route]


def _check(q, k, v, pad_mask, causal) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, h, n, d)")
    b, h, i, d = q.shape
    j, dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, h, j, d) or tuple(v.shape) != (b, h, j, dv):
        raise ValueError(
            f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}: the "
            "kernel takes k of shape (b, h, j, d) with q's head dim and v of shape (b, h, j, dv)"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if causal and j < i:
        raise ValueError(f"causal attention needs kv length {j} >= query length {i}")
    if i < 1 or j < 1:
        raise ValueError("empty attention")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, j):
        raise ValueError(f"pad_mask must be {(b, j)}, got {tuple(pad_mask.shape)}")


def _on_cpu(tensors, pad_mask) -> bool:
    """True when every tensor lies on the CPU (the plain version runs).
    Otherwise they must all lie on one CUDA device, and all but the pad mask
    be contiguous, or this raises."""
    every = list(tensors) + ([] if pad_mask is None else [pad_mask])
    if all(t.device.type == "cpu" for t in every):
        return True
    if not all(t.is_cuda and t.device == every[0].device for t in every):
        raise ValueError("the attention tensors and pad_mask must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the attention tensors must be contiguous")
    return False


def _pad_bytes(pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if pad_mask is None else pad_mask.to(torch.uint8).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of flash attention: the forward kernel (K1) for CUDA
    tensors, the plain version for CPU tensors. Not differentiable: see
    :func:`flash_attention`.

    :param q: ``(b, h, i, d)`` pre-scaled, pre-rotated queries.
    :param k: ``(b, h, j, d)`` keys.
    :param v: ``(b, h, j, dv)`` values, of a head dim of their own.
    :param pad_mask: optional bool ``(b, j)``, True marks padding.
    :param causal: right-aligned causal masking (offset ``j - i``).

    ``flash_attention.launches`` counts the calls that launch K1,
    ``flash_attention.route_launches`` splits them by route and
    ``flash_attention.kernel_launches`` counts the device kernels launched
    (two per split-route call).
    """
    _check(q, k, v, pad_mask, causal)
    if _on_cpu((q, k, v), pad_mask):
        return flash_attention_reference(q, k, v, pad_mask=pad_mask, causal=causal)
    route = _fwd_route(q.shape[2], q.dtype, q.shape[3], v.shape[3])
    out = _fwd_launch(route, q, k, v, pad_mask, causal)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.kernel_launches += ROUTE_KERNELS[route]
    return out


def _fwd_launch(route: str, q, k, v, pad_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``route``'s K1 kernel on checked CUDA tensors (uncounted): the
    wrapper's launcher, also used to time one route against another on the
    same inputs. Raises on what the route's kernel does not take, before its
    library loads where the check needs no kernel."""
    b, h, i, d = q.shape
    j, dv = k.shape[2], v.shape[3]
    if route in _ROUTE_DTYPE and q.dtype != _ROUTE_DTYPE[route]:
        raise TypeError(f"the {route} route takes {_ROUTE_DTYPE[route]}, got {q.dtype}")
    if route == "split" and i > SPLIT_MAX_ROWS:
        raise ValueError(f"the split route takes at most {SPLIT_MAX_ROWS} query rows, got {i}")
    if route not in _ANY_ALIGNMENT and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the {route} route needs q, k and v on 16-byte aligned bases")
    _check_head_dims(route, d, dv)
    fn, split = _fwd_kernel(route)
    pad = _pad_bytes(pad_mask)
    o = torch.empty((b, h, i, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, i), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad), o.data_ptr(), lse.data_ptr())
        if route == "simt":
            err = fn(*ptrs, b, h, i, j, d, int(causal), _DTYPES[q.dtype], stream)
        elif route in _ROUTE_DTYPE:
            err = fn(*ptrs, b, h, i, j, d, dv, int(causal), stream)
        elif route == "wide_mma":
            p = _wide_mma_fwd_plan(i, j, h, d, dv, q.dtype)
            part_ml = torch.empty((b, h, p.splits, i, 2), dtype=torch.float32, device=q.device)
            part_acc = torch.empty((b, h, p.splits, i, dv), dtype=torch.float32, device=q.device)
            err = fn(*ptrs, part_ml.data_ptr(), part_acc.data_ptr(), b, h, i, j, d, dv, p.splits,
                     p.tiles_per_split, int(causal), _DTYPES[q.dtype], stream)
        elif route == "wide":
            n_splits, per = _wide_splits(i, j, h, dv)
            part_ml = torch.empty((b, h, n_splits, i, 2), dtype=torch.float32, device=q.device)
            part_acc = torch.empty((b, h, n_splits, i, dv), dtype=torch.float32, device=q.device)
            err = fn(*ptrs, part_ml.data_ptr(), part_acc.data_ptr(), b, h, i, j, d, dv, n_splits, per,
                     int(causal), _DTYPES[q.dtype], stream)
        else:
            n_splits = -(-j // split)
            part_ml = torch.empty((b, h, n_splits, i, 2), dtype=torch.float32, device=q.device)
            part_acc = torch.empty((b, h, n_splits, i, dv), dtype=torch.float32, device=q.device)
            err = fn(*ptrs, part_ml.data_ptr(), part_acc.data_ptr(), b, h, i, j, d, dv, n_splits,
                     int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({route}) kernel launch failed: cudaError_t {err}")
    return o, lse


def _check_bwd(q, k, v, lse, delta, do, pad_mask, causal) -> None:
    _check(q, k, v, pad_mask, causal)
    b, h, i, _ = q.shape
    want = (b, h, i, v.shape[3])
    if tuple(do.shape) != want or do.dtype != q.dtype:
        raise ValueError(f"do must be {want} {q.dtype}, got {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, i) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, h, i)}, got {t.dtype} {tuple(t.shape)}")


def _bwd_launch(route: str, q, k, v, lse, delta, do, pad_mask, causal, which: int, outputs) -> None:
    """Launch ``route``'s K2 (``which`` 0, ``outputs`` ``(dq,)``) or K3
    (``which`` 1, ``(dk, dv)``) on checked CUDA tensors (uncounted): the
    wrappers' launcher, also used to time one route against another on the
    same inputs. Raises on what the route's kernel does not take."""
    if route in _ROUTE_DTYPE:
        if q.dtype != _ROUTE_DTYPE[route]:
            raise TypeError(f"the {route} route takes {_ROUTE_DTYPE[route]}, got {q.dtype}")
        if any(t.data_ptr() % 16 for t in (q, k, v, do, *outputs)):
            raise ValueError(f"the {route} route needs q, k, v, do and the outputs on 16-byte aligned bases")
    b, h, i, d = q.shape
    j, dv = k.shape[2], v.shape[3]
    _check_head_dims(route, d, dv)
    dq_fn, dkv_fn = _bwd_kernels(route)
    pad = _pad_bytes(pad_mask)
    fn, name = (dq_fn, "flash_attention_bwd_dq") if which == 0 else (dkv_fn, "flash_attention_bwd_dkv")
    dims = (d,) if route == "simt" else (d, dv)
    scratch, plan = (), ()
    if route == "wide" and which == 0:
        plan = _wide_splits(i, j, h, d)
    elif route == "wide_mma":
        p = _wide_mma_plan(i, j, h, d, dv, q.dtype)
        plan = ((p.rows, p.dq_groups, p.dq_splits, p.dq_tiles_per_split) if which == 0
                else (p.rows, p.dkv_groups))
    if route in _BWD_PLAN_INTS and which == 0:  # one fp32 partial dq per key split (the plan's last int but one)
        scratch = (torch.empty((b, h, plan[-2], i, d), dtype=torch.float32, device=q.device),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad), lse.data_ptr(), delta.data_ptr(),
            do.data_ptr(), *(o.data_ptr() for o in outputs + scratch),
            b, h, i, j, *dims, *plan, int(causal), _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} ({route}) kernel launch failed: cudaError_t {err}")


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    do: torch.Tensor, *, pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """``dq`` of flash attention: K2 for CUDA tensors (through
    :func:`_bwd_route`'s design), the plain version for CPU tensors. ``lse`` is
    the forward's, ``delta`` :func:`attention_delta`'s, both fp32
    ``(b, h, i)``; ``do`` ``(b, h, i, dv)`` in q's type.

    ``flash_attention_bwd_dq.launches`` counts the launches,
    ``flash_attention_bwd_dq.route_launches`` splits them by route."""
    _check_bwd(q, k, v, lse, delta, do, pad_mask, causal)
    if _on_cpu((q, k, v, lse, delta, do), pad_mask):
        return flash_attention_bwd_dq_reference(
            q, k, v, lse, delta, do, pad_mask=pad_mask, causal=causal)
    route = _bwd_route(q.dtype, q.shape[3], v.shape[3])
    dq = torch.empty_like(q)
    _bwd_launch(route, q, k, v, lse, delta, do, pad_mask, causal, 0, (dq,))
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.route_launches[route] += 1
    return dq


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    do: torch.Tensor, *, pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of flash attention: K3 for CUDA tensors, the plain version
    for CPU tensors (arguments and counters as :func:`flash_attention_bwd_dq`)."""
    _check_bwd(q, k, v, lse, delta, do, pad_mask, causal)
    if _on_cpu((q, k, v, lse, delta, do), pad_mask):
        return flash_attention_bwd_dkv_reference(
            q, k, v, lse, delta, do, pad_mask=pad_mask, causal=causal)
    route = _bwd_route(q.dtype, q.shape[3], v.shape[3])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(route, q, k, v, lse, delta, do, pad_mask, causal, 1, (dk, dv))
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.route_launches[route] += 1
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (JAX ``_flash`` with ``_flash_fwd`` and
    ``_flash_bwd``): the forward kernel saves ``q, k, v, o, lse`` and the pad
    mask; the backward takes ``delta = rowsum(o * do)`` in fp32 and launches
    K2 for ``dq`` and K3 for ``dk, dv``. CPU tensors run the plain versions.
    The pad mask and ``causal`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal):
        o, lse = flash_attention_fwd(q, k, v, pad_mask=pad_mask, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, pad_mask)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, pad_mask = ctx.saved_tensors
        do = do.contiguous()  # the heads' merge hands it over transposed
        delta = attention_delta(o, do)
        kw = dict(pad_mask=pad_mask, causal=ctx.causal)
        dq = flash_attention_bwd_dq(q, k, v, lse, delta, do, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Differentiable flash attention output ``(b, h, i, dv)`` through
    :class:`FlashAttentionFunction` (arguments as :func:`flash_attention_fwd`).
    ``flash_attention.launches`` counts the forward kernel's launches."""
    return FlashAttentionFunction.apply(q, k, v, pad_mask, causal)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.kernel_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.route_launches = dict.fromkeys(BWD_ROUTES, 0)
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.route_launches = dict.fromkeys(BWD_ROUTES, 0)
