"""Ragged paged attention (K4): the CUDA kernels' wrapper and its plain
PyTorch version.

Counterpart of the Pallas TPU kernel in
``perceiver_io_tpu/ops/ragged_attention.py`` (``_make_kernel`` + ``_launch``,
public ``ragged_paged_attention``). It serves both row shapes of the paged
slot engine: decode rows (``q_len = 1``) and boundary/window rows
(``q_len = max_latents``). It reads the flat token-major pool through a
block table and per-row lengths, and computes an online softmax over each
row's live span ``[0, lengths[r])`` under the Perceiver AR right-aligned
causal bound: query ``qi`` of a ``q_len``-query row sits at position
``lengths[r] - q_len + qi`` and sees positions up to its own.

- ``-1e30`` sentinel for the running max; masked probabilities are zeroed
  explicitly; the output is ``acc / max(l, 1e-30)``, so rows with
  ``lengths <= 0`` emit exact zeros;
- int8 pools come with fp32 ``(pool_tokens, h, 1)`` scales and are
  dequantized on the page (``int8 * scale`` in fp32); a zero scale reads 0;
- no scale on q (it arrives pre-scaled) and no output projection.

K4 has two Hopper ``sm_90a`` designs behind one wrapper, picked by
:func:`_k4_route` from the query length alone, and a third reached only by
name:

- ``split`` (``csrc/ragged_paged_attention_split.cu``), at most 16 queries a
  row (decode rows): each row's keys cut into 64-key splits (four 16-token
  pages), one block per (split, head, row) reading its pages with 16-byte
  loads and writing fp32 partials, and a merge launch;
- ``tc`` (``csrc/ragged_paged_attention_tc.cu``), more queries (window
  rows): both products on the tensor cores as TF32 ``mma.sync`` products,
  fp32-accurate (3xTF32 for fp32 pools; bf16 and int8 values are exact in
  TF32, so they need fewer), one block of 8 warps per 64-query tile, the
  pages gathered with ``cp.async`` two tiles deep;
- ``simt`` (``csrc/ragged_paged_attention.cu``), the first design on the
  CUDA cores, reached only by name through :func:`_k4_launch` (to time it
  against the others).

:func:`ragged_paged_attention` launches a route for CUDA tensors and raises
on what the route does not take; for CPU tensors it runs
:func:`ragged_paged_attention_reference`. There is no fallback from a CUDA
tensor to the plain version or to another route.
``ragged_paged_attention.launches`` counts the calls that launch K4,
``ragged_paged_attention.route_launches`` splits them by route and
``ragged_paged_attention.kernel_launches`` counts the device kernels (two per
split-route call: partials and merge).

Under a serving mesh (JAX's ``shard_map`` over the kernel) each rank calls
this wrapper on its shard: ``(rows_local, h_local, q_len, d)`` queries over
its own ``(pool_tokens, h_local, d)`` pools and scales, allocated at
``h_local`` heads (never a head slice of a whole pool: the kernel takes
contiguous tensors).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: the TPU kernel's finite running-max sentinel
NEG = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K4's designs (:func:`_k4_route` picks one of the first two)
ROUTES = ("split", "tc", "simt")
#: the most queries a row the split route takes
SPLIT_MAX_ROWS = 16
#: device kernels one call of each route launches
ROUTE_KERNELS = {"split": 2, "tc": 1, "simt": 1}
#: the head dims the ``split`` and ``tc`` kernels instantiate (their
#: ``*_supports_head_dim``)
HEAD_DIMS = (64, 96, 112, 128)
#: the head dims of the ``simt`` kernel, reached by name only
SIMT_HEAD_DIMS = (64, 112, 128)
#: per route: (library source, C entry, pointer args, int args)
_ENTRIES = {
    "simt": ("ragged_paged_attention", "ragged_paged_attention", 8, 8),
    "split": ("ragged_paged_attention_split", "ragged_paged_attention_split", 10, 9),
    "tc": ("ragged_paged_attention_tc", "ragged_paged_attention_tc", 8, 8),
}
_LIBS = {}


def ragged_paged_attention_reference(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    lengths: torch.Tensor, *, block_size: int, scale_k: Optional[torch.Tensor] = None,
    scale_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gathers every page of the table
    (the kernel reads only the live ones), dequantizes, and applies the
    kernel's masks, sentinel, zeroing and epilogue in fp32.

    :return: ``(b, h, q_len, d)`` in ``q``'s type.
    """
    b, h, q_len, d = q.shape
    pages = table.shape[1]
    n = pages * block_size
    pos = torch.arange(n, device=q.device)
    flat = (table.long()[:, pos // block_size] * block_size + pos % block_size)  # (b, n)
    k = pool_k[flat].float()  # (b, n, h, d)
    v = pool_v[flat].float()
    if scale_k is not None:
        k = k * scale_k[flat].float()
        v = v * scale_v[flat].float()
    s = torch.einsum("bhqd,bnhd->bhqn", q.float(), k)
    qi = torch.arange(q_len, device=q.device)[:, None]
    valid = (pos[None, :] + (q_len - 1) - qi)[None] < lengths.long()[:, None, None]  # (b, q, n)
    valid = valid[:, None]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqn,bnhd->bhqd", p, v)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _kernel(route: str):
    """A route's C entry and head-dim query (and, for ``split``, its split
    size), loaded (and built) on first use."""
    if route not in _LIBS:
        from perceiver_io_tpu_torch import _build

        source, entry, n_ptr, n_int = _ENTRIES[route]
        lib = _build.load(source)
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        supports = getattr(lib, f"{entry}_supports_head_dim")
        supports.argtypes = [ctypes.c_int]
        supports.restype = ctypes.c_int
        split = lib.ragged_paged_attention_split_size() if route == "split" else None
        _LIBS[route] = (fn, supports, split)
    return _LIBS[route]


def _k4_route(q_len: int, dtype: torch.dtype) -> str:
    """K4's design for rows of ``q_len`` queries of ``dtype``: ``split`` for
    decode rows (``q_len <= 16``), else ``tc``; both take fp32 and bf16. The
    choice depends on nothing else (not the batch, not the lengths), so a
    row's result does not either."""
    if dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16 queries, got {dtype}")
    return "split" if q_len <= SPLIT_MAX_ROWS else "tc"


def _check(q, pool_k, pool_v, table, lengths, block_size, scale_k, scale_v) -> None:
    if q.dim() != 4 or pool_k.dim() != 3 or pool_v.dim() != 3:
        raise ValueError("q must be (b, h, q_len, d) and the pools (pool_tokens, h, d)")
    b, h, q_len, d = q.shape
    tokens = pool_k.shape[0]
    if tuple(pool_k.shape) != (tokens, h, d) or tuple(pool_v.shape) != (tokens, h, d):
        raise ValueError(
            f"pools {tuple(pool_k.shape)}/{tuple(pool_v.shape)} must be (pool_tokens, {h}, {d}) "
            f"for q {tuple(q.shape)}"
        )
    if block_size < 1 or tokens % block_size:
        raise ValueError(f"pool_tokens={tokens} not a multiple of block_size={block_size}")
    if table.dim() != 2 or table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"table must be ({b}, pages) and lengths ({b},)")
    if table.dtype.is_floating_point or lengths.dtype.is_floating_point:
        raise TypeError("table and lengths must be integer tensors")
    if q_len < 1:
        raise ValueError("empty query")
    if (scale_k is None) != (scale_v is None):
        raise ValueError("scale_k and scale_v come together")
    _check_types(q, pool_k, pool_v, scale_k)
    if scale_k is not None:
        for s in (scale_k, scale_v):
            if tuple(s.shape) != (tokens, h, 1) or s.dtype != torch.float32:
                raise ValueError(f"scales must be float32 ({tokens}, {h}, 1), got {s.dtype} {tuple(s.shape)}")


def _check_types(q, pool_k, pool_v, scale_k) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if scale_k is None:
        if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
            raise TypeError(f"exact pools must have q's type {q.dtype}, got {pool_k.dtype}/{pool_v.dtype}")
    elif pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise TypeError(f"scaled pools must be int8, got {pool_k.dtype}/{pool_v.dtype}")


def ragged_paged_attention(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    lengths: torch.Tensor, *, block_size: int, scale_k: Optional[torch.Tensor] = None,
    scale_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged paged attention over the flat pool: the kernel of the route
    :func:`_k4_route` picks for CUDA tensors, the plain version for CPU
    tensors.

    :param q: ``(b, h, q_len, d)`` pre-scaled, pre-rotated queries, fp32 or bf16.
    :param pool_k: ``(pool_tokens, h, d)`` pool of q's type, or int8 with scales.
    :param table: ``(b, pages)`` integer block ids (0 = null block).
    :param lengths: ``(b,)`` live-span lengths; ``<= 0`` rows give zeros.
    :param block_size: token positions per block; divides ``pool_tokens``.
    :param scale_k: optional fp32 ``(pool_tokens, h, 1)`` dequant scales.
    :return: ``(b, h, q_len, d)`` raw attention in q's type.

    K4 has no backward pass (nor has the TPU kernel): on CUDA tensors a
    gradient request (grad mode on and ``q`` or a pool requiring grad)
    raises instead of returning an output detached from autograd.
    """
    _check(q, pool_k, pool_v, table, lengths, block_size, scale_k, scale_v)
    tensors = [q, pool_k, pool_v, table, lengths] + ([] if scale_k is None else [scale_k, scale_v])
    if all(t.device.type == "cpu" for t in tensors):
        return ragged_paged_attention_reference(
            q, pool_k, pool_v, table, lengths, block_size=block_size,
            scale_k=scale_k, scale_v=scale_v,
        )
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, pool_k, pool_v)):
        raise RuntimeError(
            "ragged_paged_attention (K4) has no backward pass, as the TPU kernel has none: "
            "call it under torch.no_grad() or with tensors that do not require grad"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the pools, the scales, table and lengths must be contiguous")
    route = _k4_route(q.shape[2], q.dtype)
    o = _k4_launch(route, q, pool_k, pool_v, table, lengths, block_size, scale_k, scale_v)
    ragged_paged_attention.launches += 1
    ragged_paged_attention.route_launches[route] += 1
    ragged_paged_attention.kernel_launches += ROUTE_KERNELS[route]
    return o


def _k4_launch(route: str, q, pool_k, pool_v, table, lengths, block_size: int, scale_k=None,
               scale_v=None) -> torch.Tensor:
    """Launch ``route``'s K4 kernel on checked, contiguous CUDA tensors
    (uncounted): the wrapper's launcher, also used to time one route against
    another on the same inputs. Raises on what the route's kernel does not
    take (a type, a row length, a base off a 16-byte boundary) before its
    library loads, and on a head dim it does not instantiate."""
    b, h, q_len, d = q.shape
    _check_types(q, pool_k, pool_v, scale_k)
    if route == "split" and q_len > SPLIT_MAX_ROWS:
        raise ValueError(f"the split route takes at most {SPLIT_MAX_ROWS} queries a row, got {q_len}")
    if route != "simt" and any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError(f"the {route} route needs q and the pools on 16-byte aligned bases")
    fn, supports, split = _kernel(route)
    if not supports(d):
        raise ValueError(f"head dim {d} is not instantiated by the {route} kernel "
                         f"{SIMT_HEAD_DIMS if route == 'simt' else HEAD_DIMS}")
    table32 = table.to(torch.int32)
    lengths32 = lengths.to(torch.int32)
    pages = table.shape[1]
    o = torch.empty_like(q)
    quantized = scale_k is not None
    scales = (scale_k.data_ptr(), scale_v.data_ptr()) if quantized else (None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
                table32.data_ptr(), lengths32.data_ptr(), o.data_ptr())
        if route == "split":
            n_splits = -(-pages * block_size // split)
            part_ml = torch.empty((b, h, n_splits, q_len, 2), dtype=torch.float32, device=q.device)
            part_acc = torch.empty((b, h, n_splits, q_len, d), dtype=torch.float32, device=q.device)
            err = fn(*ptrs, part_ml.data_ptr(), part_acc.data_ptr(), b, h, q_len, d, pages, block_size,
                     n_splits, _DTYPES[q.dtype], int(quantized), stream)
        else:
            err = fn(*ptrs, b, h, q_len, d, pages, block_size, _DTYPES[q.dtype], int(quantized), stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention ({route}) kernel launch failed: cudaError_t {err}")
    return o


ragged_paged_attention.launches = 0
ragged_paged_attention.route_launches = dict.fromkeys(ROUTES, 0)
ragged_paged_attention.kernel_launches = 0
