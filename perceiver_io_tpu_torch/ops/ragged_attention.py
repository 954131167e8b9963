"""Ragged paged attention (K4): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the Pallas TPU kernel in
``perceiver_io_tpu/ops/ragged_attention.py`` (``_make_kernel`` + ``_launch``,
public ``ragged_paged_attention``). One kernel serves both row shapes of the
paged slot engine: decode rows (``q_len = 1``) and boundary/window rows
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

:func:`ragged_paged_attention` launches the kernel
(``csrc/ragged_paged_attention.cu``) for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs
:func:`ragged_paged_attention_reference`. There is no fallback from a CUDA
tensor to the plain version. ``ragged_paged_attention.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: the TPU kernel's finite running-max sentinel
NEG = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


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


def _kernel():
    global _FN
    if _FN is None:
        from perceiver_io_tpu_torch import _build

        lib = _build.load("ragged_paged_attention")
        fn = lib.ragged_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_supports_head_dim.argtypes = [ctypes.c_int]
        lib.ragged_paged_attention_supports_head_dim.restype = ctypes.c_int
        _FN = (fn, lib.ragged_paged_attention_supports_head_dim)
    return _FN


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
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (scale_k is None) != (scale_v is None):
        raise ValueError("scale_k and scale_v come together")
    if scale_k is None:
        if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
            raise TypeError(f"exact pools must have q's type {q.dtype}, got {pool_k.dtype}/{pool_v.dtype}")
    else:
        if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
            raise TypeError(f"scaled pools must be int8, got {pool_k.dtype}/{pool_v.dtype}")
        for s in (scale_k, scale_v):
            if tuple(s.shape) != (tokens, h, 1) or s.dtype != torch.float32:
                raise ValueError(f"scales must be float32 ({tokens}, {h}, 1), got {s.dtype} {tuple(s.shape)}")


def ragged_paged_attention(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    lengths: torch.Tensor, *, block_size: int, scale_k: Optional[torch.Tensor] = None,
    scale_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged paged attention over the flat pool: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

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
    fn, supports = _kernel()
    b, h, q_len, d = q.shape
    if not supports(d):
        raise ValueError(f"head dim {d} is not instantiated by the kernel (64, 112, 128)")
    table32 = table.to(torch.int32)
    lengths32 = lengths.to(torch.int32)
    o = torch.empty_like(q)
    quantized = scale_k is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            scale_k.data_ptr() if quantized else None, scale_v.data_ptr() if quantized else None,
            table32.data_ptr(), lengths32.data_ptr(), o.data_ptr(),
            b, h, q_len, d, table.shape[1], block_size, _DTYPES[q.dtype], int(quantized), stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: cudaError_t {err}")
    ragged_paged_attention.launches += 1
    return o


ragged_paged_attention.launches = 0
