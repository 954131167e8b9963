"""Flash attention forward with Perceiver masking: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the Pallas TPU kernel ``_forward`` in
``perceiver_io_tpu/ops/flash_attention.py``. The kernel
(``csrc/flash_attention_fwd.cu``, Hopper ``sm_90a``) computes blockwise
online-softmax attention over pre-scaled queries with

- the right-aligned causal mask ``col <= row + (j - i)`` (Perceiver AR
  latents attend over ``[prefix || latents]``), skipping kv tiles wholly
  above the shifted diagonal;
- an optional ``(b, j)`` key pad mask (True = pad);
- fp32 accumulation, output in the input type, and the fp32 logsumexp
  ``(b, h, i)``;
- **zero output for a query row that sees no key** (the TPU kernel's dead-row
  semantics; the einsum path instead softmaxes such a row uniformly).

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and raises
on what the kernel does not take; for CPU tensors it runs
:func:`flash_attention_reference`, which repeats the kernel's arithmetic.
There is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: The TPU kernel's large-but-finite mask value (``flash_attention.py:47``).
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same masks, same mask constant,
    same dead-row zeros, ``p`` cast to ``v``'s type before the ``p @ v``
    product.

    :return: ``(o, lse)`` — ``o`` ``(b, h, i, dv)`` in ``q``'s type, ``lse``
        ``(b, h, i)`` fp32.
    """
    i, j = q.shape[2], k.shape[2]
    s = torch.einsum("bhic,bhjc->bhij", q.float(), k.float())
    allowed = torch.ones(i, j, dtype=torch.bool, device=q.device)[None, None]
    if pad_mask is not None:
        allowed = allowed & ~pad_mask.bool()[:, None, None, :]
    if causal:
        cols = torch.arange(j, device=q.device)[None, :]
        rows = torch.arange(i, device=q.device)[:, None]
        allowed = allowed & (cols <= rows + (j - i))[None, None]
    s = torch.where(allowed, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhij,bhjc->bhic", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.where(l > 0, acc / safe_l, torch.zeros_like(acc))
    lse = (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), lse


def _kernel():
    global _FN
    if _FN is None:
        from perceiver_io_tpu_torch import _build

        lib = _build.load("flash_attention_fwd")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_fwd_supports_head_dim.argtypes = [ctypes.c_int]
        lib.flash_attention_fwd_supports_head_dim.restype = ctypes.c_int
        _FN = (fn, lib.flash_attention_fwd_supports_head_dim)
    return _FN


def _check(q, k, v, pad_mask, causal) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, h, n, d)")
    b, h, i, d = q.shape
    j = k.shape[2]
    if tuple(k.shape) != (b, h, j, d) or tuple(v.shape) != (b, h, j, d):
        raise ValueError(
            f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}: the "
            "kernel takes k and v of shape (b, h, j, d) with q's head dim"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if causal and j < i:
        raise ValueError(f"causal attention needs kv length {j} >= query length {i}")
    if i < 1 or j < 1:
        raise ValueError("empty attention")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, j):
        raise ValueError(f"pad_mask must be {(b, j)}, got {tuple(pad_mask.shape)}")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of flash attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    :param q: ``(b, h, i, d)`` pre-scaled, pre-rotated queries.
    :param k: ``(b, h, j, d)`` keys.
    :param v: ``(b, h, j, d)`` values.
    :param pad_mask: optional bool ``(b, j)``, True marks padding.
    :param causal: right-aligned causal masking (offset ``j - i``).
    """
    _check(q, k, v, pad_mask, causal)
    tensors = [q, k, v] + ([] if pad_mask is None else [pad_mask])
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_reference(q, k, v, pad_mask=pad_mask, causal=causal)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("q, k, v and pad_mask must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    fn, supports = _kernel()
    b, h, i, d = q.shape
    j = k.shape[2]
    if not supports(d):
        raise ValueError(f"head dim {d} is not instantiated by the kernel (64, 112, 128)")
    pad = None
    if pad_mask is not None:
        pad = pad_mask.to(torch.uint8).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, i), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad is None else pad.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, i, j, d, int(causal), _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    pad_mask: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Flash attention output ``(b, h, i, d)`` (see :func:`flash_attention_fwd`).
    ``flash_attention.launches`` counts the CUDA kernel's launches."""
    return flash_attention_fwd(q, k, v, pad_mask=pad_mask, causal=causal)[0]


flash_attention.launches = 0
