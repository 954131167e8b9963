"""3xTF32 arithmetic in plain torch, for the tests of the port's ``tf32x3``
kernels (K1 in ``csrc/flash_attention_fwd_tf32.cu``, K2/K3 in
``csrc/flash_attention_bwd_tf32.cu``, K4's ``tc`` route in
``csrc/ragged_paged_attention_tc.cu``): every operand of a product split into
``hi``, ``x`` rounded to TF32's 10 mantissa bits to nearest with ties away
from zero (``cvt.rna.tf32.f32``'s rounding for finite values below the
rounding overflow, which the kernels compute with two integer operations),
and ``lo = x - hi``, which the tensor cores read truncated to TF32; each
product taken as ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` (``mm3``), or, where
``b``'s values are exact in TF32, as ``a_lo.b + a_hi.b`` (``mm2``)."""
import torch


def tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """fp32 cut to TF32's 10 mantissa bits: rounded to nearest with ties
    away from zero (``cvt.rna.tf32.f32`` for finite values below the rounding
    overflow: add half of the 13 dropped bits to the magnitude, then clear
    them), or truncated (as the tensor cores read an fp32 operand)."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if rounded else bits) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the ``tf32x3`` kernels take it: both operands split into
    TF32 ``hi`` and ``lo`` parts, the two small cross products and the big
    one summed (each exact in float64 here), ``lo . lo`` dropped."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi, rounded=False), tf32(b - b_hi, rounded=False)
    terms = (a_lo.double() @ b_hi.double(), a_hi.double() @ b_lo.double(), a_hi.double() @ b_hi.double())
    return sum(terms).float()


def mm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``b``'s values exact in TF32 (bf16 or int8 values), as
    K4's ``tc`` route takes it for those pools: only ``a`` is split,
    ``a_lo.b + a_hi.b`` (each exact in float64 here)."""
    a_hi = tf32(a)
    a_lo = tf32(a - a_hi, rounded=False)
    return (a_lo.double() @ b.double() + a_hi.double() @ b.double()).float()
