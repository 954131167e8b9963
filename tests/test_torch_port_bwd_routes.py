"""K2's and K3's routes behind their wrappers, on the CPU.

``flash_attention_bwd_dq`` (K2) and ``flash_attention_bwd_dkv`` (K3) pick the
backward kernel's design by the input type alone (``_bwd_route``): ``wgmma``
(bf16 tensor-core tiles fed by TMA) for bf16, ``tf32x3`` (each fp32 product
as three TF32 products on ``mma.sync``) for fp32; ``simt`` (the CUDA-core
kernels) is reached only by name. CPU tensors take the plain version and
launch no route.

The ``tf32x3`` route's arithmetic is emulated here in plain torch
(``tests/_torch_port_tf32.py``): every operand of the five products split
into TF32 ``hi`` and ``lo`` parts, each product taken as
``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi``. That emulation is
held against ``jax.grad`` of the JAX ``flash_attention`` in fp32 (the
Pallas kernels in interpret mode) on two cases with pads, at 1e-4 of each
gradient's largest entry, the card's fp32 gate. Measured on the CPU, the largest difference is
1.1e-6 of a gradient's largest entry (dk, the second case): 90x inside the
gate, where one TF32 product per fp32 product lands at up to 1.3e-3, over it.

The ``wgmma`` route reproduces the plain bf16 backward: ``p`` and ``ds``
rounded to bf16 before their products, fp32 sums, bf16 outputs. That plain
bf16 backward, through ``FlashAttentionFunction`` on CPU tensors, is held
here against ``jax.grad`` of the JAX ``flash_attention`` on the same bf16
inputs, the Pallas kernels K1-K3 in interpret mode as
``test_flash_grads_match_pallas`` runs them in fp32, on two of that test's
cases with pads. Measured on the CPU, the largest difference is 4.2e-3 of a
gradient's largest entry (dq; about one bf16 ulp: the two packages sum in
other orders, so a rounded entry can land on the neighbouring bf16 value);
4x that is 1.7e-2, so the limit is the cap of 2^-6 (1.6e-2) of each
gradient's largest entry.

The kernels run only on the card: ``test_backward_kernels_match_plain_on_card``
in ``test_torch_port_flash_bwd.py`` is marked ``cuda`` and skips without one;
``python3 chip_smoke.py`` (phases ``k23`` and ``train``) holds both routes at
the training path's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu_torch.ops import flash_attention as flash
from tests._torch_port_tf32 import mm3, tf32

BF16_REL_TOL = 2.0**-6


def _inputs(rng, b, h, i, j, d, dtype):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    do = rng.standard_normal((b, h, i, d)).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _counts():
    return {name: (w.launches, dict(w.route_launches))
            for name, w in (("dq", flash.flash_attention_bwd_dq), ("dkv", flash.flash_attention_bwd_dkv))}


@pytest.mark.parametrize("dtype,route", [(torch.float32, "tf32x3"), (torch.bfloat16, "wgmma")])
def test_bwd_route_table(dtype, route):
    assert flash._bwd_route(dtype) == route
    assert route in flash.BWD_ROUTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_launch_no_bwd_route(rng, dtype):
    q, k, v, do = _inputs(rng, 2, 2, 20, 70, 16, dtype)
    pad = torch.arange(70)[None] < torch.tensor([[0], [30]])
    o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True)
    delta = flash.attention_delta(o, do)
    before = _counts()
    dq = flash.flash_attention_bwd_dq(q, k, v, lse, delta, do, pad_mask=pad, causal=True)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do, pad_mask=pad, causal=True)
    assert _counts() == before
    assert all(set(routes) == set(flash.BWD_ROUTES) for _, routes in before.values())
    assert dq.dtype == dk.dtype == dv.dtype == dtype


def test_wgmma_route_refuses_fp32_and_misaligned_bases(rng):
    q, k, v, do = _inputs(rng, 1, 1, 8, 8, 64, torch.float32)
    stats = torch.zeros(1, 1, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        flash._bwd_launch("wgmma", q, k, v, stats, stats, do, None, True, 0, (torch.empty_like(q),))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16)[1:].view_as(q)  # a 2-byte offset base
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash._bwd_launch("wgmma", shifted, k, v, stats, stats, do, None, True, 1,
                          (torch.empty_like(k), torch.empty_like(v)))


def test_tf32x3_route_refuses_bf16_and_misaligned_bases(rng):
    q, k, v, do = _inputs(rng, 1, 1, 8, 8, 64, torch.bfloat16)
    stats = torch.zeros(1, 1, 8)
    with pytest.raises(TypeError, match="float32"):
        flash._bwd_launch("tf32x3", q, k, v, stats, stats, do, None, True, 0, (torch.empty_like(q),))
    q, k, v, do = (t.float() for t in (q, k, v, do))
    shifted = torch.empty(do.numel() + 1)[1:].view_as(do)  # a 4-byte offset base
    shifted.copy_(do)
    with pytest.raises(ValueError, match="16-byte"):
        flash._bwd_launch("tf32x3", q, k, v, stats, stats, shifted, None, True, 1,
                          (torch.empty_like(k), torch.empty_like(v)))


def _jax_grads(q, k, v, do, pad, causal):
    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, pad_mask=jnp.asarray(pad), causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do.float().numpy()))

    args = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    return [np.asarray(g.astype(jnp.float32)) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]


# (i, j, causal): two of the CASES of tests/test_flash_attention.py, with pads
@pytest.mark.parametrize("i,j,causal", [(256, 640, True), (128, 384, True)])
def test_plain_bf16_backward_matches_pallas(rng, i, j, causal):
    q, k, v, do = _inputs(rng, 1, 2, i, j, 64, torch.bfloat16)
    pad = rng.random((1, j)) < 0.2
    expected = _jax_grads(q, k, v, do, pad, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash.flash_attention(*leaves, pad_mask=torch.from_numpy(pad), causal=causal)
    o.backward(do)
    for leaf, want, name in zip(leaves, expected, ("dq", "dk", "dv")):
        got = leaf.grad
        assert got.dtype == torch.bfloat16, name
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_REL_TOL * np.abs(want).max(), f"{name}: {err} of {np.abs(want).max()}"


def _tf32x3_backward(q, k, v, o, lse, do, pad, causal):
    """K2 and K3 with every product in 3xTF32 (the ``tf32x3`` kernels'
    arithmetic; masks by select, fp32 elsewhere)."""
    allowed = flash._allowed(q, k.shape[2], pad, causal)
    s = mm3(q, k.transpose(-1, -2))
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    dp = mm3(do, v.transpose(-1, -2))
    ds = torch.where(allowed, p * (dp - flash.attention_delta(o, do)[..., None]), 0.0)
    return mm3(ds, k), mm3(ds.transpose(-1, -2), q), mm3(p.transpose(-1, -2), do)


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23, 1 + 3 * ulp / 2, 3.0])
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0]
    assert tf32(x, rounded=False).tolist() == [1.0, -1.0, 1.0, 1 + ulp, 3.0]


@pytest.mark.parametrize("i,j,causal", [(256, 640, True), (128, 384, True)])
def test_tf32x3_backward_matches_pallas(rng, i, j, causal):
    q, k, v, do = _inputs(rng, 1, 2, i, j, 64, torch.float32)
    pad = torch.from_numpy(rng.random((1, j)) < 0.2)
    o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=causal)
    got = _tf32x3_backward(q, k, v, o, lse, do, pad, causal)

    def loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, pad_mask=jnp.asarray(pad.numpy()), causal=causal)
        return jnp.sum(out * jnp.asarray(do.numpy()))

    expected = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for mine, want, name in zip(got, expected, ("dq", "dk", "dv")):
        want = np.asarray(want)
        err = np.abs(mine.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"{name}: {err} of {np.abs(want).max()}"
