"""Port flash-attention backward against the JAX package, on the CPU.

The port's ``flash_attention`` is a ``torch.autograd.Function``: on CPU
tensors its forward is K1's plain version and its backward the plain
version of K2/K3. Its gradients are held against ``jax.grad`` of the JAX
``flash_attention`` (the Pallas kernels K1-K3 in interpret mode, as
``tests/test_flash_attention.py`` runs them) on three of that test's cases,
at its tolerance (atol/rtol 1e-4); a dead-row case checks that both packages
give exactly zero ``dq`` on rows that see no key and zero ``dk``/``dv`` on
padded keys. The plain backward is also held against autograd through the
plain forward on live rows (fp32 1e-5; bf16 at 1e-2 of the largest gradient,
since autograd rounds the cotangent of ``p``'s bf16 cast where the kernels
round ``p`` and ``ds`` themselves).

The CUDA kernels run only on the card: ``test_backward_kernels_match_plain_on_card``
is marked ``cuda`` and skips without one (fp32 through the ``tf32x3`` route at
1e-4; bf16 through ``wgmma`` at two bf16 ulps of the largest entry and no
further from the fp32 backward than 1.5x the plain bf16 version);
``python3 chip_smoke.py`` (phases ``k23`` and ``train``) holds them at the
training path's shapes. ``test_torch_port_bwd_routes.py`` covers the route
table and the plain bf16 backward against JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu_torch.ops import flash_attention as flash

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(rng, b, h, i, j, d):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    cot = rng.standard_normal((b, h, i, d)).astype(np.float32)
    return q, k, v, cot


def _jax_grads(q, k, v, cot, pad, causal):
    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, pad_mask=None if pad is None else jnp.asarray(pad),
                                      causal=causal)
        return jnp.sum(o * cot)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, cot, pad, causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, pad_mask=None if pad is None else torch.from_numpy(pad),
                              causal=causal)
    o.backward(torch.from_numpy(cot))
    return [t.grad.numpy() for t in (tq, tk, tv)]


# (i, j, causal, with_pad): three of the CASES of tests/test_flash_attention.py
@pytest.mark.parametrize("i,j,causal,with_pad", [(128, 384, True, False), (256, 640, True, True),
                                                 (128, 896, True, False)])
def test_flash_grads_match_pallas(rng, i, j, causal, with_pad):
    q, k, v, cot = _inputs(rng, 1, 2, i, j, 64)
    pad = (rng.random((1, j)) < 0.2) if with_pad else None
    counts = (flash.flash_attention.launches, flash.flash_attention_bwd_dq.launches,
              flash.flash_attention_bwd_dkv.launches)
    for actual, expected, name in zip(_port_grads(q, k, v, cot, pad, causal),
                                      _jax_grads(q, k, v, cot, pad, causal), "qkv"):
        np.testing.assert_allclose(actual, expected, err_msg=f"d{name}", **TOL)
    assert counts == (flash.flash_attention.launches, flash.flash_attention_bwd_dq.launches,
                      flash.flash_attention_bwd_dkv.launches)  # no kernel on the CPU


def test_dead_rows_get_zero_grads_in_both_packages(rng):
    i, j = 128, 384
    q, k, v, cot = _inputs(rng, 2, 2, i, j, 64)
    pad = np.zeros((2, j), bool)
    pad[0, :300] = True  # row r sees cols <= r + 256: rows 0..43 of batch row 0 see no key
    pad[1, 100:140] = True
    port = _port_grads(q, k, v, cot, pad, True)
    ref = _jax_grads(q, k, v, cot, pad, True)
    for actual, expected, name in zip(port, ref, "qkv"):
        np.testing.assert_allclose(actual, expected, err_msg=f"d{name}", **TOL)
    for dq, dk, dv in (port, ref):
        assert (dq[0, :, :44] == 0).all() and (np.abs(dq[0, :, 44:]).sum(-1) > 0).all()
        assert (dk[0, :, :300] == 0).all() and (dv[0, :, :300] == 0).all()
        assert (dk[1, :, 100:140] == 0).all() and (dv[1, :, 100:140] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_autograd(rng, dtype):
    dt = getattr(torch, dtype)
    i, j = 48, 80
    q, k, v, cot = (torch.from_numpy(a).to(dt) for a in _inputs(rng, 2, 3, i, j, 32))
    pad = torch.zeros(2, j, dtype=torch.bool)
    pad[1, :50] = True  # rows 0..17 of batch row 1 are dead
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = flash.flash_attention_reference(qq, kk, vv, pad_mask=pad, causal=True)
    auto = torch.autograd.grad(o, (qq, kk, vv), cot)
    plain = flash.flash_attention_backward_reference(q, k, v, o.detach(), lse.detach(), cot,
                                                     pad_mask=pad, causal=True)
    live = torch.ones(2, 1, i, 1, dtype=torch.bool)
    live[1, :, :18] = False
    for a, p, name in zip(auto, plain, ("dq", "dk", "dv")):
        assert p.dtype == dt, name
        a, p = a.float(), p.float()
        if name == "dq":
            a, p = a * live, p * live
            assert (p[1, :, :18] == 0).all()
        if dtype == "float32":
            np.testing.assert_allclose(p.numpy(), a.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
        else:
            assert (p - a).abs().max() <= 1e-2 * a.abs().max(), name


def test_backward_wrappers_check_their_inputs(rng):
    q, k, v, cot = (torch.from_numpy(a) for a in _inputs(rng, 1, 1, 4, 6, 8))
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd_dq(q, k, v, lse[..., :3], lse, cot)
    with pytest.raises(ValueError, match="do must"):
        flash.flash_attention_bwd_dkv(q, k, v, lse, lse, cot[..., :4])
    dq = flash.flash_attention_bwd_dq(q, k, v, lse, lse, cot, causal=True)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, lse, lse, cot, causal=True)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i,j,with_pad", [(512, 768, True), (512, 512, False), (100, 300, True)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, i, j, with_pad):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, 8, n, 112, generator=g, device=cuda_device).to(dtype)
                   for n in (i, j, j, i))
    q = q * 112**-0.5
    pad = torch.arange(j, device=cuda_device)[None] < torch.tensor([[0], [j // 2]], device=cuda_device) \
        if with_pad else None
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash.flash_attention(qq, kk, vv, pad_mask=pad, causal=True)
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = (flash.flash_attention_bwd_dq.route_launches[route],
              flash.flash_attention_bwd_dkv.route_launches[route])
    grads = torch.autograd.grad(o, (qq, kk, vv), do)
    assert (flash.flash_attention_bwd_dq.route_launches[route],
            flash.flash_attention_bwd_dkv.route_launches[route]) == (before[0] + 1, before[1] + 1)
    _, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True)
    ref = flash.flash_attention_backward_reference(q, k, v, o.detach(), lse, do, pad_mask=pad, causal=True)
    torch.cuda.synchronize()
    # fp32 (tf32x3) is fp32-accurate (three TF32 products per product); bf16
    # (wgmma) sums in another order than the plain version, so a rounded
    # entry may land on the neighbouring bf16 value: two bf16 ulps
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7
    for got, want in zip(grads, ref):
        assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    if dtype == torch.bfloat16:
        # against the fp32 backward of the same bf16 values, no worse than 1.5x the plain bf16 version
        exact_in = [t.float() for t in (q, k, v, do)]
        o32, lse32 = flash.flash_attention_reference(*exact_in[:3], pad_mask=pad, causal=True)
        exact = flash.flash_attention_backward_reference(*exact_in[:3], o32, lse32, exact_in[3],
                                                         pad_mask=pad, causal=True)
        for got, plain, want in zip(grads, ref, exact):
            assert (got.float() - want).abs().max() <= 1.5 * (plain.float() - want).abs().max()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")
