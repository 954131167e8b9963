"""K1's ``tf32x3`` route (``csrc/flash_attention_fwd_tf32.cu``), on the CPU.

fp32 queries of more than 16 rows take it. Its arithmetic is emulated here
in plain torch (``tf32x3_forward``), in the kernel's own order: each 64-key
tile cut into two halves of 32 keys, one per warp of a 16-row group, each
half keeping its own online-softmax state (running max, row sum, ``p . v``
accumulator, rescaled by ``exp(m_old - m_new)`` per tile) with both
products in 3xTF32 (``tests/_torch_port_tf32.py``), and the two states
merged at the end with weights selected to 0 for a half that saw no key.
Masks are selects; a row that sees no key gets ``o = 0`` and
``lse = MASK_VALUE`` exactly. Each 3xTF32 term is taken exactly here and
the exponentials are torch's, so the emulation holds the algorithm (tiles,
halves, rescales, merge, operand splits); the card's own rounding (the
tensor cores' sums, the fast exponentials) is held by ``chip_smoke.py``'s
``kernel`` phase. The emulation is held against the JAX package's K1, the
Pallas ``_forward`` in interpret mode, on padded causal cases with dead
rows at 1e-5 abs in ``o`` and ``lse`` on live rows (measured on the CPU:
6.0e-7 at most; both sides are fp32-accurate, 3xTF32 drops ~2^-21
relative per product), and against the plain version on ragged shapes and
the kernel's head dims.

The wrapper's refusals (a type, row count or base the route does not take)
raise before the route's library loads, so they are pinned here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu_torch.ops import flash_attention as flash
from tests._torch_port_tf32 import mm3

TILE, HALF = 64, 32
NEG = float("-inf")


def tf32x3_forward(q, k, v, pad, causal):
    """``(o, lse)`` of K1 as the ``tf32x3`` kernel computes it."""
    b, h, i, d = q.shape
    j = k.shape[2]
    allowed = flash._allowed(q, j, pad, causal).expand(b, h, i, j)
    states = []
    for c_half in (0, HALF):  # the two warps of a 16-row group
        m = torch.full((b, h, i, 1), NEG)
        l, acc = torch.zeros(b, h, i, 1), torch.zeros(b, h, i, d)
        for c0 in range(c_half, j, TILE):
            cols = slice(c0, c0 + HALF)
            ok = allowed[..., cols]
            s = torch.where(ok, mm3(q, k[:, :, cols].transpose(-1, -2)), NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.where(m == m_new, 1.0, torch.exp(m - m_new))  # 1 while nothing is seen
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm3(p, v[:, :, cols])
            m = m_new
        states.append((m, l, acc))
    (ma, la, acca), (mb, lb, accb) = states
    mx = torch.maximum(ma, mb)
    wa = torch.where(ma == NEG, 0.0, torch.exp(ma - mx))
    wb = torch.where(mb == NEG, 0.0, torch.exp(mb - mx))
    l = la * wa + lb * wb
    seen = l > 0
    inv = torch.where(seen, 1.0 / torch.where(seen, l, 1.0), 0.0)
    o = (acca * wa + accb * wb) * inv
    lse = torch.where(seen, mx + torch.log(torch.where(seen, l, 1.0)), flash.MASK_VALUE)[..., 0]
    return o, lse


def _inputs(rng, b, h, i, j, d):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    return q, k, v


def _live(q, j, pad, causal):
    b, h, i, _ = q.shape
    return flash._allowed(q, j, pad, causal).any(-1).expand(b, h, i)


# (i, j, left pads of the two batch rows): the causal mask with pads leaves
# rows 0..43 of batch row 0 dead in the first case, rows 0..65 in the second
@pytest.mark.parametrize("i,j,pads", [(128, 384, [300, 7]), (256, 640, [450, 0])])
def test_tf32x3_forward_matches_pallas(rng, i, j, pads):
    b, h, d = 2, 2, 64
    q, k, v = _inputs(rng, b, h, i, j, d)
    pad = np.arange(j)[None, :] < np.asarray(pads)[:, None]
    pad[1] |= rng.random(j) < 0.2
    forward = jax.jit(jax_flash._forward, static_argnums=(4,))
    o_jax, lse_jax = forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pad.astype(np.float32)), True)
    o_jax, lse_jax = np.asarray(o_jax), np.asarray(lse_jax)[..., 0]
    tq, tk, tv, tpad = (torch.from_numpy(a) for a in (q, k, v, pad))
    o, lse = tf32x3_forward(tq, tk, tv, tpad, True)
    live = _live(tq, j, tpad, True)
    assert (~live).sum() > 0 and live[1].all()
    np.testing.assert_allclose(o[live].numpy(), o_jax[live.numpy()], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse[live].numpy(), lse_jax[live.numpy()], atol=1e-5, rtol=0)
    assert (o[~live] == 0).all() and (lse[~live] == flash.MASK_VALUE).all()


# ragged tiles and halves (i, j not multiples of 64; j < 32), the kernel's
# head dims, with and without the causal mask
@pytest.mark.parametrize("i,j,d,causal", [
    (100, 300, 112, True), (17, 20, 64, True), (70, 90, 128, False), (33, 612, 112, True),
    (100, 300, 96, True), (70, 90, 96, False),
])
def test_tf32x3_forward_matches_plain(rng, i, j, d, causal):
    b, h = 3, 2
    tq, tk, tv = (torch.from_numpy(a) for a in _inputs(rng, b, h, i, j, d))
    tpad = torch.from_numpy(rng.random((b, j)) < 0.3)
    tpad[0, : j - 5] = True  # row 0 sees at most the last five keys: its first rows are dead
    o, lse = tf32x3_forward(tq, tk, tv, tpad, causal)
    o_ref, lse_ref = flash.flash_attention_reference(tq, tk, tv, pad_mask=tpad, causal=causal)
    live = _live(tq, j, tpad, causal)
    np.testing.assert_allclose(o[live].numpy(), o_ref[live].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(), atol=1e-5, rtol=0)
    assert (o[~live] == 0).all() and (lse[~live] == flash.MASK_VALUE).all()
    assert (o_ref[~live] == 0).all() and (lse_ref[~live] == flash.MASK_VALUE).all()


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
def no_library(monkeypatch):
    """Loading a route's library fails the test: a refusal must come first."""
    def load(route):
        raise AssertionError(f"the {route} library was loaded before the refusal")

    monkeypatch.setattr(flash, "_fwd_kernel", load)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied onto a base one element (2 or 4 bytes) off the allocation's."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t)
    out.copy_(t)
    return out


# (route, the type it takes, the one it refuses or None, query rows)
@pytest.mark.parametrize("route,dtype,wrong,i", [
    ("tf32x3", torch.float32, torch.bfloat16, 64),
    ("wgmma", torch.bfloat16, torch.float32, 64),
    ("split", torch.bfloat16, None, 1),
    ("split", torch.float32, None, 16),
])
def test_fwd_route_refuses_before_loading(rng, no_library, route, dtype, wrong, i):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(rng, 1, 2, i, 128, 64))
    if wrong is not None:
        with pytest.raises(TypeError, match=str(dtype).split(".")[-1]):
            flash._fwd_launch(route, q.to(wrong), k.to(wrong), v.to(wrong), None, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash._fwd_launch(route, _misaligned(q), k, v, None, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash._fwd_launch(route, q, k, _misaligned(v), None, True)
    if route == "split":
        tall = torch.zeros(1, 2, flash.SPLIT_MAX_ROWS + 1, 64, dtype=dtype)
        with pytest.raises(ValueError, match="query rows"):
            flash._fwd_launch(route, tall, k, v, None, True)
    with pytest.raises(AssertionError, match="loaded"):  # aligned and of its type: it would load
        flash._fwd_launch(route, q, k, v, None, True)
