"""Port ops against the JAX package, on the CPU: position/rotary, the plain
attention path against ``_attention_xla``, and the flash kernel's plain
version against JAX ``flash_attention`` in Pallas interpret mode.

Inputs are made with numpy from a seed and fed to both packages. Tolerances:
atol/rtol 1e-5 for position and plain attention (fp32, same arithmetic up to
summation order), 2e-5 for the flash kernel's plain version (the tolerance
``tests/test_flash_attention.py`` holds the Pallas kernel to).

The CUDA kernel itself runs only on the card: ``test_kernel_matches_plain_on_card``
is marked ``cuda`` and skips where there is none; ``python3 chip_smoke.py``
holds the kernel against its plain version at the serving path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu.ops import position as jax_position
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu_torch.ops import flash_attention as flash
from perceiver_io_tpu_torch.ops import position
from perceiver_io_tpu_torch.ops.attention import dot_product_attention

TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(rng, b, h, i, j, d):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_positions_with_shift():
    shift = np.array([[0], [3], [9]], np.int32)
    expected = jax_position.positions(3, 7, shift=jnp.asarray(shift))
    actual = position.positions(3, 7, shift=torch.from_numpy(shift))
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


def test_frequency_encoding_and_rotate_half(rng):
    pos = rng.integers(0, 50, (2, 9))
    expected = jax_position.frequency_position_encoding(jnp.asarray(pos), 8)
    actual = position.frequency_position_encoding(torch.from_numpy(pos), 8)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), **TOL)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        position.rotate_half(torch.from_numpy(x)).numpy(),
        np.asarray(jax_position.rotate_half(jnp.asarray(x))),
    )


@pytest.mark.parametrize("right_align", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_matches_jax(rng, right_align, dtype):
    # head dim 112 with 56 rotated channels, as in the 455M CLM; the query
    # is shorter than the encoding, so right alignment matters
    frq = rng.uniform(0, 30, (2, 10, 56)).astype(np.float32)
    t = rng.standard_normal((2, 3, 6, 112)).astype(np.float32)
    expected = jax_position.RotaryEmbedding(jnp.asarray(frq), right_align=right_align).rotate(
        jnp.asarray(t, dtype)
    )
    rot = position.RotaryEmbedding(torch.from_numpy(frq), right_align=right_align)
    actual = rot.rotate(torch.from_numpy(t).to(getattr(torch, dtype)))
    assert actual.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(
        actual.float().numpy(), np.asarray(expected.astype(jnp.float32)), **tol
    )


@pytest.mark.parametrize(
    "i,j,causal,with_pad,heads_parallel",
    [
        (4, 4, False, False, None),
        (4, 9, False, True, None),
        (4, 9, True, False, None),
        (5, 11, True, True, None),
        (5, 11, True, True, 1),   # head-group serialisation
        (1, 9, True, True, None),  # q_len = 1 decode attend
    ],
)
def test_plain_attention_matches_xla(rng, i, j, causal, with_pad, heads_parallel):
    q, k, v = _qkv(rng, 2, 3, i, j, 8)
    pad = (rng.random((2, j)) < 0.3) if with_pad else None
    expected = _attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if pad is None else jnp.asarray(pad), causal, 0.0, None,
    )
    tq, tk, tv = _t(q, k, v)
    actual = dot_product_attention(
        tq, tk, tv, pad_mask=None if pad is None else torch.from_numpy(pad),
        causal=causal, max_heads_parallel=heads_parallel, impl="xla",
    )
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), **TOL)
    # on CPU tensors "auto" is the plain path too
    auto = dot_product_attention(
        tq, tk, tv, pad_mask=None if pad is None else torch.from_numpy(pad), causal=causal,
    )
    np.testing.assert_array_equal(auto.numpy(), actual.numpy())


# (i, j, causal, with_pad): the CASES of tests/test_flash_attention.py
FLASH_CASES = [
    (128, 128, False, False),
    (128, 384, False, True),
    (128, 128, True, False),
    (128, 384, True, False),
    (256, 640, True, True),
    (128, 896, True, False),
]


@pytest.mark.parametrize("i,j,causal,with_pad", FLASH_CASES)
def test_flash_plain_matches_pallas(rng, i, j, causal, with_pad):
    q, k, v = _qkv(rng, 2, 3, i, j, 64)
    pad = (rng.random((2, j)) < 0.2) if with_pad else None
    expected = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        pad_mask=None if pad is None else jnp.asarray(pad), causal=causal,
    )
    tq, tk, tv = _t(q, k, v)
    before = flash.flash_attention.launches
    actual = dot_product_attention(
        tq, tk, tv, pad_mask=None if pad is None else torch.from_numpy(pad),
        causal=causal, impl="flash",
    )
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), **FLASH_TOL)
    assert flash.flash_attention.launches == before  # no kernel on the CPU


def test_flash_plain_dead_rows_are_zero(rng):
    # rows whose whole causal window is padding: zero output, as the Pallas
    # kernel gives (the einsum path would average the masked keys instead)
    i, j = 128, 384
    q, k, v = _qkv(rng, 2, 2, i, j, 64)
    pad = np.zeros((2, j), bool)
    pad[0, :300] = True  # row r sees cols <= r + 256: rows 0..43 are dead
    expected = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad_mask=jnp.asarray(pad), causal=True,
    )
    tq, tk, tv = _t(q, k, v)
    o, lse = flash.flash_attention_fwd(tq, tk, tv, pad_mask=torch.from_numpy(pad), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(expected), **FLASH_TOL)
    assert (o[0, :, :44] == 0).all() and (o[0, :, 44:].abs().sum(-1) > 0).all()
    assert lse.shape == (2, 2, i) and lse.dtype == torch.float32
    # live rows' logsumexp is the plain einsum's
    s = torch.einsum("bhic,bhjc->bhij", tq, tk)
    allowed = (torch.arange(j)[None, :] <= torch.arange(i)[:, None] + (j - i)) & ~torch.from_numpy(pad)[:, None, None, :]
    ref = torch.logsumexp(s.masked_fill(~allowed, float("-inf")), dim=-1)
    np.testing.assert_allclose(lse[0, :, 44:].numpy(), ref[0, :, 44:].numpy(), **FLASH_TOL)
    np.testing.assert_allclose(lse[1].numpy(), ref[1].numpy(), **FLASH_TOL)


def test_dispatch_rejects_unported_modes(rng):
    q, k, v = _t(*_qkv(rng, 1, 1, 2, 2, 8))
    with pytest.raises(NotImplementedError):
        dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(NotImplementedError):
        dot_product_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        dot_product_attention(q, k, v, impl="einsum")
    with pytest.raises(ValueError):
        flash.flash_attention(q, k[:, :, :1], v[:, :, :1], causal=True)  # j < i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("i,j,d,causal,pads", [
    (512, 1024, 112, True, "random"), (1, 1024, 112, True, "random"),
    (100, 300, 112, False, "random"), (64, 64, 112, True, None),
    (16, 1024, 112, True, "random"), (17, 300, 112, True, "random"),
    (100, 612, 112, True, "random"), (8, 77, 112, False, "random"),
    # keys at and past each batch row's length padded
    (1, 1024, 112, True, [1023, 700, 300, 40]),   # decode: split
    (1, 1024, 112, True, [0, 64, 200, 1024]),     # a dead row and empty splits: split
    (16, 700, 64, True, [700, 600, 20, 0]),       # the split route's largest query
    (100, 612, 112, True, [612, 580, 300, 101]),  # ragged tiles: wgmma in bf16, tf32x3 in fp32
    (512, 1024, 128, True, [1024, 924, 424, 124]),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, i, j, d, causal, pads):
    # through the route the wrapper picks; rows that see no key exactly 0
    # with lse the mask value
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b = 2 if pads in (None, "random") else len(pads)
    q, k, v = (torch.randn(b, 8, n, d, generator=g, device=cuda_device).to(dtype)
               for n in (i, j, j))
    q = q * d**-0.5
    if pads == "random":
        pad = torch.rand(b, j, generator=g, device=cuda_device) < 0.2
    elif pads is not None:
        pad = torch.arange(j, device=cuda_device)[None, :] >= torch.tensor(pads, device=cuda_device)[:, None]
    else:
        pad = None
    route = flash._fwd_route(i, dtype)
    before = dict(flash.flash_attention.route_launches), flash.flash_attention.kernel_launches
    o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=causal)
    o_ref, lse_ref = flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_attention.route_launches[route] == before[0][route] + 1
    assert flash.flash_attention.kernel_launches == before[1] + flash.ROUTE_KERNELS[route]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    live = flash._allowed(q, j, pad, causal).any(-1).expand(b, 8, i)
    assert (o[~live] == 0).all() and (lse[~live] == flash.MASK_VALUE).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")
