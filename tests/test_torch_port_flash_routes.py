"""K1's routes behind one wrapper, on the CPU.

``flash_attention_fwd`` picks the forward kernel's design by the query
length, the head dims and the type alone (``_fwd_route``): ``wide_mma`` for
a ``(d, dv)`` pair outside ``HEAD_DIMS``, else ``split`` for decode attends
(at most 16 query rows), ``wgmma`` for bf16 tiles, ``tf32x3`` (3xTF32 on
``mma.sync``; its arithmetic is emulated in ``test_torch_port_fwd_tf32.py``)
for fp32 tiles; ``wide`` (the first design at the pairs outside
``HEAD_DIMS``) and ``simt`` (the 64 x 64 CUDA-core kernel) are reached only
by name. Every route computes the function of
``flash_attention_reference``. The split route's arithmetic, partials per
split of keys and a merge, is written out in ``flash_attention_split_reference``
and held here against ``flash_attention_reference`` and the JAX package on
live rows: JAX ``flash_attention`` in Pallas interpret mode where its block
gate admits the shape, and the einsum path ``_attention_xla`` at
``q_len = 1``. Inputs come from numpy with a seed. Tolerances: fp32 1e-5
(the same sums in another order), bf16 2e-2 (``p`` rounded to bf16 relative
to each split's maximum instead of the row's). Rows that see no key are
exactly 0 with ``lse`` the mask value in both versions.

The kernels run only on the card: ``test_misaligned_input_is_refused_on_card``
here and ``test_kernel_matches_plain_on_card`` in ``test_torch_port_ops.py``
(every route against the plain version) are marked ``cuda`` and skip
without one; ``python3 chip_smoke.py`` holds every route at the serving and
training shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu_torch.ops import flash_attention as flash

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(rng, b, h, i, j, d, dtype="float32"):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    cast = getattr(torch, dtype)
    return q, k, v, [torch.from_numpy(a).to(cast) for a in (q, k, v)]


def _live(i, j, pad, causal):
    allowed = np.ones((pad.shape[0] if pad is not None else 1, i, j), bool)
    if pad is not None:
        allowed &= ~pad[:, None, :]
    if causal:
        allowed &= np.arange(j)[None, None, :] <= np.arange(i)[None, :, None] + (j - i)
    return allowed.any(-1)  # (b or 1, i)


@pytest.mark.parametrize("i,dtype,route", [
    (1, torch.float32, "split"), (1, torch.bfloat16, "split"),
    (16, torch.float32, "split"), (16, torch.bfloat16, "split"),
    (17, torch.float32, "tf32x3"), (17, torch.bfloat16, "wgmma"),
    (512, torch.float32, "tf32x3"), (512, torch.bfloat16, "wgmma"),
])
def test_fwd_route_table(i, dtype, route):
    assert flash._fwd_route(i, dtype, 112, 112) == route
    assert route in flash.ROUTES


@pytest.mark.parametrize("i,dtype,d,dv,route", [
    (512, torch.float32, 160, 160, "tf32x3"), (512, torch.bfloat16, 160, 160, "wgmma"),
    (1, torch.float32, 160, 160, "split"),
    # every pair outside HEAD_DIMS, any length and type: the image classifier's
    # encoder cross attend, its decoder, MNIST's cross attend, and others
    (512, torch.float32, 261, 261, "wide_mma"), (512, torch.bfloat16, 261, 261, "wide_mma"),
    (1, torch.float32, 1024, 1024, "wide_mma"), (1, torch.bfloat16, 1024, 1024, "wide_mma"),
    (32, torch.float32, 131, 131, "wide_mma"), (17, torch.bfloat16, 64, 96, "wide_mma"),
    (512, torch.float32, 80, 80, "wide_mma"),
])
def test_fwd_route_table_by_head_dims(i, dtype, d, dv, route):
    assert flash._fwd_route(i, dtype, d, dv) == route
    assert ((d, dv) in flash.HEAD_DIMS) == (route != "wide_mma")


def test_cpu_tensors_launch_no_route(rng):
    _, _, _, (q, k, v) = _inputs(rng, 1, 2, 1, 40, 16)
    before = (flash.flash_attention.launches, dict(flash.flash_attention.route_launches),
              flash.flash_attention.kernel_launches)
    flash.flash_attention_fwd(q, k, v, causal=True)
    assert (flash.flash_attention.launches, flash.flash_attention.route_launches,
            flash.flash_attention.kernel_launches) == before
    assert set(flash.flash_attention.route_launches) == set(flash.ROUTES)


# (b, i, j, causal, lengths): lengths[r] keys visible to batch row r (keys past
# it padded); 0 makes a dead row, short lengths leave whole splits empty
SPLIT_CASES = [
    (3, 1, 300, True, [300, 70, 0]),
    (2, 1, 130, False, [1, 129]),
    (2, 5, 200, True, [200, 33]),
    (2, 16, 256, True, [256, 0]),
]


@pytest.mark.parametrize("split", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,i,j,causal,lengths", SPLIT_CASES)
def test_split_reference_matches_plain(rng, b, i, j, causal, lengths, dtype, split):
    _, _, _, (q, k, v) = _inputs(rng, b, 2, i, j, 32, dtype)
    pad = torch.arange(j)[None, :] >= torch.tensor(lengths)[:, None]
    o, lse = flash.flash_attention_split_reference(q, k, v, pad_mask=pad, causal=causal, split=split)
    o_ref, lse_ref = flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=causal)
    live = torch.from_numpy(_live(i, j, pad.numpy(), causal))[:, None, :].expand(b, 2, i)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(o[live].float().numpy(), o_ref[live].float().numpy(), **TOL[dtype])
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(), **TOL["float32"])
    assert (o[~live] == 0).all() and (lse[~live] == flash.MASK_VALUE).all()
    assert (o_ref[~live] == 0).all() and (lse_ref[~live] == flash.MASK_VALUE).all()


@pytest.mark.parametrize("split", [16, 64])
@pytest.mark.parametrize("lengths", [[384, 100, 0], [1, 257, 383]])
def test_split_reference_matches_jax_at_decode(rng, lengths, split):
    # q_len = 1: the JAX package takes its einsum path (the Pallas block gate
    # wants i a multiple of 128), which agrees with flash on live rows
    b, h, j, d = 3, 2, 384, 64
    q, k, v, tensors = _inputs(rng, b, h, 1, j, d)
    pad = np.arange(j)[None, :] >= np.asarray(lengths)[:, None]
    expected = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pad), True, 0.0, None))
    o, lse = flash.flash_attention_split_reference(*tensors, pad_mask=torch.from_numpy(pad),
                                                   causal=True, split=split)
    live = _live(1, j, pad, True)[:, 0]
    np.testing.assert_allclose(o.numpy()[live], expected[live], **TOL["float32"])
    assert (o.numpy()[~live] == 0).all() and (lse.numpy()[~live] == flash.MASK_VALUE).all()


@pytest.mark.parametrize("split", [16, 64])
@pytest.mark.parametrize("i,j,causal", [(128, 384, True), (128, 256, False)])
def test_split_reference_matches_pallas(rng, i, j, causal, split):
    _check_split_against_pallas(rng, i, j, causal, split, 64)


# the symbolic-audio model's head dim (768 channels over 8 heads)
@pytest.mark.parametrize("split", [16, 64])
def test_split_reference_matches_pallas_at_head_dim_96(rng, split):
    _check_split_against_pallas(rng, 128, 384, True, split, 96)


def _check_split_against_pallas(rng, i, j, causal, split, d):
    b, h = 2, 2
    q, k, v, tensors = _inputs(rng, b, h, i, j, d)
    pad = np.zeros((b, j), bool)
    pad[0, :300] = True  # under the causal mask rows 0..43 of batch row 0 see no key
    pad[1, 100:164] = True  # a whole 64-key split padded
    expected = np.asarray(jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad_mask=jnp.asarray(pad), causal=causal))
    o, lse = flash.flash_attention_split_reference(*tensors, pad_mask=torch.from_numpy(pad),
                                                   causal=causal, split=split)
    np.testing.assert_allclose(o.numpy(), expected, atol=2e-5, rtol=2e-5)  # the Pallas test's limit
    live = _live(i, j, pad, causal)[:, None, :].repeat(h, 1)
    assert (o.numpy()[~live] == 0).all() and (lse.numpy()[~live] == flash.MASK_VALUE).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 64])
def test_misaligned_input_is_refused_on_card(cuda_device, i):
    buf = torch.randn(2 * 8 * i * 112 + 1, device=cuda_device).to(torch.bfloat16)
    q = buf[1:].view(2, 8, i, 112)  # contiguous, 2 bytes off a 16-byte boundary
    k = torch.randn(2, 8, 128, 112, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_attention_fwd(q, k, k, causal=True)
