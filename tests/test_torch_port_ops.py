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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu.ops import position as jax_position
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu_torch.ops import flash_attention as flash
from perceiver_io_tpu_torch.ops import position
from perceiver_io_tpu_torch.ops import attention
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


# JAX's auto dispatch by shape: (head dim, q/k/v types, causal, j < i); a
# head dim given as (d, dv) sets v's apart from q's and k's
DISPATCH_CASES = [
    (d, types, causal, short)
    for d in (16, 32, 80, 96, 112)
    for types in (("float32",) * 3, ("bfloat16",) * 3, ("float32", "bfloat16", "float32"), ("float16",) * 3)
    for causal, short in ((True, False), (True, True), (False, True))
] + [
    (dims, types, causal, short)
    for dims in ((64, 96), (96, 64), (112, 128), (64, 16), (16, 64), (32, 96), (32, 160))
    for types in (("float32",) * 3, ("bfloat16",) * 3)
    for causal, short in ((False, False), (True, False), (True, True))
] + [
    # the text classifier at the JAX CLI's defaults (160 on the tile routes);
    # the image classifier's encoder cross attend at deepmind/vision-perceiver-fourier
    # width, its decoder, and MNIST's cross attend (the wide_mma route)
    (d, types, causal, short)
    for d in (160, 261, 1024, 131)
    for types in (("float32",) * 3, ("bfloat16",) * 3)
    for causal, short in ((False, False), (True, False), (True, True))
]


@pytest.mark.parametrize("d,types,causal,short", DISPATCH_CASES)
def test_auto_dispatch_follows_jax_supported(rng, d, types, causal, short):
    # lengths JAX's block picker takes (multiples of 128), so only the other
    # reasons decide: where JAX's kernel refuses, auto takes the plain path
    # and flash raises; where it takes the shape, auto launches K1: on the
    # tile routes where they instantiate the (d, dv) pair, else on wide_mma
    i, j = (256, 128) if short else (128, 256)
    d, dv = d if isinstance(d, tuple) else (d, d)
    tile_route = (d, dv) in flash.HEAD_DIMS
    wide = [flash._fwd_route(n, getattr(torch, types[0]), d, dv) == "wide_mma" for n in (1, i)]
    assert wide == [not tile_route] * 2
    assert (flash._bwd_route(getattr(torch, types[0]), d, dv) == "wide_mma") == (not tile_route)
    shapes = [(1, 2, i, d), (1, 2, j, d), (1, 2, j, dv)]
    jq, jk, jv = (jnp.zeros(shape, getattr(jnp, t)) for shape, t in zip(shapes, types))
    jax_takes = jax_flash.supported(jq, jk, jv, causal=causal)
    args = (*shapes, *(getattr(torch, t) for t in types), causal)
    q, k, v = (torch.zeros(shape, dtype=getattr(torch, t)) for shape, t in zip(shapes, types))
    if dv != d:
        # v of its own head dim: K1 wherever JAX's kernel takes the attend
        # (the masked LM's (32, 96) and (32, 160) on the tile routes, the
        # rest on wide_mma; the (64, 96) rows hold (1, 2, 128, 64) q/k against a
        # (1, 2, 256, 96) v, which once passed)
        assert jax_takes == (min(d, dv) >= 32 and not (causal and short))
        assert attention.kernel_takes(*args) is jax_takes
        return
    if not jax_takes:
        assert attention.kernel_refusal(*args) is not None
        assert attention.kernel_takes(*args) is False
        with pytest.raises(ValueError, match="unsupported for shapes"):
            dot_product_attention(q, k, v, causal=causal, impl="flash")
    else:
        assert attention.kernel_refusal(*args) is None and attention.kernel_takes(*args) is True
    one_type = len(set(types)) == 1 and types[0] != "float16"
    assert jax_takes == (d >= 32 and one_type and not (causal and short))  # the table spans JAX's reasons
    if not jax_takes and one_type:
        # auto on the CPU: the plain path, as JAX's einsum path
        q, k, v = (torch.from_numpy(a).to(q.dtype) for a in _qkv(rng, 1, 2, i, j, d))
        out = dot_product_attention(q, k, v, causal=causal)
        want = _attention_xla(*(jnp.asarray(t.float().numpy()).astype(getattr(jnp, types[0]))
                                for t in (q, k, v)), None, causal, 0.0, None)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   **(TOL if types[0] == "float32" else dict(atol=2e-2, rtol=2e-2)))


def test_head_dim_tables_match_the_kernels():
    # HEAD_DIMS and SIMT_HEAD_DIMS are the (d, dv) pairs each K1-K3 route's
    # dispatch instantiates: the split, wgmma and tf32x3 routes expand the
    # pair list of csrc/head_dims.cuh there (it holds (160, 160)), the simt
    # kernels switch on d alone (v of q's head dim), and the wide and
    # wide_mma kernels take d and dv at run time (no pair list, no switch).
    # K2/K3 share K1's tables. K4's routes keep one head dim
    # (*_supports_head_dim).
    import re
    from pathlib import Path

    from perceiver_io_tpu_torch.ops import ragged_attention

    csrc = Path(flash.__file__).resolve().parent.parent / "csrc"
    listed = tuple((int(a), int(b)) for a, b in
                   re.findall(r"X\((\d+), (\d+)\)", (csrc / "head_dims.cuh").read_text()))
    assert listed == flash.HEAD_DIMS and (160, 160) in listed
    for name in ("flash_attention_fwd_wide", "flash_attention_bwd_wide", "flash_attention_fwd_wide_mma",
                 "flash_attention_bwd_wide_mma"):
        text = (csrc / f"{name}.cu").read_text()
        header = '#include "tf32x3.cuh"' if name.endswith("_mma") else '#include "wide.cuh"'
        assert header in text and '#include "head_dims.cuh"' not in text, name
        assert "FLASH_HEAD_DIM_PAIRS" not in text and not re.search(r"case \d+:", text), name
    group = re.search(r"constexpr int GROUP = (\d+);", (csrc / "wide.cuh").read_text()).group(1)
    assert int(group) == flash.WIDE_GROUP
    # the wide_mma kernels' tiles are the constants its plan uses
    text = (csrc / "flash_attention_bwd_wide_mma.cu").read_text()
    consts = {name: int(n) for name, n in re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}
    assert consts == {"GROUP": flash.WIDE_MMA_GROUP, "CHUNK": flash.WIDE_MMA_CHUNK, "KEYS": flash.WIDE_MMA_KEYS,
                      "KEYS_SMALL": flash.WIDE_MMA_KEYS_SMALL, "ROWS_BF16": flash.WIDE_MMA_ROWS[torch.bfloat16],
                      "ROWS_FP32": flash.WIDE_MMA_ROWS[torch.float32], "ROWS_SMALL": flash.WIDE_MMA_ROWS_SMALL}
    assert f"to {flash.WIDE_MMA_FILL} blocks" in text
    # and K1's: the tiles its plan uses, beside the block's warps (tf32x3.cuh's WARPS)
    text = (csrc / "flash_attention_fwd_wide_mma.cu").read_text()
    consts = {name: int(n) for name, n in re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}
    assert consts == {"GROUP": flash.WIDE_MMA_GROUP, "CHUNK": flash.WIDE_MMA_CHUNK, "KEYS": flash.WIDE_MMA_KEYS,
                      "KEYS_SMALL": flash.WIDE_MMA_KEYS_SMALL, "ROWS_BF16": flash.WIDE_MMA_FWD_ROWS[torch.bfloat16],
                      "ROWS_FP32": flash.WIDE_MMA_FWD_ROWS[torch.float32], "ROWS_SMALL": flash.WIDE_MMA_ROWS_SMALL}
    assert f"whole waves of {flash.WIDE_MMA_FWD_WAVE} blocks" in text and '#include "wide_mma.cuh"' in text
    warps = re.search(r"^constexpr int WARPS = (\d+);", (csrc / "tf32x3.cuh").read_text(), re.M).group(1)
    assert int(warps) == flash.WIDE_MMA_WARPS
    for name in ("flash_attention_fwd_split", "flash_attention_fwd_wgmma", "flash_attention_fwd_tf32",
                 "flash_attention_bwd_wgmma", "flash_attention_bwd_tf32"):
        text = (csrc / f"{name}.cu").read_text()
        assert '#include "head_dims.cuh"' in text, name
        # the dispatch expands the list once, and no other head dim
        assert text.count("FLASH_HEAD_DIM_PAIRS(") == 1, name
        assert not re.search(r"case \d+:", text), name
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        text = (csrc / f"{name}.cu").read_text()
        dims = tuple(int(x) for x in re.findall(r"case (\d+): return dispatch_mask", text))
        assert tuple((x, x) for x in dims) == flash.SIMT_HEAD_DIMS, name
        assert "FLASH_HEAD_DIM_PAIRS" not in text, name
    for dims, names in (
        (ragged_attention.HEAD_DIMS, ("ragged_paged_attention_split", "ragged_paged_attention_tc")),
        (ragged_attention.SIMT_HEAD_DIMS, ("ragged_paged_attention",)),
    ):
        for name in names:
            body = re.search(r"supports_head_dim\(int d\) \{\s*return ([^;]*);",
                             (csrc / f"{name}.cu").read_text()).group(1)
            assert tuple(int(x) for x in re.findall(r"d == (\d+)", body)) == dims, name


def test_dispatch_rejects_unported_modes(rng):
    q, k, v = _t(*_qkv(rng, 1, 1, 2, 2, 8))
    # ring is ported: without a seq mesh it warns and takes the plain path, as JAX's
    with pytest.warns(UserWarning, match="seq"):
        out = dot_product_attention(q, k, v, impl="ring")
    torch.testing.assert_close(out, dot_product_attention(q, k, v, impl="xla"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="dropout"):  # JAX's refusal: the kernel has no dropout
        dot_product_attention(q, k, v, dropout_rate=0.1, impl="flash")
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
    route = flash._fwd_route(i, dtype, d, d)
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
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# the widths this slice's families put on K1-K3: the text classifier at the
# JAX CLI's defaults (160, the tile routes' pair) and the image classifier's
# MNIST cross attend (131), its encoder cross attend at
# deepmind/vision-perceiver-fourier width (261) and its decoder (1024), all
# on the wide_mma route but 160
@pytest.mark.parametrize("d", [160, 131, 261, 1024])
def test_flash_plain_versions_match_pallas_at_the_classifiers_head_dims(rng, d):
    i, j = 128, 256
    q = rng.standard_normal((2, 1, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((2, 1, j, d)).astype(np.float32)
    v = rng.standard_normal((2, 1, j, d)).astype(np.float32)
    cot = rng.standard_normal((2, 1, i, d)).astype(np.float32)
    pad = np.zeros((2, j), bool)
    pad[0, 200:] = True
    pad[1, :] = True  # every key padded: batch row 1's rows are all dead

    def jax_out(q, k, v):
        return jax_flash.flash_attention(q, k, v, pad_mask=jnp.asarray(pad), causal=False)

    want = jax.jit(jax_out)(q, k, v)
    want_grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_out(q, k, v) * cot), argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, pad_mask=torch.from_numpy(pad))
    o.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
    assert (o[1] == 0).all() and (tq.grad[1] == 0).all() and (tk.grad[0, :, 200:] == 0).all()
    assert flash._fwd_route(i, torch.float32, d, d) == ("tf32x3" if d == 160 else "wide_mma")


def test_flash_plain_versions_match_pallas_causal_at_an_odd_head_dim(rng):
    """The wide_mma route's causal case at an odd head dim (131, MNIST's): the
    plain forward and backward against the Pallas kernels, right-aligned
    over j > i, with left pads that leave the first query rows of batch row
    0 dead and batch row 1 all pad."""
    d, i, j = 131, 128, 256
    q = rng.standard_normal((2, 2, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((2, 2, j, d)).astype(np.float32)
    v = rng.standard_normal((2, 2, j, d)).astype(np.float32)
    cot = rng.standard_normal((2, 2, i, d)).astype(np.float32)
    pad = np.zeros((2, j), bool)
    pad[0, :150] = True  # query row r sees keys 150..r + 128: rows 0..21 dead
    pad[1, :] = True

    def jax_out(q, k, v):
        return jax_flash.flash_attention(q, k, v, pad_mask=jnp.asarray(pad), causal=True)

    want = jax.jit(jax_out)(q, k, v)
    want_grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_out(q, k, v) * cot), argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, pad_mask=torch.from_numpy(pad), causal=True)
    o.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
    assert (o[1] == 0).all() and (o[0, :, :22] == 0).all() and (o[0, :, 22:] != 0).any(-1).all()
    assert (tq.grad[0, :, :22] == 0).all() and (tk.grad[0, :, :150] == 0).all()
    assert flash._fwd_route(i, torch.float32, d, d) == "wide_mma"
