"""The port's paged-KV ops against the JAX package, on the CPU.

- ``flat_position_indices``, ``flat_write_indices``, ``quantize_kv``,
  ``scatter_kv`` and ``gather_kv`` equal JAX's bit for bit;
- the gather paths of ``paged_decode_attention`` and
  ``paged_window_attention`` match JAX's over the same plain attend
  (atol/rtol 1e-5);
- K4's plain version, ``ragged_paged_attention_reference``, matches JAX
  ``ragged_paged_attention`` run as JAX's own tests run it on the CPU (the
  Pallas interpreter), for decode rows (q_len 1) and window rows (q_len 4),
  exact and int8 pools, with an idle row and trash planted in the null block
  (atol/rtol 1e-5, the tolerance of ``tests/test_ragged_attention.py``);
- the wrapper's rejections. The kernel itself runs only on the card:
  ``test_kernel_matches_plain_on_card`` is marked ``cuda`` and skips here.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import paged_attention as jax_paged
from perceiver_io_tpu.ops import ragged_attention as jax_ragged
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu_torch.ops import paged_attention as paged
from perceiver_io_tpu_torch.ops.attention import dot_product_attention
from perceiver_io_tpu_torch.ops.ragged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)
H, D, BS, PAGES = 2, 8, 4, 4
# rows: a partial span whose tail pages are unmapped, a full multi-page
# span, an idle row
TABLE = np.array([[1, 2, 0, 0], [3, 4, 5, 6], [0, 0, 0, 0]], np.int32)
LENGTHS = np.array([6, 16, 0], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pool(rng, tokens=7 * BS):
    """Null block + 6 mappable blocks, with trash in the null block."""
    pool_k = rng.normal(size=(tokens, H, D)).astype(np.float32)
    pool_v = rng.normal(size=(tokens, H, D)).astype(np.float32)
    pool_k[:BS] = 1e3
    pool_v[:BS] = -1e3
    return pool_k, pool_v


def _int8_pools(pool_k, pool_v):
    """JAX-quantized pools with garbage bytes and zero scales in the null block."""
    qk, sk = (np.asarray(a) for a in jax_paged.quantize_kv(jnp.asarray(pool_k)))
    qv, sv = (np.asarray(a) for a in jax_paged.quantize_kv(jnp.asarray(pool_v)))
    qk, qv, sk, sv = qk.copy(), qv.copy(), sk.copy(), sv.copy()
    qk[:BS], qv[:BS], sk[:BS], sv[:BS] = 119, -77, 0.0, 0.0
    return qk, qv, sk, sv


def test_flat_indices_match_jax(rng):
    table = rng.integers(0, 9, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        paged.flat_position_indices(_t(table), 4, 18).numpy(),
        np.asarray(jax_paged.flat_position_indices(jnp.asarray(table), 4, 18)),
    )
    positions = rng.integers(0, 20, (3, 2)).astype(np.int32)
    for pos in (positions, positions[:, 0]):
        np.testing.assert_array_equal(
            paged.flat_write_indices(_t(table), _t(pos), 4).numpy(),
            np.asarray(jax_paged.flat_write_indices(jnp.asarray(table), jnp.asarray(pos), 4)),
        )


def test_quantize_kv_matches_jax_bitwise(rng):
    x = rng.normal(size=(5, 3, 16)).astype(np.float32)
    x[0] = 0.0  # a never-written row: scale 0, values 0
    x[1, 0] = np.arange(16) - 7.5  # halfway cases of the 8-bit grid
    q, s = paged.quantize_kv(_t(x))
    jq, js = jax_paged.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (5, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_scatter_and_gather_kv_match_jax_bitwise(rng, quantized):
    tokens = 7 * BS
    pool = rng.normal(size=(tokens, H, D)).astype(np.float32)
    scale = None
    if quantized:
        pool, scale = (np.asarray(a) for a in jax_paged.quantize_kv(jnp.asarray(pool)))
    idx = np.array([[5, 9], [13, 2]], np.int32)
    values = rng.normal(size=(2, 2, H, D)).astype(np.float32)
    t_pool = _t(pool.copy())
    t_scale = None if scale is None else _t(scale.copy())
    out_pool, out_scale = paged.scatter_kv(t_pool, t_scale, _t(idx), _t(values))
    assert out_pool is t_pool and out_scale is t_scale  # in place
    j_pool, j_scale = jax_paged.scatter_kv(
        jnp.asarray(pool), None if scale is None else jnp.asarray(scale), jnp.asarray(idx),
        jnp.asarray(values),
    )
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))
    if quantized:
        np.testing.assert_array_equal(t_scale.numpy(), np.asarray(j_scale))

    flat = paged.flat_position_indices(_t(TABLE), BS, PAGES * BS)
    got = paged.gather_kv(t_pool, flat, t_scale, torch.float32 if quantized else None)
    want = jax_paged.gather_kv(j_pool, jnp.asarray(flat.numpy()), j_scale,
                               jnp.float32 if quantized else None)
    assert got.shape == (3, H, PAGES * BS, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attends(causal):
    def jax_attend(q, k, v, pad_mask, deterministic):
        return _attention_xla(q, k, v, pad_mask, causal, 0.0, None)

    def port_attend(q, k, v, pad_mask):
        return dot_product_attention(q, k, v, pad_mask=pad_mask, causal=causal, impl="xla")

    return jax_attend, port_attend


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_paged_gather_paths_match_jax(rng, quantized):
    pool_k, pool_v = _pool(rng)
    scales = {}
    if quantized:
        pool_k, pool_v, sk, sv = _int8_pools(pool_k, pool_v)
        scales = dict(scale_k=sk, scale_v=sv)
    j_scales = {k: jnp.asarray(v) for k, v in scales.items()}
    t_scales = {k: _t(v) for k, v in scales.items()}
    n = PAGES * BS
    # decode rows: the pad mask hides positions past each row's length
    jax_attend, port_attend = _attends(causal=False)
    q = rng.normal(size=(3, H, 1, D)).astype(np.float32)
    future = np.arange(n)[None, :] > (LENGTHS - 1)[:, None]
    want = jax_paged.paged_decode_attention(
        jax_attend, jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(TABLE), block_size=BS, n=n, pad_mask=jnp.asarray(future), **j_scales,
    )
    got = paged.paged_decode_attention(
        port_attend, _t(q), _t(pool_k), _t(pool_v), _t(TABLE), block_size=BS, n=n,
        pad_mask=_t(future), **t_scales,
    )
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], **TOL)
    # window rows: 4 latent queries, right-aligned causal, front pads
    jax_attend, port_attend = _attends(causal=True)
    q = rng.normal(size=(3, H, 4, D)).astype(np.float32)
    pad_count = np.array([n - 6, 0, n - 5], np.int32)
    want = jax_paged.paged_window_attention(
        jax_attend, jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(TABLE), block_size=BS, n=n, pad_count=jnp.asarray(pad_count), **j_scales,
    )
    got = paged.paged_window_attention(
        port_attend, _t(q), _t(pool_k), _t(pool_v), _t(TABLE), block_size=BS, n=n,
        pad_count=_t(pad_count), **t_scales,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("q_len", [1, 4], ids=["decode_row", "window_row"])
def test_ragged_reference_matches_jax_kernel(rng, q_len, quantized):
    pool_k, pool_v = _pool(rng)
    q = rng.normal(size=(3, H, q_len, D)).astype(np.float32)
    scales = {}
    if quantized:
        pool_k, pool_v, sk, sv = _int8_pools(pool_k, pool_v)
        scales = dict(scale_k=sk, scale_v=sv)
    want = np.asarray(jax_ragged.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(TABLE),
        jnp.asarray(LENGTHS), block_size=BS, **{k: jnp.asarray(v) for k, v in scales.items()},
    ))
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(
        _t(q), _t(pool_k), _t(pool_v), _t(TABLE), _t(LENGTHS), block_size=BS,
        **{k: _t(v) for k, v in scales.items()},
    )
    assert ragged_paged_attention.launches == before  # the plain version, on the CPU
    assert got.shape == (3, H, q_len, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[2] == 0).all()  # the idle row
    # the null block's trash never surfaces: the live rows match a pool
    # whose null block is zero
    pool_k[:BS] = pool_v[:BS] = 0
    clean = ragged_paged_attention_reference(
        _t(q), _t(pool_k), _t(pool_v), _t(TABLE), _t(LENGTHS), block_size=BS,
        **{k: _t(v) for k, v in scales.items()},
    )
    np.testing.assert_array_equal(clean.numpy(), got.numpy())


def test_wrapper_rejections(rng):
    pool_k, pool_v = (_t(a) for a in _pool(rng))
    q = _t(rng.normal(size=(3, H, 1, D)).astype(np.float32))
    table, lengths = _t(TABLE), _t(LENGTHS)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ragged_paged_attention(q.double(), pool_k.double(), pool_v.double(), table, lengths,
                               block_size=BS)
    with pytest.raises(TypeError, match="q's type"):
        ragged_paged_attention(q, pool_k.bfloat16(), pool_v.bfloat16(), table, lengths,
                               block_size=BS)
    with pytest.raises(TypeError, match="int8"):
        scale = torch.ones(pool_k.shape[0], H, 1)
        ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=BS,
                               scale_k=scale, scale_v=scale)
    with pytest.raises(ValueError, match="come together"):
        ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=BS,
                               scale_k=torch.ones(pool_k.shape[0], H, 1))
    with pytest.raises(ValueError, match="pools"):
        ragged_paged_attention(q[..., :4], pool_k, pool_v, table, lengths, block_size=BS)
    with pytest.raises(ValueError, match="lengths"):
        ragged_paged_attention(q, pool_k, pool_v, table, lengths[:2], block_size=BS)
    with pytest.raises(TypeError, match="integer"):
        ragged_paged_attention(q, pool_k, pool_v, table.float(), lengths, block_size=BS)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q_len", [1, 512], ids=["decode", "window"])
def test_kernel_matches_plain_on_card(cuda_device, q_len, layout):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    h, d, bs, pages = 8, 112, 16, 64
    lengths = torch.tensor([1023, 700, 300, 40, 1, 0, 512, 17] if q_len == 1 else
                           [520, 600, 700, 800, 900, 1000, 1024, 777], device=cuda_device)
    used = (lengths + bs - 1) // bs
    blocks = torch.randperm(int(used.sum()), generator=g, device=cuda_device) + 1
    table = torch.zeros(8, pages, dtype=torch.int32, device=cuda_device)
    start = 0
    for r, u in enumerate(used.tolist()):
        table[r, :u] = blocks[start:start + u].int()
        start += u
    tokens = (int(used.sum()) + 1) * bs
    dtype = torch.bfloat16 if layout == "bfloat16" else torch.float32
    q = (torch.randn(8, h, q_len, d, generator=g, device=cuda_device) * d**-0.5).to(dtype)
    pool_k, pool_v = (torch.randn(tokens, h, d, generator=g, device=cuda_device) for _ in "kv")
    pool_k[:bs], pool_v[:bs] = 1e3, -1e3  # trash in the null block
    scales = {}
    if layout == "int8":
        pool_k, sk = paged.quantize_kv(pool_k)
        pool_v, sv = paged.quantize_kv(pool_v)
        sk[:bs] = sv[:bs] = 0.0
        scales = dict(scale_k=sk, scale_v=sv)
    else:
        pool_k, pool_v = pool_k.to(dtype), pool_v.to(dtype)
    before = ragged_paged_attention.launches
    o = ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=bs, **scales)
    ref = ragged_paged_attention_reference(q, pool_k, pool_v, table, lengths, block_size=bs,
                                           **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    tol = 2e-2 if layout == "bfloat16" else 1e-4
    assert (o.float() - ref.float()).abs().max().item() <= tol
    assert (o[lengths <= 0] == 0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")
