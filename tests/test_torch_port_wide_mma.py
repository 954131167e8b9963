"""The ``wide_mma`` routes of K1, K2 and K3 on the CPU: their plans.

``_wide_mma_plan`` sizes both launches of the route that takes every
``(d, dv)`` pair outside ``HEAD_DIMS`` (``csrc/flash_attention_bwd_wide_mma.cu``):
the query rows of a tile, K2's column groups of dq and its key splits, and
K3's column groups over dk and dv. The kernels check the plan they are
given; these tests check that it covers the work: every key tile in
exactly one split (none empty), every column of dq, dk and dv in exactly
one group, and K2's grid filled to ``WIDE_MMA_FILL`` blocks a batch row
where the key tiles allow.

K2 writes one fp32 partial dq per split and a second launch sums them in
split order. That sum, taken here with the plain version over each
split's keys, is held against ``jax.grad`` of the JAX ``flash_attention``
(the Pallas kernels in interpret mode) at a small odd head dim, in fp32 at
1e-5 of dq's largest entry.

K1's ``_wide_mma_fwd_plan`` (``csrc/flash_attention_fwd_wide_mma.cu``)
sizes its launch: the query rows and keys of a tile, the column blocks
(one where a warp holds its whole output row, else as many as 8 warps of
``WIDE_MMA_GROUP`` columns force) and the key splits whose fp32 partials a
merge launch joins. The tests check that every key tile falls in exactly one
non-empty split, every output column in exactly one warp's columns, and the
grid gives a batch row whole waves of ``WIDE_MMA_FWD_WAVE`` blocks where the
key tiles allow. The plain split-and-merge over the plan's key ranges
(``flash_attention_wide_mma_reference``) is held against the JAX forward:
the Pallas ``_forward`` in interpret mode at an odd head dim, causal with
pads and dead rows, o and lse at 1e-5 in fp32; and, at ``i <= 16`` (where
the Pallas block gate refuses the shape), JAX's einsum path.

The kernels run only on the card: ``python3 chip_smoke.py`` (phases
``kernel`` and ``k23`` and the classifiers' fits) holds them against their
plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu_torch.ops import flash_attention as flash

DTYPES = (torch.float32, torch.bfloat16)
# (i, j, h, d, dv): the image encoder's cross attend, its decoder's one
# query, MNIST's cross attend, the smoke's causal case at an odd head dim,
# a pair with v wider than one group and one with q/k wider
PLAN_SHAPES = [
    (512, 50176, 1, 261, 261), (1, 512, 1, 1024, 1024), (32, 784, 1, 131, 131), (100, 300, 2, 131, 131),
    (70, 130, 1, 64, 1024), (5, 300, 2, 300, 40),
] + [(i, 300, 2, 131, 131) for i in range(1, 71)] + [(i, 700, 1, 545, 96) for i in (1, 16, 17, 70)]


def _key_ranges(plan, j):
    tiles = -(-j // plan.dq_keys)
    per = plan.dq_tiles_per_split
    return tiles, [(s * per, min((s + 1) * per, tiles)) for s in range(plan.dq_splits)]


def _covered_once(ranges, n):
    hits = np.zeros(n, int)
    for a, b in ranges:
        hits[a:b] += 1
    return bool((hits == 1).all())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("i,j,h,d,dv", PLAN_SHAPES)
def test_plan_covers_every_key_tile_and_column_once(i, j, h, d, dv, dtype):
    plan = flash._wide_mma_plan(i, j, h, d, dv, dtype)
    small = i <= flash.WIDE_MMA_ROWS_SMALL
    assert plan.rows == (flash.WIDE_MMA_ROWS_SMALL if small else flash.WIDE_MMA_ROWS[dtype])
    assert plan.dq_keys == (flash.WIDE_MMA_KEYS_SMALL if small and dtype == torch.bfloat16 else flash.WIDE_MMA_KEYS)
    # K2: every key tile in exactly one split, none empty
    tiles, ranges = _key_ranges(plan, j)
    assert all(b > a for a, b in ranges) and _covered_once(ranges, tiles)
    # its grid fills a batch row's blocks up to the key tiles it has
    blocks = -(-i // plan.rows) * plan.dq_groups * h
    assert blocks * plan.dq_splits >= min(flash.WIDE_MMA_FILL, blocks * tiles)
    # every column of dq, dk and dv in exactly one group of at most GROUP
    for width, groups in ((d, plan.dq_groups), (d, plan.dkv_groups), (dv, plan.dkv_groups)):
        cols = flash._wide_mma_columns(width, groups)
        assert _covered_once(cols, width)
        assert all(b - a <= flash.WIDE_MMA_GROUP for a, b in cols)
    assert plan.dq_groups == -(-d // flash.WIDE_MMA_GROUP)
    assert plan.dkv_groups == max(plan.dq_groups, -(-dv // flash.WIDE_MMA_GROUP))
    # whole rows are staged where both widths fit one group, which K3 then computes the scores once for
    assert plan.fused == (d <= flash.WIDE_MMA_GROUP and dv <= flash.WIDE_MMA_GROUP)
    assert not plan.fused or plan.dkv_groups == 1


def test_plan_at_the_image_classifier():
    # the encoder's cross attend: one group (the scores once for dk and dv),
    # 64 (bf16) or 32 (fp32) query rows a tile; the decoder's one query:
    # 16-row tiles, four groups of 256 columns
    enc = flash._wide_mma_plan(512, 50176, 1, 261, 261, torch.bfloat16)
    assert (enc.rows, enc.dq_groups, enc.dkv_groups, enc.fused) == (64, 1, 1, True)
    assert enc.dq_splits * 512 // 64 >= flash.WIDE_MMA_FILL
    assert flash._wide_mma_plan(512, 50176, 1, 261, 261, torch.float32).rows == 32
    dec = flash._wide_mma_plan(1, 512, 1, 1024, 1024, torch.bfloat16)
    assert (dec.rows, dec.dq_keys, dec.dq_groups, dec.dkv_groups, dec.fused) == (16, 128, 4, 4, False)
    assert flash._wide_mma_columns(1024, 4) == ((0, 256), (256, 512), (512, 768), (768, 1024))


def _split_sum_dq(q, k, v, lse, delta, do, pad, causal, plan):
    """dq as K2 forms it: the plain dq over each split's keys (the others
    masked as pad), summed in split order in fp32."""
    j = k.shape[2]
    _, ranges = _key_ranges(plan, j)
    total = torch.zeros(q.shape, dtype=torch.float32)
    for a, b in ranges:
        outside = torch.ones(j, dtype=torch.bool)
        outside[a * plan.dq_keys:b * plan.dq_keys] = False
        split_pad = outside[None].expand(q.shape[0], j) | pad
        total += flash.flash_attention_bwd_dq_reference(q, k, v, lse, delta, do, pad_mask=split_pad,
                                                        causal=causal).float()
    return total


@pytest.mark.parametrize("causal", [False, True])
def test_split_sum_of_dq_matches_pallas(rng, causal):
    b, h, i, j, d = 2, 2, 512, 640, 37
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    do = rng.standard_normal((b, h, i, d)).astype(np.float32)
    pad = np.zeros((b, j), bool)
    pad[0, :200] = True  # causal: query row r sees keys 200..r + 128: rows 0..71 dead
    pad[1, 600:] = True
    plan = flash._wide_mma_plan(i, j, h, d, d, torch.float32)
    assert plan.dq_splits > 1 and plan.dq_tiles_per_split > 1  # sums over splits of several tiles

    def loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, pad_mask=jnp.asarray(pad), causal=causal)
        return jnp.sum(out * jnp.asarray(do))

    want = np.asarray(jax.jit(jax.grad(loss))(q, k, v))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tpad = torch.from_numpy(pad)
    o, lse = flash.flash_attention_fwd(tq, tk, tv, pad_mask=tpad, causal=causal)
    delta = flash.attention_delta(o, tdo)
    got = _split_sum_dq(tq, tk, tv, lse, delta, tdo, tpad, causal, plan).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), f"{err} of {np.abs(want).max()}"


# K1's plan: the wide pairs above, the 16-row switch around i = 16, outputs
# wider than one warp's columns (the decoder's 1024, one wider than a
# block's 8 warps) and q/k wider than one group
FWD_PLAN_SHAPES = PLAN_SHAPES[:6] + [(i, 300, 2, 261, 261) for i in (1, 15, 16, 17, 64, 65)] + [
    (1, 512, 4, 1024, 1024), (16, 4096, 1, 64, 2200), (17, 100, 2, 300, 300), (3, 50176, 1, 5000, 20)]


def _fwd_warp_columns(dv, plan):
    """The ``[start, stop)`` output columns each warp of each column block
    accumulates: the whole row for one warp where ``plan.fused``, else
    each block's nominal width cut into ``WIDE_MMA_WARPS`` runs."""
    if plan.fused:
        return ((0, dv),)
    warp = flash._wide_mma_columns(flash._round16(-(-dv // plan.col_blocks)), flash.WIDE_MMA_WARPS)
    return tuple((min(b0 + w0, b1), min(b0 + w1, b1))
                 for b0, b1 in flash._wide_mma_columns(dv, plan.col_blocks) for w0, w1 in warp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("i,j,h,d,dv", FWD_PLAN_SHAPES)
def test_fwd_plan_covers_every_key_tile_and_column_once(i, j, h, d, dv, dtype):
    plan = flash._wide_mma_fwd_plan(i, j, h, d, dv, dtype)
    fused = d <= flash.WIDE_MMA_GROUP and dv <= flash.WIDE_MMA_GROUP
    assert plan.fused == fused
    # 16-row tiles where i <= 16 and wherever the warps split the columns
    assert plan.rows == (flash.WIDE_MMA_FWD_ROWS[dtype] if fused and i > 16 else flash.WIDE_MMA_ROWS_SMALL)
    small_bf16 = fused and plan.rows == flash.WIDE_MMA_ROWS_SMALL and dtype == torch.bfloat16
    assert plan.keys == (flash.WIDE_MMA_KEYS_SMALL if small_bf16 else flash.WIDE_MMA_KEYS)
    # every key tile in exactly one split, none empty
    tiles = -(-j // plan.keys)
    ranges = [(s * plan.tiles_per_split, min((s + 1) * plan.tiles_per_split, tiles)) for s in range(plan.splits)]
    assert all(b > a for a, b in ranges) and _covered_once(ranges, tiles)
    # the grid fills a batch row's blocks to the target where the key tiles
    # allow: n splits, or where n equal splits cannot cover the tiles, the
    # most splits of one length within n (one tile fewer a split would make
    # more than n); the target: a wave of WAVE blocks, then whole waves
    # short of two
    blocks = -(-i // plan.rows) * plan.col_blocks * h
    n = flash._wide_mma_fwd_target(blocks, tiles)
    wave = flash.WIDE_MMA_FWD_WAVE
    assert n == tiles or blocks * n >= wave
    assert n == tiles or blocks * n % wave == 0 or blocks * (n - 1) < wave or blocks * n >= 2 * wave
    per = plan.tiles_per_split
    assert plan.splits <= n and (per == 1 or -(-tiles // (per - 1)) > n)
    # every output column in exactly one block's columns, and in one warp's
    # columns of at most GROUP (the kernel's group_width split of a block's
    # nominal width over its warps); as few column blocks as 8 warps of
    # GROUP columns allow
    assert plan.col_blocks == (1 if fused else -(-dv // (flash.WIDE_MMA_WARPS * flash.WIDE_MMA_GROUP)))
    blocks = flash._wide_mma_columns(dv, plan.col_blocks)
    assert _covered_once(blocks, dv)
    cols = _fwd_warp_columns(dv, plan)
    assert _covered_once(cols, dv) and all(b - a <= flash.WIDE_MMA_GROUP for a, b in cols)


def test_fwd_plan_at_the_image_classifier():
    # the encoder's cross attend: 128-row tiles in bf16 (64 in fp32), a warp
    # holding the whole 261-column row; the decoder's one query: one 16-row
    # tile whose 8 warps hold 128 of the 1024 columns each (the scores once
    # for all of them), its 8 key tiles one a split
    enc = flash._wide_mma_fwd_plan(512, 50176, 1, 261, 261, torch.bfloat16)
    assert (enc.rows, enc.keys, enc.col_blocks, enc.fused) == (128, 64, 1, True)
    assert enc.splits * 512 // 128 == flash.WIDE_MMA_FWD_WAVE  # a wave of blocks a batch row
    enc32 = flash._wide_mma_fwd_plan(512, 50176, 1, 261, 261, torch.float32)
    assert enc32.rows == 64 and enc32.splits * 512 // 64 == 2 * flash.WIDE_MMA_FWD_WAVE  # 8 row tiles: two waves
    dec = flash._wide_mma_fwd_plan(1, 512, 1, 1024, 1024, torch.bfloat16)
    assert (dec.rows, dec.keys, dec.col_blocks, dec.splits, dec.fused) == (16, 64, 1, 8, False)
    assert _fwd_warp_columns(1024, dec) == tuple((128 * w, 128 * (w + 1)) for w in range(8))
    # the batch is no argument: a row's result does not depend on it
    assert "b" not in flash._wide_mma_fwd_plan.__code__.co_varnames[:6]


def _wide_mma_inputs(rng, b, h, i, j, d):
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, d)).astype(np.float32)
    return q, k, v


def test_fwd_split_and_merge_matches_pallas_at_an_odd_head_dim(rng):
    # causal over j > i at MNIST's head dim, left pads that leave batch row
    # 0's first rows dead, a padded stretch over several key tiles in row 1
    b, h, i, j, d = 2, 2, 128, 640, 131
    q, k, v = _wide_mma_inputs(rng, b, h, i, j, d)
    pad = np.zeros((b, j), bool)
    pad[0, :560] = True  # query row r sees keys 560..r + 512: rows 0..47 dead
    pad[1, 100:300] = True
    plan = flash._wide_mma_fwd_plan(i, j, h, d, d, torch.float32)
    assert plan.fused and plan.splits > 1
    forward = jax.jit(jax_flash._forward, static_argnums=(4,))
    o_jax, lse_jax = forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad.astype(np.float32)), True)
    o_jax, lse_jax = np.asarray(o_jax), np.asarray(lse_jax)[..., 0]
    tq, tk, tv, tpad = (torch.from_numpy(a) for a in (q, k, v, pad))
    o, lse = flash.flash_attention_wide_mma_reference(tq, tk, tv, pad_mask=tpad, causal=True)
    live = flash._allowed(tq, j, tpad, True).any(-1).expand(b, h, i).numpy()
    assert (~live).sum() > 0 and live[1].all()
    np.testing.assert_allclose(o.numpy()[live], o_jax[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy()[live], lse_jax[live], atol=1e-5, rtol=0)
    assert (o.numpy()[~live] == 0).all() and (lse.numpy()[~live] == flash.MASK_VALUE).all()
    assert (o_jax[~live] == 0).all()


@pytest.mark.parametrize("i,d,dv", [(1, 261, 261), (16, 131, 131), (5, 300, 40)])
def test_fwd_split_and_merge_matches_jax_at_16_rows(rng, i, d, dv):
    # i <= 16 (and a pair whose warps split the columns): the Pallas block
    # gate refuses these lengths, so JAX's einsum path is the reference on
    # live rows; lse against the plain version
    b, h, j = 3, 2, 1300
    q = rng.standard_normal((b, h, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, h, j, d)).astype(np.float32)
    v = rng.standard_normal((b, h, j, dv)).astype(np.float32)
    pad = np.arange(j)[None, :] >= np.asarray([j, 700, 0])[:, None]  # row 2 all pad: dead rows
    plan = flash._wide_mma_fwd_plan(i, j, h, d, dv, torch.float32)
    assert plan.rows == flash.WIDE_MMA_ROWS_SMALL and plan.splits > 1
    expected = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
                                         True, 0.0, None))
    tq, tk, tv, tpad = (torch.from_numpy(a) for a in (q, k, v, pad))
    o, lse = flash.flash_attention_wide_mma_reference(tq, tk, tv, pad_mask=tpad, causal=True)
    _, lse_ref = flash.flash_attention_reference(tq, tk, tv, pad_mask=tpad, causal=True)
    live = flash._allowed(tq, j, tpad, True).any(-1).expand(b, h, i).numpy()
    assert (~live).sum() > 0
    np.testing.assert_allclose(o.numpy()[live], expected[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy()[live], lse_ref.numpy()[live], atol=1e-5, rtol=0)
    assert (o.numpy()[~live] == 0).all() and (lse.numpy()[~live] == flash.MASK_VALUE).all()
