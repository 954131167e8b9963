"""The ``wide_mma`` route of K2 and K3 on the CPU: its plan.

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

The kernels run only on the card: ``python3 chip_smoke.py`` (phase ``k23``
and the classifiers' fits) holds them against their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import flash_attention as jax_flash
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
