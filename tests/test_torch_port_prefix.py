"""The port's chunked prefill and prefix sharing against the JAX package, on
the CPU.

- ``_prefill_chunk_kv``, ``_prefill_finalize`` and ``_prefill_finalize_paged``
  (fp32 and int8 pools, tables whose leading pages are aliased between rows)
  against JAX's, logits and caches at atol/rtol 1e-5;
- the slot engine with ``prefill_chunk`` (dense, paged, paged_int8) and with
  ``prefix_cache="on"`` with and without chunking (paged, paged_int8) on the
  hot, partial, divergent-mid-block and recycled-slot prompts of
  ``tests/test_prefix_cache.py``, and on its spread-chunk script: tokens,
  pool counters and prefix counters equal to the JAX ``SlotServingEngine``,
  tokens equal to per-request ``generate()`` (exact layouts);
- the ``KVPagePool`` refcount and ``PrefixBlockIndex`` unit checks of
  ``tests/test_prefix_cache.py`` on the port's copy;
- the COW guard, LRU eviction, cancellation during a chunked admission, a
  fault in a spread shared chunk, and the stale-row drill: the slot an
  admission fills still holds its last occupant's counters while its table
  maps the new request's staged and shared pages, and no decode step may
  write through it;
- on the CPU no paged attend launches K4.

One tiny JAX model (the config of ``tests/test_torch_port_slots.py``) is
converted once with ``load_jax_params``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.inference.generate import _prefill_chunk_kv as jax_prefill_chunk_kv
from perceiver_io_tpu.inference.generate import _prefill_finalize as jax_prefill_finalize
from perceiver_io_tpu.inference.generate import _prefill_finalize_paged as jax_prefill_finalize_paged
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference.generate import (
    GenerationConfig,
    _prefill_chunk_kv,
    _prefill_finalize,
    _prefill_finalize_paged,
    generate,
)
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.ragged_attention import ragged_paged_attention
from perceiver_io_tpu_torch.serving import slots as slots_mod
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.kv_pool import KVPagePool, PoolExhausted, PrefixBlockIndex
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=71, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=1)
N, BS = 32, 4
CFG = GenerationConfig(max_new_tokens=6, num_latents=2)
TABLE = dict(prompt_lens=(8, 16), batch_sizes=(1,))
SPREAD_TABLE = dict(prompt_lens=(8, 24), batch_sizes=(1,))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    j_model = JaxCLM(JaxConfig(**TINY))
    init = jax.jit(j_model.init, static_argnums=2)  # eager JAX on the CPU is several times slower
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, N), jnp.int32), 8)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_call(pair, *args, method, static=(), **kw):
    """``method`` of the JAX model under ``jax.jit``; ``static`` are trailing
    positional arguments passed as Python values."""
    j_model, params, _ = pair

    def fn(p, *a, **k):
        return j_model.apply({"params": p}, *a, *static, method=method, **k)

    return jax.jit(fn)(params, *args, **kw)


def _ref(t_model, prompt, max_new):
    cfg = dataclasses.replace(CFG, max_new_tokens=max_new)
    return generate(t_model, prompt[None], cfg, device="cpu")[0].numpy()


def _engine(t_model, layout="paged", *, slots=2, table=TABLE, **kw):
    if layout != "dense":
        kw.setdefault("kv_block_size", BS)
    return SlotServingEngine(t_model, CFG, BucketTable(**table), slots=slots, kv_layout=layout,
                             device="cpu", **kw)


def _hot_prompts(rng, *, prefix_len=12, tails=(3, 3, 4, 2)):
    prefix = rng.integers(1, 71, size=prefix_len, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(1, 71, size=int(t), dtype=np.int32)])
            for t in tails]


def _window(lengths, rng):
    """Right-aligned windows of random prompts and their pad counts."""
    window = np.zeros((len(lengths), N), np.int32)
    for r, length in enumerate(lengths):
        window[r, N - length:] = rng.integers(1, 71, size=length)
    return window, np.array([N - length for length in lengths], np.int32)


# -- the three generate.py functions -----------------------------------------
def test_prefill_chunk_kv_matches_jax(pair):
    _, _, t_model = pair
    tokens = np.random.default_rng(0).integers(1, 71, size=(2, 5)).astype(np.int32)
    jk, jv = _jax_call(pair, jnp.asarray(tokens), jnp.int32(7), method=jax_prefill_chunk_kv)
    with torch.no_grad():
        k, v = _prefill_chunk_kv(t_model, _t(tokens).long(), 7)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_prefill_finalize_matches_jax(pair):
    """Staged cross caches (random prefix values) -> finalize: logits, the
    caches with the latents written and the rest kept, the stack caches.
    Row 0's prompt is shorter than the latent segment (pad slots in it)."""
    _, _, t_model = pair
    rng = np.random.default_rng(1)
    window, pad = _window([5, 20], rng)
    m = 2
    ck = rng.normal(size=(2, 2, N, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 2, N, 8)).astype(np.float32)
    j_logits, j_cache, j_len, _ = _jax_call(
        pair, jnp.asarray(window), jnp.asarray(pad), jnp.int32(m), jnp.asarray(ck), jnp.asarray(cv),
        method=jax_prefill_finalize)
    with torch.no_grad():
        logits, cache, length, _ = _prefill_finalize(
            t_model, _t(window).long(), _t(pad).long(), m, _t(ck), _t(cv))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_array_equal(length.numpy(), np.asarray(j_len))
    for key in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(j_cache[key]), **TOL)
    for key in ("stack_k", "stack_v"):
        for a, b in zip(cache[key], j_cache[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_prefill_finalize_paged_matches_jax(pair, quantized):
    """The paged finalize (one row a call, as the engine calls it) of two
    rows whose tables alias their leading pages (a shared prefix), one after
    the other over one pool: logits, the pool after each row's latents
    scatter (its non-real segment slots go to the null block), the scales,
    the stack caches."""
    _, _, t_model = pair
    rng = np.random.default_rng(2)
    window, pad = _window([20, 14], rng)
    m = 2
    table = np.array([[1, 2, 3, 4, 5, 0, 0, 0], [1, 2, 6, 7, 0, 0, 0, 0]], np.int32)
    pool_k = rng.normal(size=(8 * BS, 2, 8)).astype(np.float32)
    pool_v = rng.normal(size=(8 * BS, 2, 8)).astype(np.float32)
    j_pools = {"pool_k": jnp.asarray(pool_k), "pool_v": jnp.asarray(pool_v)}
    if quantized:
        from perceiver_io_tpu.ops import paged_attention as jax_paged

        j_pools["pool_k"], j_pools["scale_k"] = jax_paged.quantize_kv(j_pools["pool_k"])
        j_pools["pool_v"], j_pools["scale_v"] = jax_paged.quantize_kv(j_pools["pool_v"])
    pools = {k: _t(v) for k, v in j_pools.items()}
    live = slice(BS, None)  # the null block takes the dropped writes in any order
    for r in range(2):
        scales = {k: j_pools[k] for k in ("scale_k", "scale_v") if k in j_pools}
        outs = _jax_call(pair, jnp.asarray(window[r:r + 1]), jnp.asarray(pad[r:r + 1]), jnp.int32(m),
                         j_pools["pool_k"], j_pools["pool_v"], jnp.asarray(table[r]), static=(BS,),
                         method=jax_prefill_finalize_paged, **scales)
        j_logits, *new, j_cache, j_len, _ = outs  # the pools, then the scales under int8
        keys = ("pool_k", "pool_v", "scale_k", "scale_v")[:len(new)]
        j_pools.update(zip(keys, new))
        with torch.no_grad():
            logits, cache, length, _ = _prefill_finalize_paged(
                t_model, _t(window[r:r + 1]).long(), _t(pad[r:r + 1]).long(), m, pools["pool_k"],
                pools["pool_v"], _t(table[r]), BS, scale_k=pools.get("scale_k"),
                scale_v=pools.get("scale_v"))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
        np.testing.assert_array_equal(length.numpy(), np.asarray(j_len))
        for key in keys:
            got, want = pools[key][live].numpy(), np.asarray(j_pools[key])[live]
            if key.startswith("pool") and quantized:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **TOL)
        assert set(cache) == {"stack_k", "stack_v"}
        for key in ("stack_k", "stack_v"):
            for a, b in zip(cache[key], j_cache[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# -- the engine against the JAX engine ----------------------------------------
def _hot_script():
    """Hot full-prefix hits, a divergent-mid-block prompt, a shorter prompt
    sharing part of the chain; 6 requests through 2 slots (recycled slots)."""
    rng = np.random.default_rng(0)
    prompts = _hot_prompts(rng)
    div = prompts[0].copy()
    div[6] = 68 if div[6] != 68 else 67
    return prompts + [div, prompts[0][:11]], [6, 4, 6, 5, 6, 4], TABLE


def _spread_script():
    """Shared admissions whose unshared suffix spreads over several steps,
    and a cold prompt (``test_parity_chunked_prefill_shared_spread``)."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 71, size=8, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 71, size=k, dtype=np.int32)])
               for k in (14, 12, 10)] + [rng.integers(1, 71, size=20, dtype=np.int32)]
    return prompts, [4, 4, 4, 4], SPREAD_TABLE


ENGINE_CASES = [
    ("dense", 4, None, _hot_script), ("paged", 4, None, _hot_script),
    ("paged_int8", 4, None, _hot_script), ("paged", None, "on", _hot_script),
    ("paged_int8", None, "on", _hot_script), ("paged", 4, "on", _hot_script),
    ("paged_int8", 4, "on", _hot_script), ("paged", 4, "on", _spread_script),
    ("paged_int8", 4, "on", _spread_script),
]


@pytest.mark.parametrize("layout,chunk,prefix_cache,script", ENGINE_CASES,
                         ids=[f"{c[0]}-chunk{c[1]}-prefix_{c[2] or 'off'}-{c[3].__name__[1:-7]}"
                              for c in ENGINE_CASES])
def test_engine_matches_jax_engine(pair, layout, chunk, prefix_cache, script):
    j_model, params, t_model = pair
    prompts, news, table = script()
    sizing = {} if layout == "dense" else {"kv_block_size": BS}
    j_cfg = JaxGenerationConfig(max_new_tokens=CFG.max_new_tokens, num_latents=CFG.num_latents)
    j_eng = JaxSlotServingEngine(j_model, params, j_cfg, JaxBucketTable(**table), slots=2,
                                 kv_layout=layout, prefill_chunk=chunk, prefix_cache=prefix_cache,
                                 **sizing)
    j_reqs = [j_eng.submit(p, config=dataclasses.replace(j_cfg, max_new_tokens=k))
              for p, k in zip(prompts, news)]
    j_eng.run_until_idle()
    eng = _engine(t_model, layout, table=table, prefill_chunk=chunk, prefix_cache=prefix_cache)
    reqs = [eng.submit(p, dataclasses.replace(CFG, max_new_tokens=k)) for p, k in zip(prompts, news)]
    eng.run_until_idle()
    assert all(r.status == "ok" for r in reqs)
    for j_req, req, p, k in zip(j_reqs, reqs, prompts, news):
        np.testing.assert_array_equal(req.result, np.asarray(j_req.result))
        if layout != "paged_int8":
            np.testing.assert_array_equal(req.result, _ref(t_model, p, k))
    stats, j_stats = eng.stats(), j_eng.stats()
    for key in ("decode_steps", "prefills", "prefill_chunks"):
        assert stats[key] == j_stats[key], key
    assert stats["prefill_chunks"] > 0 or prefix_cache == "on"
    if layout == "dense":
        return
    for key in ("allocs_total", "frees_total", "high_water", "in_use", "leaked"):
        assert stats["kv_pool"][key] == j_stats["kv_pool"][key], key
    assert stats["prefix_cache"]["enabled"] == (prefix_cache == "on")
    if prefix_cache == "on":
        for key in ("hits", "misses", "shared_blocks", "shared_tokens", "cow_copies", "published",
                    "evicted", "cached_blocks"):
            assert stats["prefix_cache"][key] == j_stats["prefix_cache"][key], key
        assert stats["prefix_cache"]["hits"] >= 2
        assert eng._pool.in_use == eng._prefix_index.cached_blocks
        eng._prefix_index.flush(eng._pool)
    assert eng._pool.in_use == 0 and eng._pool.leaked() == 0


# -- the port's pool and index copies, as tests/test_prefix_cache.py checks JAX's
def test_pool_refcounts_shared_maps_cow_and_leak_accounting():
    pool = KVPagePool(num_blocks=8, block_size=4, slots=3, max_len=32)
    pool.reserve(0, 10)
    pool.ensure(0, 10)
    assert list(pool.slot_blocks(0)) == [1, 2, 3]
    pool.retain(1)
    pool.retain(2)
    assert pool.refcount(1) == 2 and pool.refcount(3) == 1
    pool.reserve(1, 10, shared_blocks=2)
    assert pool._reserved[1] == 1
    pool.map_shared(1, [1, 2])
    assert pool.page_shared(1, 0) and pool.page_shared(1, 1)
    pool.ensure(1, 10)
    assert list(pool.slot_blocks(1)) == [1, 2, 4] and pool.refcount(1) == 3
    assert pool.cow(1, 1) == (2, 5)
    assert list(pool.slot_blocks(1)) == [1, 5, 4]
    assert pool.refcount(2) == 2 and pool.cow_swaps_total == 1
    assert pool.release(0, cause="retire") == 1
    assert pool.frees_by_cause == {"retire": 1}
    assert pool.shared_derefs_total > 0 and pool.leaked() == 0
    assert pool.release(1, cause="cancelled") == 2
    assert pool.frees_by_cause["cancelled"] == 2
    assert pool.deref(1, cause="shared") == 1 and pool.deref(2, cause="shared") == 1
    assert pool.frees_by_cause["shared"] == 2
    assert pool.in_use == 0 and pool.leaked() == 0
    assert pool.allocs_total == pool.frees_total == 5
    stats = pool.stats()
    assert stats["shared_maps_total"] == 2 and stats["cow_swaps_total"] == 1
    assert stats["refs_total"] == 0 and stats["shared_blocks"] == 0
    with pytest.raises(ValueError, match="not allocated"):
        pool.retain(7)
    with pytest.raises(ValueError, match="not allocated"):
        pool.deref(7)


def test_pool_cow_respects_free_list_invariant():
    pool = KVPagePool(num_blocks=3, block_size=4, slots=2, max_len=16)
    pool.reserve(0, 4)
    pool.ensure(0, 4)
    pool.retain(1)
    pool.reserve(1, 8)
    with pytest.raises(PoolExhausted, match="copy-on-write"):
        pool.cow(0, 0)
    pool.release(1)
    assert pool.cow(0, 0) == (1, 2)
    pool.release(0)
    pool.deref(1, cause="shared")
    assert pool.leaked() == 0


def test_prefix_index_match_insert_best_partial_and_lru_eviction():
    pool = KVPagePool(num_blocks=8, block_size=4, slots=2, max_len=32)
    index = PrefixBlockIndex(block_size=4)
    tokens = np.arange(1, 13, dtype=np.int32)
    pool.reserve(0, 12)
    pool.ensure(0, 12)
    assert index.insert(tokens, pool.slot_blocks(0), pool) == 3
    assert index.cached_blocks == 3
    assert index.insert(tokens, (7, 7, 7), pool) == 0  # first donor wins
    assert [n.block for n in index.match(tokens)] == [1, 2, 3]
    assert index.match(np.arange(2, 9, dtype=np.int32)) == []
    div = tokens.copy()
    div[6] = 63
    matched = index.match(div)
    assert [n.block for n in matched] == [1]
    cand, lcp = index.best_partial(matched, div)
    assert cand is not None and cand.block == 2 and lcp == 2
    pool.release(0)
    assert pool.in_use == 3 and pool.leaked() == 0
    assert index.evict_one(pool) == 1  # the LRU leaf, block 3
    assert index.cached_blocks == 2 and pool.frees_by_cause["shared"] == 1
    assert index.flush(pool) == 2
    assert index.cached_blocks == 0 and pool.in_use == 0
    assert index.evict_one(pool) is None


# -- drills on the port's engine ---------------------------------------------
def test_cow_guard_never_writes_through_a_shared_page(pair):
    """Every page a resident maps is made to read shared (an extra retain);
    the guard copies each before a decode write lands on it, the output stays
    equal to ``generate()`` and the retained pages keep their contents."""
    _, _, t_model = pair
    eng = _engine(t_model, "paged_int8", prefix_cache="on")
    prompt = np.random.default_rng(7).integers(1, 71, size=9, dtype=np.int32)
    cfg = dataclasses.replace(CFG, max_new_tokens=8)
    req = eng.submit(prompt, cfg)
    eng.step()
    slot = next(s for s in eng._slots if s is not None).slot
    pinned = list(eng._pool.slot_blocks(slot))
    rows = torch.tensor([b * BS + i for b in pinned for i in range(BS)])
    before = [eng._state[k][rows].clone() for k in ("pool_k", "pool_v", "scale_k", "scale_v")]
    for b in pinned:
        eng._pool.retain(b)
    eng.run_until_idle()
    assert eng.stats()["prefix_cache"]["cow_copies"] > 0
    np.testing.assert_array_equal(req.result, _ref(t_model, prompt, 8))
    for old, key in zip(before, ("pool_k", "pool_v", "scale_k", "scale_v")):
        assert torch.equal(eng._state[key][rows], old)
    for b in pinned:
        eng._pool.deref(b, cause="shared")
    assert eng._pool.in_use == eng._prefix_index.cached_blocks and eng._pool.leaked() == 0


def test_lru_eviction_under_pool_pressure_before_waiting(pair):
    _, _, t_model = pair
    eng = _engine(t_model, prefix_cache="on", kv_blocks=6)
    rng = np.random.default_rng(2)
    hot = _hot_prompts(rng, tails=(3,))[0]
    np.testing.assert_array_equal(eng.serve([hot])[0], _ref(t_model, hot, 6))
    assert eng._prefix_index.cached_blocks == 3  # prefix_len 13 -> 3 full blocks
    cold = rng.integers(1, 71, size=14, dtype=np.int32)
    np.testing.assert_array_equal(eng.serve([cold])[0], _ref(t_model, cold, 6))
    stats = eng.stats()
    assert stats["prefix_cache"]["evicted"] > 0 and stats["kv_pool_admit_waits_total"] == 0
    assert eng._pool.leaked() == 0


def test_cancel_returns_refcounts_at_once(pair):
    """Cancel a sharer mid-generation and a chunked admission in flight: the
    private pages free (``cancelled``) before the next step, the shared
    prefix stays cached, the surviving sharer's stream is untouched."""
    _, _, t_model = pair
    eng = _engine(t_model, prefix_cache="on", prefill_chunk=2)
    rng = np.random.default_rng(4)
    prompts = _hot_prompts(rng, tails=(3, 4, 3))
    eng.serve([prompts[0]])
    cached = eng._prefix_index.cached_blocks
    assert cached > 0
    h1, h2 = eng.submit(prompts[1]), eng.submit(prompts[2])
    eng.step()
    in_use = eng._pool.in_use
    assert eng.cancel(h1.request_id)
    assert eng._pool.in_use < in_use and eng._pool.frees_by_cause.get("cancelled", 0) > 0
    assert eng._prefix_index.cached_blocks == cached
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result, _ref(t_model, prompts[2], 6))
    assert h1.status == "cancelled"
    # a cold 16-token prompt spreads its chunks over several steps
    cold = rng.integers(1, 71, size=16, dtype=np.int32)
    h3 = eng.submit(cold)
    eng.step()
    admit = eng._admitting
    assert admit is not None and admit.req is h3 and eng._pool.mapped_blocks(admit.slot) > 0
    freed = eng._pool.frees_by_cause["cancelled"]
    assert eng.cancel(h3.request_id) and eng._admitting is None
    assert eng._pool.mapped_blocks(admit.slot) == 0
    assert eng._pool.frees_by_cause["cancelled"] > freed and h3.status == "cancelled"
    assert not eng.pending() and eng.health()["admitting"] is False
    assert eng._pool.leaked() == 0 and eng._pool.in_use == eng._prefix_index.cached_blocks


def test_spread_shared_chunk_fault_fails_residents(pair, monkeypatch):
    """A fault on a later chunk call of a spread shared admission fails the
    residents too (the chunk wrote pool pages through the live state): the
    pool and the index empty, and the rebuilt engine serves again."""
    _, _, t_model = pair
    eng = _engine(t_model, prefix_cache="on", prefill_chunk=2, table=SPREAD_TABLE)
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, 71, size=8, dtype=np.int32)
    donor = np.concatenate([prefix, rng.integers(1, 71, size=4, dtype=np.int32)])
    eng.serve([donor])
    resident = eng.submit(donor)
    eng.step()
    assert resident.status == "queued" and any(s is not None for s in eng._slots)
    real, calls = slots_mod._stage_shared_chunk, {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected mid-admission fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(slots_mod, "_stage_shared_chunk", flaky)
    victim = eng.submit(np.concatenate([prefix, rng.integers(1, 71, size=14, dtype=np.int32)]))
    while eng.pending() and victim.status == "queued":
        eng.step()
    assert victim.status == "failed" and "injected" in victim.error
    assert resident.status == "failed" and eng._admitting is None
    assert eng._pool.leaked() == 0 and eng._pool.in_use == 0
    monkeypatch.setattr(slots_mod, "_stage_shared_chunk", real)
    np.testing.assert_array_equal(eng.serve([donor])[0], _ref(t_model, donor, 6))


def test_stale_row_drill(pair):
    """Request ``a`` (3 tokens: pad 29) retires in its boundary phase; a
    chunked shared admission ``c`` then fills its slot while ``b`` runs
    boundary steps. The slot's row still holds ``a``'s length, ``m`` and pad,
    and its table already maps ``c``'s shared and staged pages: before every
    decode step of the admission and after it, those pages are bitwise the
    same, and every request's tokens equal ``generate()``. (If the decode
    step's table mapped ``c``'s pages for that row, it would write ``a``'s
    append and migration through them: ``c``'s first token changes, here and
    in the JAX engine, ``ROADMAP.md`` C.)"""
    _, _, t_model = pair
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, 71, size=12, dtype=np.int32)
    donor = np.concatenate([prefix, rng.integers(1, 71, size=2, dtype=np.int32)])
    a = rng.integers(1, 71, size=3, dtype=np.int32)
    b = rng.integers(1, 71, size=9, dtype=np.int32)
    c = np.concatenate([prefix, rng.integers(1, 71, size=10, dtype=np.int32)])
    d = np.concatenate([prefix, rng.integers(1, 71, size=3, dtype=np.int32)])
    script = [(a, 8), (b, 16), (c, 8), (d, 8)]
    eng = _engine(t_model, prefix_cache="on", prefill_chunk=2,
                  table=dict(prompt_lens=(8, 16, 24), batch_sizes=(1,)))
    eng.serve([donor])  # publishes the prefix's 3 blocks
    real, seen = eng._decode, []

    def watched(boundary):
        admit = eng._admitting
        if admit is None or admit.plan is None:
            return real(boundary)
        st = eng._state
        rows = torch.tensor([blk * BS + i for blk in eng._pool.slot_blocks(admit.slot)
                             for i in range(BS)])
        before = st["pool_k"][rows].clone(), st["pool_v"][rows].clone()
        stale = int(st["m"][admit.slot]), int(st["pad"][admit.slot])
        out = real(boundary)
        same = torch.equal(st["pool_k"][rows], before[0]) and torch.equal(st["pool_v"][rows], before[1])
        seen.append(dict(boundary=boundary, stale_m=stale[0], stale_pad=stale[1], same=same))
        return out

    eng._decode = watched
    reqs = [eng.submit(p, dataclasses.replace(CFG, max_new_tokens=k)) for p, k in script]
    eng.run_until_idle()
    # the drill ran: c's admission spread over decode steps, some of them
    # boundary steps, in a slot whose row was a's (in its boundary phase)
    assert reqs[2].started_at is not None and len(seen) >= 2
    assert any(s["boundary"] for s in seen)
    assert all(s["stale_m"] == t_model.max_latents and s["stale_pad"] > 12 for s in seen)
    assert all(s["same"] for s in seen), seen
    for req, (p, k) in zip(reqs, script):
        np.testing.assert_array_equal(req.result, _ref(t_model, p, k))
    assert eng.stats()["prefix_cache"]["hits"] == 2


def test_cpu_path_runs_no_kernel(pair):
    _, _, t_model = pair
    before = ragged_paged_attention.launches
    prompts = _hot_script()[0]
    eng = _engine(t_model, prefix_cache="on", prefill_chunk=4)
    eng.serve(prompts[:3])
    assert eng.stats()["prefix_cache"]["hits"] > 0
    assert ragged_paged_attention.launches == before
    assert eng.stats()["kv_ragged_kernel_steps_total"] == 0
