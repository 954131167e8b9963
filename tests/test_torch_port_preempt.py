"""The port's preemption in the slot engine against the JAX package, on the CPU.

- the lazy-reservation and host-swap halves of the port's ``KVPagePool``
  copy (``reserve_lazy``, lazy ``ensure`` exhaustion, ``ensure_many``,
  ``extract``/``restore``, owners) against JAX's ``KVPagePool`` on the same
  scripts: equal tables, counts and ``frees_by_cause``;
- the slot engine under ``preemption="recompute"``, ``"swap"`` and
  ``"auto"`` on the pressured scripts of ``tests/test_kv_preemption.py`` and
  ``tests/test_kv_swap.py`` (paged, paged_int8, chunked prefill, prefix
  sharing): tokens, preemption and swap counters, pool counters and the
  per-victim post-mortem records equal to the JAX ``SlotServingEngine``'s,
  tokens equal to ``generate()`` (exact layouts) and 0 leaked;
- the victim policy (tiers, tenants, admission order, the last resident),
  ``auto`` over a clock that advances, every retirement route of a parked
  swap bundle, and the constructor's validation.

Each script is first held against ``generate()`` of the port, which
``tests/test_torch_port_serving.py`` pins to JAX's ``generate()``: the port
is compared with the JAX engine only where the JAX engine agrees with it.
The JAX engine runs are shared by the tests that read them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu.inference import decode_strategy as jax_strategy
from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu.serving.kv_pool import KVPagePool as JaxKVPagePool
from perceiver_io_tpu.serving.kv_pool import PoolExhausted as JaxPoolExhausted
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference import decode_strategy as port_strategy
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.observability import tenant_label, tier_label
from perceiver_io_tpu_torch.ops.ragged_attention import ragged_paged_attention
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.kv_pool import KVPagePool, PoolExhausted
from perceiver_io_tpu_torch.serving.slots import PREEMPTION_MODES, SlotServingEngine

TINY = dict(vocab_size=71, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=1)
N, BS = 32, 4
BASE = GenerationConfig(max_new_tokens=3, num_latents=2)
#: the fields of a post-mortem record both engines must agree on
PM_KEYS = ("request_id", "tenant", "priority", "slot", "mode", "tokens_discarded",
           "pages_released", "victim_bytes", "decode_step_ms", "recompute_est_ms", "swap_est_ms")


class Ticker:
    """A clock that advances ``dt`` seconds at every read: the engines read
    it at the same points, so both measure the same decode steps and swaps."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


class Frozen:
    """A clock that moves only when told to (deadlines)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


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
    # both engines' swaps record measured link rates in their package's
    # in-memory registry, which the next engine starts from: both start
    # empty here, and what was there before this module is put back
    saved = [(reg, dict(reg)) for reg in (jax_strategy._SWAP_REGISTRY, port_strategy._SWAP_REGISTRY)]
    for reg, _ in saved:
        reg.clear()
    yield j_model, params, load_jax_params(t_model, params).eval()
    for reg, before in saved:
        reg.clear()
        reg.update(before)


def _ref(t_model, prompt, max_new):
    cfg = dataclasses.replace(BASE, max_new_tokens=max_new)
    return generate(t_model, prompt[None], cfg, device="cpu")[0].numpy()


def _prompts(rng, lengths):
    return [rng.integers(1, 71, size=int(n)).astype(np.int32) for n in lengths]


# -- scripts: (prompts, max_new, submit kwargs, engine kwargs) ----------------
def _longtail(seed):
    """Shorts and near-context longs (``tests/test_kv_preemption.py``
    ``_longtail``): lazy admission packs them and preempts under pressure."""
    prompts = _prompts(np.random.default_rng(seed), [5, 7, 6, 4, 7, 5])
    return prompts, [14 if i % 2 else 3 for i in range(6)], [{}] * 6


def _geometry(geometry):
    prompts, news, subs = _longtail(11)
    kw = dict(table=(8, 16))
    if geometry == "chunked":
        kw["prefill_chunk"] = 4
    elif geometry == "prefix":
        kw["prefix_cache"] = "on"
        prompts = [np.concatenate([prompts[0][:4], p]).astype(np.int32)[:8] for p in prompts]
    elif geometry == "prefix_chunked":
        kw.update(prefix_cache="on", prefill_chunk=2)
        prompts = [np.concatenate([prompts[0][:8], p]).astype(np.int32)[:13] for p in prompts]
    elif geometry == "int8":
        kw["layout"] = "paged_int8"
    return prompts, news, subs, kw


def _tiers():
    """Three batch-tier requests of two tenants and one interactive one
    (``tests/test_kv_preemption.py`` ``test_priority_tiers_never_preempt_higher``)."""
    prompts = _prompts(np.random.default_rng(5), [6, 6, 6, 6])
    subs = [dict(priority=0, tenant="batch-a"), dict(priority=0, tenant="batch-a"),
            dict(priority=0, tenant="batch-b"), dict(priority=1, tenant="live")]
    return prompts, [12] * 4, subs


def _tenants():
    """One tier, tenant ``a`` with two long requests and ``b`` with one of
    the same size: at equal priority the tenant holding the most pages yields."""
    prompts = _prompts(np.random.default_rng(8), [6, 6, 6])
    subs = [dict(tenant="a"), dict(tenant="b"), dict(tenant="a")]
    return prompts, [12] * 3, subs


SCRIPTS = {
    "longtail_recompute": (*_longtail(3), dict(preemption="recompute")),
    "longtail_swap": (*_longtail(3), dict(preemption="swap", swap_link_gbps=3e-4)),
    "longtail_swap_int8": (*_longtail(3), dict(preemption="swap", layout="paged_int8")),
    "longtail_auto": (*_longtail(3), dict(preemption="auto", swap_link_gbps=3e-4, clock=Ticker)),
    "chunked": (*_geometry("chunked")[:3], dict(_geometry("chunked")[3], preemption="recompute")),
    "prefix": (*_geometry("prefix")[:3], dict(_geometry("prefix")[3], preemption="recompute")),
    "int8": (*_geometry("int8")[:3], dict(_geometry("int8")[3], preemption="recompute")),
    "prefix_chunked_swap": (*_geometry("prefix_chunked")[:3],
                            dict(_geometry("prefix_chunked")[3], preemption="swap")),
    "tiers": (*_tiers(), dict(preemption="recompute")),
    "tenants": (*_tenants(), dict(preemption="recompute", kv_blocks=7)),
}


def _build(pair, kw, jax_side: bool):
    kw = dict(kw)
    layout = kw.pop("layout", "paged")
    table = kw.pop("table", (8,))
    clock = kw.pop("clock", Frozen)()
    kw.setdefault("kv_blocks", 8)
    common = dict(slots=kw.pop("slots", 4), kv_layout=layout, kv_block_size=BS,
                  admit_headroom_blocks=0, clock=clock, **kw)
    if jax_side:
        j_model, params, _ = pair
        j_cfg = JaxGenerationConfig(max_new_tokens=3, num_latents=2)
        return JaxSlotServingEngine(j_model, params, j_cfg, JaxBucketTable(prompt_lens=table,
                                                                           batch_sizes=(1,)),
                                    **common), j_cfg
    return SlotServingEngine(pair[2], BASE, BucketTable(prompt_lens=table, batch_sizes=(1,)),
                             device="cpu", **common), BASE


def _drive(engine, cfg, prompts, news, subs):
    reqs = [engine.submit(p, config=dataclasses.replace(cfg, max_new_tokens=k), **s)
            for p, k, s in zip(prompts, news, subs)]
    engine.run_until_idle()
    return reqs


_RUNS = {}


def _run(pair, name):
    """Both engines over script ``name`` (each once per module)."""
    if name not in _RUNS:
        prompts, news, subs, kw = SCRIPTS[name]
        out = {}
        for side in ("jax", "port"):
            engine, cfg = _build(pair, kw, side == "jax")
            out[side] = (engine, _drive(engine, cfg, prompts, news, subs))
        _RUNS[name] = out
    return _RUNS[name]


def _records(engine):
    return [tuple(r[k] for k in PM_KEYS) for r in engine._postmortems]


def _check_against_jax(pair, name, *, exact=True):
    """The checks every engine script shares: all ok, tokens equal to the
    JAX engine's (and to ``generate()`` first, on the exact layouts),
    preemption, swap and pool counters and post-mortems equal, 0 leaked."""
    t_model = pair[2]
    prompts, news = SCRIPTS[name][:2]
    run = _run(pair, name)
    (j_eng, j_reqs), (eng, reqs) = run["jax"], run["port"]
    for j_req, req, p, k in zip(j_reqs, reqs, prompts, news):
        assert j_req.status == "ok" and req.status == "ok"
        if exact:
            ref = _ref(t_model, p, k)
            np.testing.assert_array_equal(np.asarray(j_req.result), ref)  # the JAX engine is sound here
            np.testing.assert_array_equal(req.result, ref)
        np.testing.assert_array_equal(req.result, np.asarray(j_req.result))
        assert req.preemptions == j_req.preemptions
    stats, j_stats = eng.stats(), j_eng.stats()
    for key in ("decode_steps", "prefills", "prefill_chunks"):
        assert stats[key] == j_stats[key], key
    for key in ("mode", "admit_headroom_blocks", "preemptions", "readmissions", "swaps",
                "swap_restores", "swap_bytes", "swapped_waiting", "swap_link_gbps", "by_tier",
                "by_tenant", "headroom_blocks"):
        assert stats["preemption"][key] == j_stats["preemption"][key], key
    j_pm, pm = j_eng.postmortems(), eng.postmortems()
    assert {k: v for k, v in pm.items() if k != "recent"} == \
        {k: v for k, v in j_pm.items() if k != "recent"}
    assert _records(eng) == _records(j_eng)
    for key in ("allocs_total", "frees_total", "frees_by_cause", "high_water", "in_use", "leaked",
                "lazy_slots", "shared_maps_total", "shared_derefs_total", "cow_swaps_total"):
        assert stats["kv_pool"][key] == j_stats["kv_pool"][key], key
    if "prefix_cache" in j_stats and j_stats["prefix_cache"]["enabled"]:
        for key in ("hits", "misses", "shared_blocks", "cow_copies", "published", "evicted",
                    "cached_blocks"):
            assert stats["prefix_cache"][key] == j_stats["prefix_cache"][key], key
        assert eng._pool.in_use == eng._prefix_index.cached_blocks
        eng._prefix_index.flush(eng._pool)
    assert stats["tenants"] == j_stats["tenants"]
    assert eng._pool.in_use == 0 and eng._pool.leaked() == 0
    assert eng.counters["kv_preemptions_total"] == j_eng.registry.counter("kv_preemptions_total")
    for tier in stats["preemption"]["by_tier"]:
        name_ = f"kv_preemptions_tier_{tier_label(tier)}_total"
        assert eng.counters[name_] == j_eng.registry.counter(name_)
    return stats


# -- (a) the pool's lazy and swap halves against JAX's ------------------------
def _pool_reserve_lazy(pool, exc):
    out = [pool.reserve_lazy(0, 5, 24, headroom=1), pool.reserved, pool.is_lazy(0),
           pool.reserve_lazy(1, 4, 6, headroom=5), pool.reserve(2, 8), pool.reserved,
           pool.headroom_blocks]
    for args, kw in (((0, 4, 8), {}), ((1, 12, 8), {}), ((1, 4, 99), {}),
                     ((1, 4, 8), dict(headroom=-1))):
        out.append(_raises(exc, pool.reserve_lazy, *args, **kw))
    pool.release(1)
    out.append(_raises(exc, pool.reserve_lazy, 1, 24, 24))
    out += [pool.release(0), pool.release(2), pool.leaked()]
    return out


def _pool_lazy_exhaustion(pool, exc):
    out = [pool.reserve_lazy(0, 4, 24), pool.ensure(0, 4), pool.ensure(0, 12), pool.reserved,
           pool.reserve(1, 9), _raises(exc, pool.ensure, 0, 16), list(pool.table_row(0)),
           pool.ensure(1, 9), _raises(exc, pool.ensure, 1, 13), pool.release(1),
           _raises(exc, pool.ensure, 0, 25), pool.stats()["lazy_slots"]]
    return out


def _pool_ensure_many(pool, exc):
    out = [pool.reserve_lazy(0, 4, 24), pool.ensure_many(0, 4), pool.reserve(1, 12),
           pool.headroom_blocks, pool.ensure_many(0, 12), _raises(exc, pool.ensure_many, 0, 16),
           list(pool.table_row(0)), _raises(exc, pool.ensure_many, 0, 25), pool.release(1),
           pool.ensure_many(0, 20), pool.ensure_many(0, 20)]
    return out


def _pool_extract_restore(pool, exc):
    pool.reserve(2, 4)
    pool.ensure(2, 4)
    prefix = int(pool.table_row(2)[0])
    pool.retain(prefix)
    pool.release(2)
    pool.reserve(0, 12, shared_blocks=1)
    pool.map_shared(0, [prefix])
    pool.ensure(0, 12)
    shared, private = pool.extract(0, cause="swapped")
    pool.reserve(1, len(private) * 4)
    pool.ensure(1, len(private) * 4)
    out = [shared, private, pool.in_use, list(pool.table_row(1)),
           pool.restore(0, shared, total_tokens=12, resident_tokens=12), list(pool.table_row(0)),
           _raises(exc, pool.restore, 0, shared, 12, 12)]
    pool.deref(prefix, cause="swapped")
    pool.release(1)
    shared2, _ = pool.extract(0)
    pool.reserve(1, 32)  # the worst case no longer fits
    out += [shared2, _raises(exc, pool.restore, 0, shared2, 12, 12), pool.mapped_blocks(0)]
    pool.release(1)
    out += [pool.restore(0, shared2, 12, 9), pool.deref(prefix, cause="swapped"), pool.release(0),
            pool.deref(prefix)]
    return out


def _pool_owners(pool, exc):
    pool.reserve_lazy(0, 8, 20)
    pool.set_owner(0, tenant_label("tenant-a"))
    pool.ensure(0, 8)
    pool.reserve(1, 8)
    pool.set_owner(1, tenant_label(None))
    pool.ensure(1, 5)
    pool.reserve(2, 4)
    pool.ensure(2, 4)
    out = [pool.in_use_by_owner(), pool.stats(), pool.headroom_blocks]
    pool.set_owner(2, "x")
    pool.set_owner(2, None)
    out += [pool.in_use_by_owner(), pool.release(0, cause="preempted"),
            pool.release(1, cause="cancelled"), pool.in_use_by_owner(), pool.release(2)]
    return out


def _raises(exc, fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except exc as e:
        return ("PoolExhausted", str(e))
    except ValueError as e:
        return ("ValueError", str(e))


def _pool_state(pool):
    return dict(table=pool.table().tolist(), mapped=dict(pool._mapped), reserved=dict(pool._reserved),
                soft=dict(pool._soft), owner=dict(pool._owner), refcount=dict(pool._refcount),
                stats=pool.stats(), headroom=pool.headroom_blocks, leaked=pool.leaked())


POOL_SCRIPTS = {
    "reserve_lazy": (dict(num_blocks=12, block_size=4, slots=3, max_len=32), _pool_reserve_lazy),
    "lazy_exhaustion": (dict(num_blocks=6, block_size=4, slots=3, max_len=32),
                        _pool_lazy_exhaustion),
    "ensure_many": (dict(num_blocks=6, block_size=4, slots=3, max_len=32), _pool_ensure_many),
    "extract_restore": (dict(num_blocks=10, block_size=4, slots=3, max_len=32),
                        _pool_extract_restore),
    "owners": (dict(num_blocks=12, block_size=4, slots=3, max_len=32), _pool_owners),
}


@pytest.mark.parametrize("name", list(POOL_SCRIPTS))
def test_pool_matches_jax_pool(name):
    sizes, script = POOL_SCRIPTS[name]
    pool, j_pool = KVPagePool(**sizes), JaxKVPagePool(**sizes)
    out, j_out = script(pool, PoolExhausted), script(j_pool, JaxPoolExhausted)
    assert out == j_out
    assert _pool_state(pool) == _pool_state(j_pool)
    assert pool.frees_by_cause == j_pool.frees_by_cause and pool.leaked() == 0


# -- (b) (c) recompute: the long-tail script and the geometries ---------------
def test_longtail_recompute_matches_jax_engine(pair):
    stats = _check_against_jax(pair, "longtail_recompute")
    pre = stats["preemption"]
    assert pre["mode"] == "recompute" and pre["preemptions"] > 0 and pre["readmissions"] > 0
    assert pre["by_tier"] == {0: pre["preemptions"]} and pre["swaps"] == 0
    assert stats["kv_pool"]["frees_by_cause"]["preempted"] > 0
    assert stats["kv_pool"]["allocs_total"] == stats["kv_pool"]["frees_total"] > 0


@pytest.mark.parametrize("geometry", ["chunked", "prefix", "int8"])
def test_recompute_geometries_match_jax_engine(pair, geometry):
    """A chunked victim restarts its chunks, a prefix-sharing victim derefs
    the blocks it shares, and int8 replays equal an unpressured int8 run."""
    stats = _check_against_jax(pair, geometry, exact=geometry != "int8")
    assert stats["preemption"]["preemptions"] > 0
    assert stats["kv_pool"]["frees_by_cause"]["preempted"] > 0
    if geometry == "chunked":
        assert stats["prefill_chunks"] > 0
    if geometry == "int8":
        prompts, news, subs, kw = SCRIPTS["int8"]
        eng, cfg = _build(pair, dict(kw, preemption=None, kv_blocks=32), jax_side=False)
        ample = _drive(eng, cfg, prompts, news, subs)
        for a, b in zip(_run(pair, "int8")["port"][1], ample):
            np.testing.assert_array_equal(a.result, b.result)


# -- (d) swap -----------------------------------------------------------------
@pytest.mark.parametrize("name", ["longtail_swap", "longtail_swap_int8", "prefix_chunked_swap"])
def test_swap_matches_jax_engine(pair, name):
    """Swapped victims resume where they stopped: equal tokens, swap counts
    and bytes, the bundles' shared blocks dereferenced and given back, and no
    token generated twice."""
    stats = _check_against_jax(pair, name, exact=name != "longtail_swap_int8")
    pre = stats["preemption"]
    assert pre["swaps"] > 0 and pre["swap_restores"] == pre["swaps"] and pre["swap_bytes"] > 0
    assert pre["swapped_waiting"] == 0
    assert stats["kv_pool"]["frees_by_cause"]["swapped"] > 0
    eng, reqs = _run(pair, name)["port"]
    replays = sum(r["tokens_discarded"] for r in eng._postmortems if r["mode"] == "recompute")
    assert stats["tokens_generated"] == sum(len(r.result) for r in reqs) + replays
    assert len(eng.samples["swap_out_ms"]) == len(eng.samples["swap_in_ms"]) == pre["swaps"]


# -- (e) the victim policy ----------------------------------------------------
def test_tiers_never_preempt_higher(pair):
    stats = _check_against_jax(pair, "tiers")
    eng, reqs = _run(pair, "tiers")["port"]
    assert reqs[3].preemptions == 0 and stats["preemption"]["preemptions"] > 0
    assert set(stats["preemption"]["by_tier"]) == {0}
    assert sum(r.preemptions for r in reqs[:3]) == stats["preemption"]["preemptions"]


def test_tenant_holding_most_pages_yields_first(pair):
    stats = _check_against_jax(pair, "tenants")
    eng, reqs = _run(pair, "tenants")["port"]
    first = eng._postmortems[0]
    assert first["tenant"] == "a" and stats["preemption"]["by_tenant"].get("b", 0) <= \
        stats["preemption"]["by_tenant"]["a"]


def test_priority_orders_admission(pair):
    prompts = _prompts(np.random.default_rng(9), [5, 5, 5])
    orders = []
    for side in ("jax", "port"):
        eng, cfg = _build(pair, dict(preemption="recompute", slots=1, kv_blocks=None), side == "jax")
        reqs = [eng.submit(p, config=dataclasses.replace(cfg, max_new_tokens=2), priority=pr)
                for p, pr in zip(prompts, (0, 0, 5))]
        order = []
        while eng.pending():
            eng.step()
            order += [r.request_id for r in reqs if r.done and r.request_id not in order]
        orders.append(order)
    assert orders[0] == orders[1] == [2, 0, 1]


def test_fifo_traffic_is_not_sorted(pair):
    """With preemption off and every priority 0 the queue keeps its order."""
    eng, cfg = _build(pair, dict(slots=1, kv_blocks=None), jax_side=False)
    reqs = [eng.submit(p, config=dataclasses.replace(cfg, max_new_tokens=2))
            for p in _prompts(np.random.default_rng(9), [5, 6, 7])]
    eng._queue.reverse()  # a sort would put it back
    eng.run_until_idle()
    assert [r.started_at for r in reqs] == sorted((r.started_at for r in reqs), reverse=True)


def test_last_resident_never_preempted(pair):
    outcomes = []
    for side in ("jax", "port"):
        eng, cfg = _build(pair, dict(preemption="recompute", kv_blocks=10), side == "jax")
        req = eng.submit(_prompts(np.random.default_rng(2), [6])[0],
                         config=dataclasses.replace(cfg, max_new_tokens=4))
        eng.step()
        entry = next(s for s in eng._slots if s is not None)
        outcomes.append((eng._pick_victim(entry.req.priority, strict=False, exclude_slot=entry.slot),
                         eng._reclaim_decode_page(entry), eng._slots[entry.slot] is entry))
        eng.run_until_idle()
        assert req.status == "ok" and req.preemptions == 0
    assert outcomes[0] == outcomes[1] == (None, "stuck", True)


# -- (f) auto over a clock that advances --------------------------------------
def test_auto_takes_both_arms_as_jax_does(pair):
    """Each victim's disposition is the cheaper side of its own record, both
    sides are taken, and the records equal the JAX engine's."""
    stats = _check_against_jax(pair, "longtail_auto")
    eng = _run(pair, "longtail_auto")["port"][0]
    modes = set()
    for r in eng._postmortems:
        assert r["mode"] == ("swap" if r["swap_est_ms"] < r["recompute_est_ms"] else "recompute")
        modes.add(r["mode"])
    assert modes == {"swap", "recompute"} and stats["preemption"]["swaps"] > 0
    assert stats["preemption"]["swap_link_gbps"] != 3e-4  # the measured transfers moved it


# -- (g) a parked bundle on every retirement route ----------------------------
@pytest.mark.parametrize("route", ["cancel", "deadline", "decode_fault"])
def test_parked_bundle_drops_on_every_route(pair, route):
    _, _, t_model = pair
    clock = Frozen()
    eng = SlotServingEngine(t_model, BASE, BucketTable(prompt_lens=(8,), batch_sizes=(1,)), slots=4,
                            kv_layout="paged", kv_block_size=BS, kv_blocks=8, preemption="swap",
                            prefix_cache="on", clock=clock, device="cpu")
    rng = np.random.default_rng(7)
    system = rng.integers(1, 71, size=4).astype(np.int32)
    prompts = [np.concatenate([system, t]) for t in _prompts(rng, [2, 2])]
    cfg = dataclasses.replace(BASE, max_new_tokens=14)
    deadline = 1.0 if route == "deadline" else None
    reqs = [eng.submit(p, cfg, deadline_s=deadline) for p in prompts]
    while not eng._swap_bundles:
        eng.step()
    (parked,) = eng._swap_bundles.values()
    assert parked.shared and eng._pool.refcount(parked.shared[0]) >= 2  # the bundle's reference
    victim = next(r for r in reqs if r.request_id == parked.request_id)
    if route == "cancel":
        assert eng.cancel(victim.request_id) and victim.status == "cancelled"
    elif route == "deadline":
        clock.t += 5.0
        eng.step()
        assert victim.status == "timed_out"
    else:
        real = eng._decode

        def fault(boundary):
            eng._decode = real
            raise RuntimeError("injected decode fault")

        eng._decode = fault
        eng.step()
        assert victim.status == "queued" and eng.stats()["failed"] == 1
    assert not eng._swap_bundles
    eng.run_until_idle()
    if route == "decode_fault":  # the queued victim replays from its prompt
        assert victim.status == "ok"
        np.testing.assert_array_equal(victim.result, _ref(t_model, victim.prompt, 14))
    assert eng.stats()["preemption"]["swapped_waiting"] == 0
    assert eng._pool.in_use == eng._prefix_index.cached_blocks and eng._pool.leaked() == 0
    eng._prefix_index.flush(eng._pool)
    assert eng._pool.in_use == 0 and eng._pool.leaked() == 0


# -- (h) the constructor's validation -----------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(preemption="bogus"), dict(kv_layout="dense", preemption="recompute"),
    dict(kv_layout="dense", preemption="swap"),
    dict(kv_layout="paged", preemption="recompute", admit_headroom_blocks=-1),
    dict(kv_layout="paged", preemption="swap", swap_link_gbps=0.0),
], ids=["mode", "dense_recompute", "dense_swap", "headroom", "link_rate"])
def test_constructor_validation_matches_jax(pair, kwargs):
    j_model, params, t_model = pair
    table = dict(prompt_lens=(8,), batch_sizes=(1,))
    with pytest.raises(ValueError) as j_err:
        JaxSlotServingEngine(j_model, params, JaxGenerationConfig(num_latents=2),
                             JaxBucketTable(**table), slots=2, **kwargs)
    with pytest.raises(ValueError) as err:
        SlotServingEngine(t_model, BASE, BucketTable(**table), slots=2, device="cpu", **kwargs)
    assert str(err.value) == str(j_err.value)
    assert PREEMPTION_MODES == ("off", "recompute", "swap", "auto")


def test_preemption_ported_and_the_rest_still_deferred(pair):
    _, _, t_model = pair
    for mode in ("recompute", "swap", "auto"):
        eng = SlotServingEngine(t_model, BASE, slots=2, kv_layout="paged_int8", preemption=mode,
                                device="cpu")
        assert eng.health()["preemption"] == mode and eng.stats()["preemption"]["mode"] == mode
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlotServingEngine(t_model, BASE, slots=2, preemption="swap", device="cpu", mesh=object())
    # speculation and kv_layout="auto" are ported: preemption composes with
    # speculation over a paged pool, and an "auto" layout defers the pool check
    eng = SlotServingEngine(t_model, BASE, slots=2, kv_layout="paged", preemption="swap",
                            speculation="k2d1", device="cpu")
    assert eng.stats()["speculation"]["k"] == 2 and eng.health()["preemption"] == "swap"
    eng = SlotServingEngine(t_model, BASE, slots=2, kv_layout="auto", preemption="swap",
                            device="cpu")
    assert eng.kv_layout == "dense"


def test_cpu_preemption_runs_no_kernel(pair):
    before = ragged_paged_attention.launches
    prompts, news, subs, kw = SCRIPTS["longtail_swap"]
    eng, cfg = _build(pair, kw, jax_side=False)
    _drive(eng, cfg, prompts, news, subs)
    assert eng.stats()["preemption"]["swaps"] > 0
    assert ragged_paged_attention.launches == before
    assert eng.stats()["kv_ragged_kernel_steps_total"] == 0
