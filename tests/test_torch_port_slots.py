"""The port's slot engine against the JAX package, on the CPU.

One JAX model (the tiny config of ``tests/test_slots.py``: vocab 71, context
32, 8 latents, 16 channels, 2 heads, 1 layer) is converted once with
``load_jax_params`` and served by the port's ``SlotServingEngine`` in all
three KV layouts. The ragged script admits 5 requests through 2 slots: later
requests enter recycled slots mid-flight, rows cross into the boundary phase
at different steps, and ``max_new_tokens`` differs per request. Bars: tokens
equal to the JAX ``SlotServingEngine`` (dense, paged, paged_int8) and to the
port's per-request ``generate()`` (dense, paged; the int8 layout is lossy),
for both decode strategies; the pool never leaks. Also the pool gate, EOS
and deadline retirement, cancellation, the scope rejections, the deferred
arguments (and prefix sharing refused under the dense layout), and the
``KVPagePool`` unit checks of ``tests/test_paged_kv.py`` on the port's copy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.ragged_attention import ragged_paged_attention
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import HEALTH_KEYS
from perceiver_io_tpu_torch.serving.kv_pool import KVPagePool, PoolExhausted
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

TINY = dict(vocab_size=71, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=1)
BUCKETS = dict(prompt_lens=(8, 16), batch_sizes=(1,))
CFG = GenerationConfig(max_new_tokens=10, num_latents=2)
# 5 requests through 2 slots: num_latents 2 of 8, so rows with more than 6
# new tokens cross into the boundary phase, each at its own step
LENS = [3, 11, 8, 3, 11]
NEWS = [10, 4, 10, 7, 10]


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
    params = j_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32), 8)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 71, size=n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def reference(pair, prompts):
    """Per-request port ``generate()``, the parity oracle."""
    _, _, t_model = pair
    return [generate(t_model, p[None], dataclasses.replace(CFG, max_new_tokens=k),
                     device="cpu")[0].numpy() for p, k in zip(prompts, NEWS)]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(t_model, layout="dense", **kw):
    if layout != "dense":
        kw.setdefault("kv_block_size", 8)
    return SlotServingEngine(t_model, CFG, BucketTable(**BUCKETS), slots=2, kv_layout=layout,
                             device="cpu", **kw)


def _serve(engine, prompts, news=NEWS):
    reqs = [engine.submit(p, dataclasses.replace(CFG, max_new_tokens=k))
            for p, k in zip(prompts, news)]
    engine.run_until_idle()
    assert all(r.status == "ok" for r in reqs)
    return [r.result for r in reqs]


def _assert_no_leak(engine):
    if engine._pool is not None:
        assert engine._pool.in_use == 0 and engine._pool.reserved == 0
        assert engine._pool.leaked() == 0
        assert engine.health()["kv_pool_leaked"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged", "paged_int8"])
def test_slot_engine_matches_jax_slot_engine(pair, prompts, layout):
    j_model, params, t_model = pair
    j_cfg = JaxGenerationConfig(max_new_tokens=CFG.max_new_tokens, num_latents=CFG.num_latents)
    sizing = {} if layout == "dense" else {"kv_block_size": 8}
    j_eng = JaxSlotServingEngine(j_model, params, j_cfg, JaxBucketTable(**BUCKETS), slots=2,
                                 kv_layout=layout, **sizing)
    j_reqs = [j_eng.submit(p, config=dataclasses.replace(j_cfg, max_new_tokens=k))
              for p, k in zip(prompts, NEWS)]
    j_eng.run_until_idle()

    t_eng = _engine(t_model, layout)  # the same converted model serves every layout
    served = _serve(t_eng, prompts)
    for j_req, row in zip(j_reqs, served):
        np.testing.assert_array_equal(row, np.asarray(j_req.result))
    t_stats, j_stats = t_eng.stats(), j_eng.stats()
    assert t_stats["decode_steps"] == j_stats["decode_steps"]
    assert t_stats["prefills"] == j_stats["prefills"] == 5
    assert t_stats["boundary_steps"] > 0 and t_stats["kv_layout"] == layout
    if layout != "dense":
        for key in ("allocs_total", "frees_total", "high_water"):
            assert t_stats["kv_pool"][key] == j_stats["kv_pool"][key]
    # no kernel on the CPU: the paged attends ran the gather reference
    assert t_stats["kv_ragged_kernel_steps_total"] == 0
    _assert_no_leak(t_eng)


@pytest.mark.parametrize("strategy", ["cached", "recompute"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_slot_engine_matches_per_request_generate(pair, prompts, reference, layout, strategy):
    _, _, t_model = pair
    eng = _engine(t_model, layout, decode_strategy=strategy)
    for row, ref in zip(_serve(eng, prompts), reference):
        np.testing.assert_array_equal(row, ref)
    stats = eng.stats()
    assert stats["decode_strategy_boundary"] == strategy
    # continuous refill: fewer steps than serving the requests one by one
    assert stats["decode_steps"] < sum(NEWS)
    assert 0.0 < stats["slot_occupancy"] <= 1.0 and stats["ttft_ms"]["p50"] is not None
    _assert_no_leak(eng)


def test_undersized_pool_queues_and_rejects_never_fits(pair, prompts, reference):
    _, _, t_model = pair
    # 3 blocks of 8: two 21-position requests (3 blocks each) cannot be
    # resident together, so the second waits at the queue head for the
    # first's pages; a 27-position request can never fit
    eng = _engine(t_model, "paged", kv_blocks=3)
    with pytest.raises(ValueError, match="can never be admitted"):
        eng.submit(prompts[1], dataclasses.replace(CFG, max_new_tokens=16))  # 27 > 24 positions
    assert eng.stats()["rejected"] == 1
    served = _serve(eng, [prompts[1], prompts[4]], news=[10, 10])
    np.testing.assert_array_equal(served[0], generate(t_model, prompts[1][None], CFG, device="cpu")[0])
    np.testing.assert_array_equal(served[1], reference[4])
    stats = eng.stats()
    assert stats["kv_pool_admit_waits_total"] == 1 and stats["kv_pool"]["admit_waits"] == 1
    assert stats["kv_pool"]["high_water"] == 3
    _assert_no_leak(eng)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eos_and_deadline_retirement_free_the_slot(pair, prompts, reference, layout):
    _, _, t_model = pair
    # EOS: a token request 0 greedily emits early, so it retires before
    # max_new_tokens and the queued request takes its one slot
    eos = int(reference[0][2])
    cfg = dataclasses.replace(CFG, eos_token_id=eos)
    sizing = {} if layout == "dense" else {"kv_block_size": 8}
    eng = SlotServingEngine(t_model, cfg, BucketTable(**BUCKETS), slots=1, kv_layout=layout,
                            device="cpu", **sizing)
    first, second = eng.submit(prompts[0]), eng.submit(prompts[2])
    eng.run_until_idle()
    alone = [generate(t_model, p[None], cfg, device="cpu")[0].numpy() for p in (prompts[0], prompts[2])]
    np.testing.assert_array_equal(first.result, alone[0])
    np.testing.assert_array_equal(second.result, alone[1])

    def emitted(row):
        hits = np.flatnonzero(row == eos)
        return int(hits[0]) + 1 if hits.size else len(row)

    assert emitted(first.result) <= 3 and (first.result[emitted(first.result):] == 0).all()
    assert eng.stats()["decode_steps"] == emitted(first.result) + emitted(second.result)
    _assert_no_leak(eng)

    # deadline mid-generation: the request retires timed_out after 2 tokens
    # and the queued one is admitted into its slot
    clock = _Clock()
    eng = SlotServingEngine(t_model, CFG, BucketTable(**BUCKETS), slots=1, kv_layout=layout,
                            clock=clock, device="cpu", **sizing)
    late = eng.submit(prompts[0], deadline_s=5.0)
    keep = eng.submit(prompts[2])
    eng.step()
    eng.step()
    clock.t = 10.0
    eng.step()
    assert late.status == "timed_out" and "after 2 of 10 tokens" in late.error
    assert eng._slots[0].req is keep
    eng.run_until_idle()
    np.testing.assert_array_equal(keep.result, reference[2])
    assert eng.health()["timed_out"] == 1 and eng.health()["completed"] == 1
    _assert_no_leak(eng)


def test_cancel_drain_stats_and_health(pair, prompts, reference):
    _, _, t_model = pair
    eng = _engine(t_model, "paged_int8")
    assert HEALTH_KEYS <= set(eng.health())
    reqs = [eng.submit(p) for p in prompts[:3]]
    eng.step()
    assert eng.cancel(reqs[0].request_id)  # resident: retires, pages return at once
    assert reqs[0].status == "cancelled" and eng._pool.mapped_blocks(0) == 0
    assert eng.cancel(reqs[2].request_id)  # queued
    assert not eng.cancel(12345)
    assert eng.drain() == 1 and reqs[1].status == "ok"
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(prompts[0])
    stats, health = eng.stats(), eng.health()
    assert stats["cancelled"] == 2 and stats["kv_pool"]["dtype"] == "int8"
    assert stats["kv_pool"]["frees_by_cause"]["cancelled"] > 0
    assert stats["kv_pool_block_allocs_total"] == stats["kv_pool_block_frees_total"] > 0
    assert health["slots"] == 2 and health["slots_active"] == 0 and health["kv_layout"] == "paged_int8"
    _assert_no_leak(eng)


def test_scope_rejections(pair):
    _, _, t_model = pair
    eng = _engine(t_model)
    with pytest.raises(ValueError, match="overruns the context"):
        eng.submit(np.ones(16, np.int32), dataclasses.replace(CFG, max_new_tokens=17))
    with pytest.raises(ValueError, match="left pads would occupy latent slots"):
        SlotServingEngine(t_model, GenerationConfig(max_new_tokens=4, num_latents=8), BucketTable(**BUCKETS),
                          slots=2, device="cpu").submit(np.ones(5, np.int32))
    with pytest.raises(ValueError, match="share the engine GenerationConfig"):
        eng.submit(np.ones(4, np.int32), dataclasses.replace(CFG, num_latents=3))
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.submit(np.ones(4, np.int32), dataclasses.replace(CFG, max_new_tokens=0))
    assert eng.stats()["rejected"] == 3 and not eng.pending()
    with pytest.raises(ValueError, match="sizing the pool"):
        SlotServingEngine(t_model, CFG, slots=2, kv_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        SlotServingEngine(t_model, CFG, slots=2, kv_layout="sparse", device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(prefix_cache="auto"), dict(prefix_cache="on"), dict(preemption="recompute"),
    dict(speculation="k2d1"), dict(mesh=object()), dict(kv_layout="auto"),
    dict(config=dataclasses.replace(CFG, sampling=dataclasses.replace(CFG.sampling, do_sample=True))),
], ids=["prefix_cache_auto", "prefix_cache_on_dense", "preemption", "speculation", "mesh",
        "kv_layout_auto", "do_sample"])
def test_deferred_arguments_raise(pair, kwargs):
    _, _, t_model = pair
    kwargs = dict(kwargs)
    config = kwargs.pop("config", CFG)
    if kwargs.get("prefix_cache") == "on":
        # ported, but sharing needs block tables: the dense layout refuses it, as in JAX
        with pytest.raises(ValueError, match="requires kv_layout='paged'"):
            SlotServingEngine(t_model, config, slots=2, device="cpu", **kwargs)
        return
    if "preemption" in kwargs:
        # ported, but lazy pages need a block pool: the dense layout refuses it, as in JAX
        with pytest.raises(ValueError, match="lazy pages need kv_layout='paged'"):
            SlotServingEngine(t_model, config, slots=2, device="cpu", **kwargs)
        return
    if "mesh" in kwargs:
        # ported (tests/test_torch_port_sharding.py): a mesh that is not one
        # raises JAX's TypeError
        with pytest.raises(TypeError, match="mesh must be"):
            SlotServingEngine(t_model, config, slots=2, device="cpu", **kwargs)
        return
    if config.sampling.do_sample:
        # ported (tests/test_torch_port_sample.py): the engine builds and samples
        eng = SlotServingEngine(t_model, config, slots=2, device="cpu", **kwargs)
        assert eng.config.sampling.do_sample and eng.serve([np.ones(4, np.int32)])[0].size == 10
        return
    # ported: the "auto" axes resolve through the (empty) registry to their
    # defaults, and speculation takes its mode
    eng = SlotServingEngine(t_model, config, slots=2, device="cpu", **kwargs)
    assert (eng.kv_layout, eng.prefix_cache) == ("dense", "off")
    assert eng.speculation == kwargs.get("speculation", "off")


def test_paged_cpu_path_runs_no_kernel(pair, prompts):
    # CPU tensors take the gather reference, never the kernel's wrapper
    _, _, t_model = pair
    before = ragged_paged_attention.launches
    _serve(_engine(t_model, "paged"), prompts[:2], news=NEWS[:2])
    assert ragged_paged_attention.launches == before


# -- the port's KVPagePool copy, as tests/test_paged_kv.py checks the JAX one
def test_allocator_deterministic_order_and_zero_leak():
    pool = KVPagePool(num_blocks=6, block_size=4, slots=3, max_len=16)
    assert pool.pages_per_slot == 4
    assert pool.blocks_needed(9) == 3 and pool.blocks_needed(0) == 0
    pool.reserve(0, 9)
    pool.reserve(1, 5)
    assert pool.reserved == 5 and pool.in_use == 0
    assert pool.ensure(0, 4)
    assert pool.table_row(0)[0] == 1
    assert pool.ensure(1, 5)
    assert list(pool.table_row(1)[:2]) == [2, 3]
    assert pool.ensure(0, 9)
    assert list(pool.table_row(0)[:3]) == [1, 4, 5]
    assert not pool.ensure(0, 9)
    assert pool.in_use == 5 and pool.high_water == 5
    assert not pool.can_reserve(2)
    with pytest.raises(PoolExhausted):
        pool.reserve(2, 8)
    assert pool.release(0) == 3
    assert list(pool.table_row(0)) == [0, 0, 0, 0]
    pool.reserve(2, 8)
    pool.ensure(2, 8)
    assert list(pool.table_row(2)[:2]) == [1, 4]
    pool.release(1)
    pool.release(2)
    assert pool.in_use == 0 and pool.reserved == 0 and pool.leaked() == 0
    assert pool.allocs_total == pool.frees_total == 7
    pool.reserve(0, 4)
    with pytest.raises(ValueError, match="already holds"):
        pool.reserve(0, 4)
    with pytest.raises(ValueError, match="past its reservation"):
        pool.ensure(0, 16)


def test_allocator_schedule_determinism_under_fake_clock(pair, prompts):
    # two engines through one scripted schedule (admits, a mid-generation
    # deadline retirement, refills) give identical block-table histories
    _, _, t_model = pair

    def run():
        clock = _Clock()
        eng = SlotServingEngine(t_model, dataclasses.replace(CFG, max_new_tokens=6),
                                BucketTable(prompt_lens=(16,), batch_sizes=(1,)), slots=2,
                                clock=clock, kv_layout="paged", kv_block_size=8, device="cpu")
        eng.submit(prompts[0][:3], deadline_s=5.0)
        eng.submit(prompts[2])
        eng.submit(prompts[3])
        history = []
        for _ in range(2):
            eng.step()
            history.append(eng._pool.table().copy())
        clock.t = 10.0
        while eng.pending():
            eng.step()
            history.append(eng._pool.table().copy())
        return eng, history

    e1, h1 = run()
    e2, h2 = run()
    assert len(h1) == len(h2)
    for a, b in zip(h1, h2):
        np.testing.assert_array_equal(a, b)
    assert e1._pool.allocs_total == e1._pool.frees_total > 0
    _assert_no_leak(e1)
