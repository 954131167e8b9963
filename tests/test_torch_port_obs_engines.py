"""The port's serving engines with every telemetry attachment, against the
JAX package's on the same seeded schedule, on the CPU.

Both packages' engines get a registry, a tracer (streaming to
``events.jsonl``), a step timeline, a flight recorder and an SLO monitor
(``tests/_torch_port_obs.py``), all on one fake clock that never moves, and
serve the same requests:

- the slot engine over ``paged`` KV with a chunked admission, a shared
  prefix and a preemption (the pressured script of
  ``tests/test_torch_port_preempt.py``);
- the bucket engine over a ragged batch.

Bars: tokens equal to JAX's engine and to the same port engine run without
telemetry (and to per-request ``generate()``); registry counters, span
names, attributes and statuses (hence trace and span ids), terminal
statuses and timeline records equal to JAX's, with the wall-clock fields
of ``_torch_port_obs.CLOCK_ATTRS`` / ``CLOCK_ROW`` and each record's
``t_start_s``, ``t_end_s`` and phase ms compared for presence only; the
port-only counter ``serving_decode_boundary_steps_total`` left out. Then
chaos drills: a fault at ``serving.batch`` (with an error-rate SLO) and one
at ``kv.exhaust`` end with the same terminal spans, the same counters and
one incident bundle each, whose span accounting closes (one terminal
``serving.request`` span per submission, statuses equal to the counters).
Tolerance: equality everywhere.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.reliability import ChaosRegistry as JaxChaos
from perceiver_io_tpu.reliability import FakeClock as JaxFakeClock
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import ServingEngine as JaxServingEngine
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.reliability import ChaosRegistry, FakeClock
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import ServingEngine
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine
from tests import _torch_port_obs as C

PORT_ONLY = {"serving_decode_boundary_steps_total"}
BASE = dict(max_new_tokens=3, num_latents=2)
SLOT_KW = dict(slots=4, kv_layout="paged", kv_block_size=4, admit_headroom_blocks=0,
               preemption="recompute", prefix_cache="on")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: one intra-op thread is many times faster on a busy host
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    return C.tiny_pair()


NEWS = [14 if i % 2 else 3 for i in range(6)]


def _script(news=NEWS):
    """Six requests sharing an 8-token prefix, shorts and near-context longs."""
    rng = np.random.default_rng(11)
    base = [rng.integers(1, 64, size=int(n)).astype(np.int32) for n in [5, 7, 6, 4, 7, 5]]
    prompts = [np.concatenate([base[0][:8], p]).astype(np.int32)[:13] for p in base]
    return prompts, list(news)


def _slot_engine(pair, side, clock, k=None, chaos=None, **kw):
    kw = dict(SLOT_KW, **kw)
    obs = {} if k is None else dict(registry=k["registry"], tracer=k["tracer"])
    if side == "jax":
        j_model, params, _ = pair
        cfg = JaxGenerationConfig(**BASE)
        eng = JaxSlotServingEngine(j_model, params, cfg, JaxBucketTable(prompt_lens=(8, 16), batch_sizes=(1,)),
                                   clock=clock, chaos=chaos, **obs, **kw)
    else:
        cfg = GenerationConfig(**BASE)
        eng = SlotServingEngine(pair[2], cfg, BucketTable(prompt_lens=(8, 16), batch_sizes=(1,)),
                                clock=clock, chaos=chaos, device="cpu", **obs, **kw)
    if k is not None:
        C.attach(eng, k)
    return eng, cfg


def _drive(eng, cfg, prompts, news, k=None):
    reqs = [eng.submit(p, config=dataclasses.replace(cfg, max_new_tokens=n)) for p, n in zip(prompts, news)]
    while eng.pending():
        eng.step()
        if k is not None:
            k["slo"].poll()
    if k is not None:
        k["slo"].poll()
        k["sink"].close()
    return reqs


def _view(eng, reqs, k):
    counters = {c: v for c, v in k["registry"].counters().items() if c not in PORT_ONLY}
    return dict(
        tokens=[None if r.result is None else np.asarray(r.result).tolist() for r in reqs],
        status=[r.status for r in reqs], trace_ids=[r.trace_id for r in reqs], counters=counters,
        gauges=k["registry"].snapshot()["gauges"], histograms=sorted(k["registry"].snapshot()["histograms"]),
        spans=C.span_rows(k["tracer"]), timeline=C.mask_timeline(k["timeline"].records()),
        bundles=[C.bundle_view(b) for b in k["recorder"].bundles],
        slo=C.mask_timeline([dict(k["slo"].stats(), t_start_s=0, t_end_s=0, phases_ms={})]),
    )


_RUNS = {}


def _slot_runs(pair, tmp_root, name, chaos_fn=None, slo=None, news=NEWS):
    """Both packages' slot engines over the script, telemetry attached (each
    once); one pool geometry for every run, so JAX compiles it once."""
    if name not in _RUNS:
        prompts, news = _script(news)
        out = {}
        for side in ("jax", "port"):
            clock = (JaxFakeClock if side == "jax" else FakeClock)()
            chaos = None
            if chaos_fn is not None:
                chaos = (JaxChaos if side == "jax" else ChaosRegistry)()
                chaos_fn(chaos)
            k = C.kit(side, clock, os.path.join(tmp_root, name, side), slo=slo)
            eng, cfg = _slot_engine(pair, side, clock, k, chaos=chaos, **MAIN_KW)
            reqs = _drive(eng, cfg, prompts, news, k)
            out[side] = (eng, reqs, k, _view(eng, reqs, k))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("obs_engines"))


def _check_accounting(eng, reqs, k):
    """One terminal ``serving.request`` span per submission; its statuses
    equal the registry's disposition counters."""
    terminal = [s for s in k["tracer"].spans("serving.request")]
    assert sorted(s.trace_id for s in terminal) == sorted(r.trace_id for r in reqs)
    statuses = [s.status for s in terminal]
    reg = k["registry"]
    for status, name in (("ok", "completed"), ("failed", "failed"), ("timed_out", "timed_out")):
        assert statuses.count(status) == reg.counter(f"serving_requests_{name}_total")
    assert reg.counter("serving_requests_submitted_total") == len(reqs)


MAIN_KW = dict(kv_blocks=10, prefill_chunk=2)


def test_slot_engine_telemetry_equals_jax(pair, tmp_root):
    run = _slot_runs(pair, tmp_root, "main")
    j, p = run["jax"][3], run["port"][3]
    for key in ("tokens", "status", "trace_ids", "counters", "gauges", "histograms", "spans",
                "timeline", "bundles", "slo"):
        assert p[key] == j[key], key
    stats = run["port"][0].stats()
    # the script exercises what it is for
    assert stats["preemption"]["preemptions"] >= 1 and stats["prefix_cache"]["hits"] >= 1
    assert stats["prefill_chunks"] >= 1 and all(s == "ok" for s in p["status"])
    assert {r["span"] for r in p["spans"]} >= {
        "serving.request", "serving.slot_assigned", "serving.first_token", "serving.prefill_chunk",
        "serving.prefix_hit", "serving.preempted", "serving.readmitted", "serving.slot_retired"}
    _check_accounting(*run["port"][:3])


def test_slot_engine_telemetry_changes_no_token(pair, tmp_root):
    prompts, news = _script()
    run = _slot_runs(pair, tmp_root, "main")
    eng, cfg = _slot_engine(pair, "port", FakeClock(), **MAIN_KW)
    plain = [np.asarray(r.result).tolist() for r in _drive(eng, cfg, prompts, news)]
    assert plain == run["port"][3]["tokens"]
    ref = [generate(pair[2], pr[None], dataclasses.replace(cfg, max_new_tokens=n), device="cpu")[0].tolist()
           for pr, n in zip(prompts, news)]
    assert plain == ref
    # the engine's counters do not depend on telemetry either (the kit's
    # registry also holds the recorder's, the SLO monitor's and the timeline's)
    bare = {c: v for c, v in eng.registry.counters().items() if c not in PORT_ONLY}
    assert bare == {c: v for c, v in run["port"][3]["counters"].items() if c in bare}


def test_gauges_count_the_pools_own_tensors(pair, tmp_root):
    eng = _slot_runs(pair, tmp_root, "main")["port"][0]
    st, pool, reg = eng._state, eng._pool, eng.registry
    token_bytes = sum(st[key][0].numel() * st[key].element_size() for key in ("pool_k", "pool_v"))
    stack = sum(t.numel() * t.element_size() for t in st["stack_k"] + st["stack_v"])
    assert reg.gauge("kv_cache_resident_bytes") == pool.in_use * eng.kv_block_size * token_bytes + stack
    assert reg.gauge("kv_cache_capacity_bytes") == eng.kv_blocks * eng.kv_block_size * token_bytes + stack
    assert reg.gauge("kv_pool_blocks") == pool.num_blocks and reg.gauge("kv_ragged_kernel_enabled") == 0
    assert reg.gauge("serving_slots_active") == 0 and reg.gauge("serving_slots_idle") == eng.slots


DRILLS = {
    # a failed decode step fails its residents: an error-rate breach bundles.
    # Step 7 has no admission in flight (the port also fails an admission in
    # flight, JAX does not: ROADMAP.md C, Known differences)
    "serving_batch": dict(chaos_fn=lambda c: c.fail_batch(7), slo={"error_rate": 0.1}),
    # scripted pool pressure preempts a second victim, whose readmission
    # waits; the same traffic without the fault bundles nothing
    "kv_exhaust": dict(chaos_fn=lambda c: c.exhaust_kv(2), news=[3, 14, 3, 3, 3, 3]),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_chaos_drill_bundles_one_incident(pair, tmp_root, drill):
    run = _slot_runs(pair, tmp_root, drill, **DRILLS[drill])
    j, p = run["jax"][3], run["port"][3]
    for key in ("status", "trace_ids", "counters", "spans", "bundles"):
        assert p[key] == j[key], key
    assert len(p["bundles"]) == 1
    kind = {"serving_batch": "slo_breach", "kv_exhaust": "pool_exhausted"}[drill]
    assert p["bundles"][0]["name"] == f"incident-001-{kind}"
    if drill == "serving_batch":
        assert "failed" in p["status"]
    else:
        assert p["counters"]["kv_preemptions_total"] >= 2 and all(s == "ok" for s in p["status"])
    _check_accounting(*run["port"][:3])
    # obs incident renders the bundle in both packages alike
    from perceiver_io_tpu.observability import report as jax_report
    from perceiver_io_tpu_torch.observability import report as port_report

    j_text = jax_report.run_incident(run["jax"][2]["recorder"].bundles[0])
    p_text = port_report.run_incident(run["port"][2]["recorder"].bundles[0])
    assert p_text.splitlines()[0] == j_text.splitlines()[0] and kind in p_text


def test_bucket_engine_telemetry_equals_jax(pair, tmp_root):
    j_model, params, t_model = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, size=int(n)).astype(np.int32) for n in (3, 7, 5, 8, 2)]
    out = {}
    for side in ("jax", "port"):
        clock = (JaxFakeClock if side == "jax" else FakeClock)()
        k = C.kit(side, clock, os.path.join(tmp_root, "bucket", side))
        obs = dict(registry=k["registry"], tracer=k["tracer"], clock=clock)
        if side == "jax":
            cfg = JaxGenerationConfig(max_new_tokens=4, num_latents=2)
            eng = JaxServingEngine(j_model, params, cfg, JaxBucketTable((4, 8), (1, 2, 4)), **obs)
        else:
            cfg = GenerationConfig(max_new_tokens=4, num_latents=2)
            eng = ServingEngine(t_model, cfg, BucketTable((4, 8), (1, 2, 4)), device="cpu", **obs)
        C.attach(eng, k)
        reqs = [eng.submit(p) for p in prompts]
        with pytest.raises(ValueError) as rejected:
            eng.submit(np.ones(9, np.int32))  # longer than the largest bucket
        eng.cancel(reqs[-1].request_id)
        eng.run_until_idle()
        k["sink"].close()
        out[side] = dict(_view(eng, reqs, k), rejected=rejected.value.trace_id)
    j, p = out["jax"], out["port"]
    for key in ("tokens", "status", "trace_ids", "counters", "spans", "timeline", "rejected"):
        assert p[key] == j[key], key
    assert p["rejected"] is not None and p["status"][-1] == "cancelled"
    assert {r["span"] for r in p["spans"]} == {"serving.request", "serving.batch", "serving.first_token",
                                              "serving.cancelled"}
    plain = ServingEngine(t_model, GenerationConfig(max_new_tokens=4, num_latents=2),
                          BucketTable((4, 8), (1, 2, 4)), device="cpu")
    assert [r.tolist() for r in plain.serve(prompts[:-1])] == p["tokens"][:-1]


@pytest.mark.parametrize("engine_kind,mode", [("slots", "open"), ("bucket", "closed")])
def test_load_generator_drives_both_engines_as_jax(pair, engine_kind, mode):
    """``LoadGenerator`` on a fake clock it advances a fixed cost a step:
    the same report, tokens and token-latency percentiles over both
    packages' engines (open loop over the slot engine, closed over the
    bucket engine)."""
    from perceiver_io_tpu.observability import LoadGenerator as JaxLoadGenerator
    from perceiver_io_tpu.observability import WorkloadSpec as JaxWorkloadSpec
    from perceiver_io_tpu_torch.observability import LoadGenerator, WorkloadSpec

    j_model, params, t_model = pair
    out = {}
    for side in ("jax", "port"):
        clock = (JaxFakeClock if side == "jax" else FakeClock)()
        if engine_kind == "slots":
            eng, cfg = _slot_engine(pair, side, clock, **MAIN_KW)
        elif side == "jax":
            cfg = JaxGenerationConfig(max_new_tokens=4, num_latents=2)
            # one bucket cell, the (4, 8) the bucket test's batch ran: no new JAX compile
            eng = JaxServingEngine(j_model, params, cfg, JaxBucketTable((8,), (4,)), clock=clock)
        else:
            cfg = GenerationConfig(max_new_tokens=4, num_latents=2)
            eng = ServingEngine(t_model, cfg, BucketTable((8,), (4,)), clock=clock, device="cpu")
        # the bucket engine packs only equal configs: one max_new_tokens
        news = (2, 4) if engine_kind == "slots" else (4, 4)
        spec = (JaxWorkloadSpec if side == "jax" else WorkloadSpec)(
            prompt_len=(4, 8), max_new_tokens=news, vocab=(1, 64), think_time_s=(0.02, 0.05))
        gen = (JaxLoadGenerator if side == "jax" else LoadGenerator)(
            eng, workload=spec, mode=mode, arrival="poisson", rate_rps=40.0, users=2, max_requests=6,
            config=cfg, rng=3, clock=clock, step_cost_s=0.01)
        report = gen.run()
        stats = eng.stats()
        out[side] = (report, [None if h.result is None else np.asarray(h.result).tolist() for h in gen.handles],
                     stats["ttft_ms"], stats["inter_token_ms"])
    assert out["port"] == out["jax"]
    assert out["port"][0]["completed"] == 6 and out["port"][0]["goodput_ratio"] == 1.0
