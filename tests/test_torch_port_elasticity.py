"""The port's fleet elasticity (``serving/autoscaler.py``, the fleet's
``add_replica`` / ``remove_replica``, the slot engine's ``evacuate`` and
``resize_slots``) against the JAX package's, on the CPU.

Every script of JAX's ``tests/test_elasticity.py`` (its bench probe
excepted; the CLI's ``--serve.autoscale.*`` runs are in
``tests/test_torch_port_cli.py``) runs through both packages over the same
tiny CLM, ``FakeClock`` schedule and chaos script, the paged slot engine
in every replica. Held exactly: tokens, statuses, the fleet and autoscaler
registry (counters, gauges, histogram counts), the autoscaler's rung and
its scale-event sequence (``autoscaler.*`` events with their attributes),
every pool's ``frees_by_cause`` (retired replicas' included), the flash
crowd's per-request TTFT probe records and ``obs report``'s elasticity
section; then each script's own bars from JAX's test on the port's run.
"""
import http.client
import json

import numpy as np
import pytest
import torch

from tests import _torch_port_serving as K

TINY = dict(vocab_size=97, max_seq_len=32, max_latents=16, num_channels=16, num_heads=2,
            num_self_attention_layers=1, cross_attention_dropout=0.0)
STEP_COST = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def S():
    return K.sides(K.tiny_pair(**TINY))


def _prompts(n=6, lengths=(5, 7, 8, 6, 5, 7, 9, 6)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, TINY["vocab_size"], size=int(n_)).astype(np.int32) for n_ in lengths[:n]]


def _gen(s, **kw):
    return s.gen(**{"max_new_tokens": 6, "num_latents": 4, **kw})


def _factory(s, clock, *, slots=2, gen=None):
    return lambda: s.slot(gen or _gen(s), s.table((16,)), slots=slots, clock=clock, kv_layout="paged")


def _fleet(s, *, n=1, clock=None, chaos=None, slots=2, **kw):
    clock = clock or s.rel.FakeClock()
    fleet = s.serving.FleetRouter([_factory(s, clock, slots=slots)] * n, clock=clock, chaos=chaos,
                                  tracer=s.obs.Tracer(clock=clock), **kw)
    return fleet, clock


def _pool(engine) -> dict:
    st = engine._pool.stats()
    return {k: st[k] for k in ("in_use", "reserved", "leaked", "frees_by_cause")}


def _scale_events(tracer) -> list:
    return [sp for sp in K.span_view(tracer) if sp[0].startswith("autoscaler.")]


# -- the scripts ------------------------------------------------------------
def spike_schedule(s):
    class _Null:
        def submit(self, *a, **k):  # pragma: no cover - never driven
            raise AssertionError

        def step(self):
            return 0

        def pending(self):
            return False

    def gaps(seed):
        return s.obs.LoadGenerator(
            _Null(), arrival="spike", rate_rps=10.0, spike_factor=5.0, spike_start_s=2.0,
            spike_duration_s=3.0, max_requests=64, rng=seed, clock=s.rel.FakeClock())._gaps()

    errors = []
    for kw in (dict(rate_rps=1.0), dict(rate_rps=1.0, spike_factor=0.0, spike_duration_s=1.0),
               dict(rate_rps=1.0, spike_start_s=-1.0, spike_duration_s=1.0)):
        try:
            s.obs.LoadGenerator(_Null(), arrival="spike", rng=0, **kw)
        except ValueError as e:
            errors.append(str(e))
    return {"a": gaps(7), "b": gaps(8), "errors": errors}


def validation(s):
    fleet, _ = _fleet(s)
    errors = []
    for kw in (dict(max_replicas=0), dict(max_replicas=2, min_replicas=0),
               dict(max_replicas=2, up_evidence=0), dict(max_replicas=2, queue_low=2.0, queue_high=1.0),
               dict(max_replicas=2, scale_up_slots=0)):
        try:
            s.serving.FleetAutoscaler(fleet, **kw)
        except ValueError as e:
            errors.append(str(e))
    scaler = s.serving.FleetAutoscaler(fleet, max_replicas=3)
    return {"errors": errors, "installed": fleet.autoscaler is scaler, "rung": scaler.rung,
            "stats": scaler.stats(), "registry": K.registry_view(fleet.registry)}


def bookkeeping(s):
    fleet, _ = _fleet(s, n=2)
    reqs = [fleet.submit(p) for p in _prompts(6)]
    fleet.step()
    ids = [fleet.add_replica().replica_id, fleet.registry.gauge("fleet_replicas")]
    fleet.step()
    removed = fleet.remove_replica(0)
    ids += [removed.replica_id, [r.replica_id for r in fleet.replicas], fleet.add_replica().replica_id]
    fleet.run_until_idle()
    health = fleet.health()["replicas"]
    fleet.remove_replica(3)
    fleet.remove_replica(2)
    try:
        fleet.remove_replica(1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(K.fleet_view(fleet, reqs), ids=ids, health_replicas=health, refused=refused,
                ready=fleet.health()["ready"], removed_pool=_pool(removed.engine))


def scale_down_mid_flight(s):
    prompts = _prompts(6)
    ref_fleet, _ = _fleet(s, n=1)
    ref = [ref_fleet.submit(p) for p in prompts]
    ref_fleet.run_until_idle()
    fleet, _ = _fleet(s, n=2)
    reqs = [fleet.submit(p) for p in prompts]
    for _ in range(2):
        fleet.step()
    victim = fleet.replicas[0]
    in_flight = len(victim.handles)
    removed = fleet.remove_replica(victim.replica_id)
    at_removal = _pool(removed.engine)
    ready = fleet.health()["ready"]
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, reqs), ref=K.tokens(ref), in_flight=in_flight, at_removal=at_removal,
                ready=ready, survivors=[_pool(r.engine) for r in fleet.replicas],
                victim_counters={k: v for k, v in removed.engine.registry.counters().items()
                                 if k not in K.PORT_ONLY})


def victim_excludes_open(s):
    fleet, clock = _fleet(s, n=3)
    scaler = s.serving.FleetAutoscaler(fleet, min_replicas=3, max_replicas=4, up_cooldown_s=0.0,
                                       up_evidence=1)
    open_replica = fleet.replicas[0]
    open_replica.breaker.state = "open"
    open_replica.breaker.opened_at = clock()
    open_replica.handles[999] = object()
    fleet._update_gauges()
    capacity = scaler._capacity()
    victim = fleet.scale_down_victim().replica_id
    action = scaler.poll()
    open_replica.handles.clear()
    return {"capacity": capacity, "victim": victim, "action": action, "replicas": len(fleet.replicas),
            "healthy": fleet.stats()["replicas_healthy"], "events": _scale_events(fleet.tracer),
            "registry": K.registry_view(fleet.registry)}


def chaos_sites(s):
    chaos = s.rel.ChaosRegistry()
    chaos.fail_scale_up(1)
    fleet, clock = _fleet(s, n=1, chaos=chaos)
    scaler = s.serving.FleetAutoscaler(fleet, max_replicas=2, up_cooldown_s=1.0, up_evidence=1,
                                       queue_high=0.0, queue_low=0.0)
    reqs = [fleet.submit(p) for p in _prompts(4)]
    actions = [scaler.poll(), len(fleet.replicas), scaler.spawn_failures, scaler.poll()]
    clock.advance(1.1)
    actions += [scaler.poll(), len(fleet.replicas)]
    chaos.crash_scale_down(1)
    fleet.step()
    victim = next(r for r in fleet.replicas if r.handles)
    removed = fleet.remove_replica(victim.replica_id)
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, reqs), actions=actions, removed=removed.replica_id,
                removed_pool=_pool(removed.engine),
                fired=[chaos.fired_count("fleet.scale_up"), chaos.fired_count("fleet.scale_down")])


def flash_crowd(s):
    gen_cfg = _gen(s, max_new_tokens=8)
    workload = s.obs.WorkloadSpec(prompt_len=(5, 12), max_new_tokens=(6, 8), vocab=(1, TINY["vocab_size"]))

    def build(clock, autoscale, registry, tracer, monitor):
        fleet = s.serving.FleetRouter([_factory(s, clock, slots=1, gen=gen_cfg)], clock=clock,
                                      registry=registry, tracer=tracer, slo_monitor=monitor)
        scaler = s.serving.FleetAutoscaler(
            fleet, min_replicas=1, max_replicas=3, up_cooldown_s=0.3, down_cooldown_s=2.0, up_evidence=2,
            down_evidence=25, queue_high=1.0, queue_low=0.5) if autoscale else None
        return fleet, scaler

    cal_clock = s.rel.FakeClock()
    cal_fleet, _ = build(cal_clock, False, s.obs.MetricsRegistry(clock=cal_clock), None, None)
    cal = s.obs.LoadGenerator(cal_fleet, workload=workload, mode="closed", users=1, max_requests=6, rng=0,
                              clock=cal_clock, step_cost_s=STEP_COST).run()
    base_rps = max(cal["completed_rps"], 0.1)
    target_ms = 3.0 * max(cal_fleet.registry.percentile("serving_ttft_ms", 95.0) or 0.0, STEP_COST * 1e3)

    def one(autoscale):
        clock = s.rel.FakeClock()
        registry = s.obs.MetricsRegistry(clock=clock)
        tracer = s.obs.Tracer(clock=clock)
        monitor = s.slo.SLOMonitor(s.slo.SLOPolicy(ttft_p95_ms=target_ms), clock=clock, registry=registry,
                                   tracer=tracer, fast_window_s=1.0, slow_window_s=4.0, breach_burn_rate=1.5,
                                   min_samples=4)
        fleet, scaler = build(clock, autoscale, registry, tracer, monitor)
        probe = s.obs.TTFTProbe(fleet, clock)
        s.obs.LoadGenerator(probe, workload=workload, mode="open", arrival="spike", rate_rps=0.8 * base_rps,
                            spike_factor=3.0, spike_start_s=1.0, spike_duration_s=4.0, max_requests=24,
                            config=gen_cfg, rng=1, clock=clock, step_cost_s=STEP_COST).run()
        for _ in range(600):
            if scaler is None or len(fleet.replicas) <= scaler.min_replicas:
                break
            fleet.step()
            clock.advance(STEP_COST)
        return {
            "records": [(r["handle"].status, np.asarray(r["handle"].result).tolist(), r.get("ttft_ms"))
                        for r in probe.records],
            "good": probe.good_under(target_ms),
            "p95": registry.percentile("serving_ttft_ms", 95.0),
            "registry": K.registry_view(registry),
            "events": _scale_events(tracer),
            "scaler": None if scaler is None else dict(scaler.stats(), retired=scaler.retired),
            "pools": [_pool(r.engine) for r in fleet.replicas],
            "stats": {k: fleet.stats()[k] for k in ("failed", "queued", "dispatched")},
            "report": s.report.analyze([sp.to_row() for sp in tracer.spans()], registry.snapshot())["elasticity"],
        }

    return {"base_rps": base_rps, "target_ms": target_ms, "static": one(False), "auto": one(True)}


def healthz_across_transitions(s):
    fleet, _ = _fleet(s, n=2)
    reqs = [fleet.submit(p) for p in _prompts(4)]
    fleet.step()
    readiness = []
    orig_step = fleet.step

    def probed_step():
        n = orig_step()
        readiness.append(fleet.health()["ready"])
        return n

    fleet.step = probed_step
    fleet.rolling_restart()
    fleet.add_replica()
    readiness.append(fleet.health()["ready"])
    fleet.remove_replica(fleet.scale_down_victim().replica_id)
    readiness.append(fleet.health()["ready"])
    fleet.run_until_idle()
    fleet.step = orig_step
    gateway = s.serving.StreamingGateway(fleet, registry=fleet.registry).run_in_thread()
    try:
        conn = http.client.HTTPConnection(gateway.host, gateway.port, timeout=10)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read().decode())
        conn.close()
    finally:
        gateway.close()
    view = K.fleet_view(fleet, reqs)
    # the payload's size: each replica's engine health has the port's pool
    # keys where JAX's has its mesh (ROADMAP.md, known differences)
    sent = view["registry"]["counters"].pop("gateway_bytes_sent_total")
    return dict(view, readiness=readiness, http_status=resp.status, sent=sent > 0,
                health={k: health[k] for k in ("ready", "replicas", "replicas_healthy", "draining")},
                detail=len(health["replica_detail"]))


def resize(s):
    clock = s.rel.FakeClock()
    engine = s.slot(_gen(s), s.table((16,)), slots=2, clock=clock, kv_layout="paged")
    prompts = _prompts(4)
    out = {"baseline": [np.asarray(r).tolist() for r in engine.serve(prompts)]}
    out["grow"] = [engine.resize_slots(4), engine.slots, len(engine._slots), engine._pool.slots,
                   engine._pool.num_blocks]
    out["grown"] = [np.asarray(r).tolist() for r in engine.serve(prompts)]
    out["shrink"] = [engine.resize_slots(2), engine.slots, engine._pool.num_blocks,
                     engine.resize_slots(2)]
    out["shrunk"] = [np.asarray(r).tolist() for r in engine.serve(prompts)]
    out["gauges"] = {k: v for k, v in engine.registry.snapshot()["gauges"].items()
                     if k.startswith(("serving_slots", "kv_pool_blocks"))}
    engine2 = s.slot(_gen(s), s.table((16,)), slots=2, clock=clock, kv_layout="paged")
    engine2.submit(prompts[0])
    engine2.step()
    refused = []
    for n in (4, 0):
        try:
            engine2.resize_slots(n)
        except (RuntimeError, ValueError) as e:
            refused.append((type(e).__name__, str(e)))
    engine2.drain()
    sized = s.slot(_gen(s), s.table((16,)), slots=2, clock=clock, kv_layout="paged", kv_blocks=9)
    sized.resize_slots(3)
    out.update(refused=refused, sized=[sized.slots, sized._pool.num_blocks, sized._pool.slots])
    return out


def evacuate(s):
    tracer = s.obs.Tracer(clock=s.rel.FakeClock())
    engine = s.slot(_gen(s), s.table((16,)), slots=2, clock=s.rel.FakeClock(), kv_layout="paged",
                    tracer=tracer)
    reqs = [engine.submit(p) for p in _prompts(5)]
    engine.step()
    in_use = engine._pool.in_use
    n = engine.evacuate(cause="scale_down")
    bucket = s.bucket(_gen(s), s.table((16,)), clock=s.rel.FakeClock(), tracer=tracer)
    breqs = [bucket.submit(p) for p in _prompts(3)]
    nb = bucket.evacuate(cause="scale_down")
    return {"in_use": in_use, "n": n, "nb": nb, "status": [r.status for r in reqs + breqs],
            "errors": [r.error for r in reqs + breqs], "done": all(r.done for r in reqs),
            "pool": _pool(engine), "pending": engine.pending(),
            "counters": {k: v for k, v in engine.registry.counters().items() if k not in K.PORT_ONLY},
            "spans": K.span_view(tracer)}


def help_coverage(s):
    chaos = s.rel.ChaosRegistry()
    chaos.fail_scale_up(1)
    fleet, _ = _fleet(s, n=1, chaos=chaos)
    scaler = s.serving.FleetAutoscaler(fleet, max_replicas=2, up_cooldown_s=0.0, up_evidence=1,
                                       queue_high=0.0, queue_low=0.0)
    fleet.submit(_prompts(1)[0])
    actions = [scaler.poll(), scaler.poll()]
    fleet.run_until_idle()
    fleet.remove_replica(fleet.scale_down_victim().replica_id)
    snap = fleet.registry.snapshot()
    published = sorted(n for n in (*snap["counters"], *snap["gauges"], *snap["histograms"])
                       if n.startswith(("fleet_scale_", "autoscaler_")))
    text = s.exporters.to_prometheus_text(fleet.registry)
    return {"actions": actions, "published": published,
            "missing": [n for n in published if n not in s.exporters.HELP_TEXT],
            "help_lines": [line for line in text.splitlines()
                           if line.startswith("# HELP") and line.split()[2] in published]}


def report_elasticity(s):
    chaos = s.rel.ChaosRegistry()
    chaos.fail_scale_up(1)
    fleet, _ = _fleet(s, n=1, chaos=chaos)
    scaler = s.serving.FleetAutoscaler(fleet, max_replicas=2, up_cooldown_s=0.0, up_evidence=1,
                                       queue_high=0.0, queue_low=0.0)
    reqs = [fleet.submit(p) for p in _prompts(3)]
    scaler.poll()
    scaler.poll()
    fleet.run_until_idle()
    analysis = s.report.analyze([sp.to_row() for sp in fleet.tracer.spans()], fleet.registry.snapshot())
    text = s.report.format_report(analysis)
    fixture = json.loads(s.report.run("tests/fixtures/events.jsonl", "tests/fixtures/metrics_snapshot.json",
                                      as_json=True))["elasticity"]
    fixture_text = s.report.run("tests/fixtures/events.jsonl", "tests/fixtures/metrics_snapshot.json")
    return {"status": [r.status for r in reqs], "section": analysis["elasticity"],
            "text": text.split("== elasticity ==")[1].split("\n==")[0], "fixture": fixture,
            "fixture_text": fixture_text.split("== elasticity ==")[1].split("\n==")[0],
            "empty": s.report.analyze([], {})["elasticity"]}


SCRIPTS = {f.__name__: f for f in (
    spike_schedule, validation, bookkeeping, scale_down_mid_flight, victim_excludes_open, chaos_sites,
    flash_crowd, healthz_across_transitions, resize, evacuate, help_coverage, report_elasticity)}
_RUNS = {}


def run(S, name):
    if name not in _RUNS:
        _RUNS[name] = {side: SCRIPTS[name](S[side]) for side in ("jax", "port")}
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(S, name):
    views = run(S, name)
    assert views["port"] == views["jax"]


# -- each script's own bars (JAX's test), on the port's run ----------------
def test_spike_schedule_and_validation(S):
    v = run(S, "spike_schedule")["port"]
    assert v["a"] != v["b"]
    arrivals = np.cumsum(v["a"])
    inside = [t for t in arrivals if 2.0 <= t < 5.0]
    assert len(inside) >= 2 * max(1, len(arrivals) - len(inside))
    assert any(abs(t - 2.0) < 1e-6 for t in arrivals)
    assert [("spike_duration_s" in e, "spike_factor" in e, "spike_start_s" in e) for e in v["errors"]] == \
        [(True, False, False), (False, True, False), (False, False, True)]
    w = run(S, "validation")["port"]
    assert len(w["errors"]) == 5 and w["installed"] and w["rung"] == "steady"


def test_bookkeeping_and_scale_down_mid_flight(S):
    b = run(S, "bookkeeping")["port"]
    assert b["ids"] == [2, 3, 0, [1, 2], 3] and b["status"] == ["ok"] * 6
    assert b["stats"]["scale_ups"] == 2 and b["stats"]["scale_downs"] == 3
    assert sum(b["stats"]["completed_by_replica"].values()) == 6
    assert b["health_replicas"] == 3 and "no healthy replica" in b["refused"] and b["ready"]
    v = run(S, "scale_down_mid_flight")["port"]
    assert v["in_flight"] > 0 and v["ready"]
    assert v["at_removal"]["in_use"] == v["at_removal"]["reserved"] == v["at_removal"]["leaked"] == 0
    assert v["at_removal"]["frees_by_cause"].get("scale_down", 0) > 0
    assert v["status"] == ["ok"] * 6 and v["tokens"] == v["ref"]
    assert v["stats"]["failovers"] == 1 and v["stats"]["redispatches"] == v["in_flight"]
    assert all(p["leaked"] == 0 and p["in_use"] == 0 for p in v["survivors"])
    assert v["victim_counters"]["serving_requests_cancelled_total"] == v["in_flight"]


def test_victim_choice_and_chaos_sites(S):
    v = run(S, "victim_excludes_open")["port"]
    assert v["capacity"] == 4 and v["victim"] != 0 and v["action"] == "scale_up"
    assert v["replicas"] == 4 and v["healthy"] == 3
    c = run(S, "chaos_sites")["port"]
    assert c["actions"] == ["spawn_failed", 1, 1, None, "scale_up", 2] and c["fired"] == [1, 1]
    assert c["status"] == ["ok"] * 4
    assert c["removed"] not in [r["replica_id"] for r in c["replicas"]]
    assert c["registry"]["counters"]["fleet_scale_up_failed_total"] == 1
    # crashed mid-drain: the evacuation never ran, its pool frees nothing
    assert "scale_down" not in c["removed_pool"]["frees_by_cause"]


def test_flash_crowd_breach_scale_up_recover_scale_down(S):
    v = run(S, "flash_crowd")["port"]
    auto, static = v["auto"], v["static"]
    assert auto["registry"]["counters"]["slo_breach_total"] >= 1
    sc = auto["scaler"]
    assert sc["scale_ups"] >= 1 and sc["scale_downs"] >= 1
    assert sc["replicas"] == 1 and sc["rung"] in ("steady", "recover")
    names = {e[0] for e in auto["events"]}
    assert {"autoscaler.scale_up", "autoscaler.scale_down", "autoscaler.rung"} <= names
    assert auto["good"] > static["good"] and auto["p95"] < static["p95"]
    for run_ in (static, auto):
        assert len(run_["records"]) == 24 and all(r[0] == "ok" for r in run_["records"])
    assert [r[1] for r in auto["records"]] == [r[1] for r in static["records"]]
    assert all(p["leaked"] == 0 and p["in_use"] == 0 for p in auto["pools"])
    assert all(r["pool"]["leaked"] == 0 and r["pool"]["in_use"] == 0 for r in sc["retired"])
    assert auto["stats"] == {"failed": 0, "queued": 0, "dispatched": 0}


def test_healthz_resize_evacuate(S):
    h = run(S, "healthz_across_transitions")["port"]
    assert h["readiness"] and all(h["readiness"]) and h["status"] == ["ok"] * 4
    assert h["http_status"] == 200 and h["detail"] == 2 and h["sent"]
    assert h["health"] == {"ready": True, "replicas": 2, "replicas_healthy": 2, "draining": 0}
    r = run(S, "resize")["port"]
    assert r["baseline"] == r["grown"] == r["shrunk"]
    assert r["grow"] == [2, 4, 4, 4, 8] and r["shrink"] == [4, 2, 4, 2]
    assert [e[0] for e in r["refused"]] == ["RuntimeError", "ValueError"]
    assert "resize_slots" in r["refused"][0][1] and r["sized"] == [3, 9, 3]
    e = run(S, "evacuate")["port"]
    assert e["in_use"] > 0 and e["n"] == 5 - e["status"][:5].count("ok") and e["nb"] == 3 and e["done"]
    assert e["pool"]["in_use"] == 0 and e["pool"]["leaked"] == 0
    assert e["pool"]["frees_by_cause"].get("scale_down", 0) > 0 and not e["pending"]
    assert e["counters"]["serving_requests_cancelled_total"] == e["n"]
    causes = [sp[3].get("cause") for sp in e["spans"] if sp[0] == "serving.cancelled"]
    assert causes == ["scale_down"] * (e["n"] + 3)


def test_help_and_report(S):
    h = run(S, "help_coverage")["port"]
    assert h["actions"] == ["spawn_failed", "scale_up"] and h["missing"] == []
    assert {"fleet_scale_up_total", "fleet_scale_down_total", "fleet_scale_up_failed_total",
            "autoscaler_evaluations_total", "autoscaler_ladder_rung"} <= set(h["published"])
    assert len(h["help_lines"]) == len(h["published"])
    r = run(S, "report_elasticity")["port"]
    assert r["status"] == ["ok"] * 3
    assert r["section"]["scale_ups"] == 1 and r["section"]["spawn_failures"] == 1
    assert {row["event"] for row in r["section"]["timeline"]} >= {"autoscaler.scale_up",
                                                                   "autoscaler.spawn_failed"}
    assert "scale-event timeline:" in r["text"]
    assert r["fixture"]["scale_ups"] == 1 and r["fixture"]["scale_downs"] == 1
    assert "autoscaler.scale_down" in r["fixture_text"] and r["empty"] is None
