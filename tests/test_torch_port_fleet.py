"""The port's supervised fleet router (``serving/fleet.py``) against the JAX
package's, on the CPU.

Every script of JAX's ``tests/test_fleet.py`` (its bench probe excepted;
the serve CLI's fleet run is in ``tests/test_torch_port_cli.py``) runs
through both packages over the same tiny CLM (JAX's params carried to the
port by ``convert/from_jax.py``), the same ``FakeClock`` schedule and the
same chaos script. Held exactly: tokens, statuses, dispatch counts, the
fleet registry's counters, gauges and histogram counts, each replica's
engine counters and pool frees by cause, ``stats()`` (less its latency
percentiles and per-replica engine stats) and every ``fleet.*`` span and
event with its attributes; then each script's own bars from JAX's test, on
the port's run. ``obs report``'s fleet section is compared over the two
runs' spans and snapshots.
"""
import random

import numpy as np
import pytest
import torch

from tests import _torch_port_serving as K

TINY = dict(vocab_size=79, max_seq_len=32, max_latents=16, num_channels=16, num_heads=2,
            num_self_attention_layers=1, cross_attention_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: one intra-op thread is many times faster on a busy host
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def S():
    return K.sides(K.tiny_pair(**TINY))


def _prompts(n=6, lengths=(5, 7, 8, 6, 5, 7)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, TINY["vocab_size"], size=int(n_)).astype(np.int32) for n_ in lengths[:n]]


def _gen(s):
    return s.gen(max_new_tokens=6, num_latents=4)


def _table(s):
    return s.table((8, 16), (1, 2))


def _factory(s, clock, **kw):
    return lambda: s.slot(_gen(s), _table(s), slots=2, clock=clock, **kw)


def _fleet(s, *, n=3, clock=None, chaos=None, tracer=True, **kw):
    clock = clock or s.rel.FakeClock()
    fleet = s.serving.FleetRouter([_factory(s, clock)] * n, clock=clock, chaos=chaos,
                                  tracer=s.obs.Tracer(clock=clock) if tracer else None, **kw)
    return fleet, clock


# -- the scripts: each returns the view both packages are held to ----------
def reference(s):
    fleet, _ = _fleet(s)
    reqs = [fleet.submit(p) for p in _prompts()]
    fleet.run_until_idle()
    return K.fleet_view(fleet, reqs)


def health_schema(s):
    clock = s.rel.FakeClock()
    bucket = s.bucket(_gen(s), _table(s), clock=clock)
    slot = s.slot(_gen(s), _table(s), slots=2, clock=clock)
    replica = s.serving.Replica(_factory(s, clock), 0, clock=clock)
    fleet, _ = _fleet(s, n=1)
    snaps = {"bucket": bucket.health(), "slot": slot.health(), "replica": replica.health(),
             "fleet": fleet.health()}
    return {"missing": {k: sorted(s.serving.HEALTH_KEYS - set(v)) for k, v in snaps.items()},
            "replica_fields": {k: snaps["replica"][k] for k in
                               ("replica_id", "breaker", "consecutive_failures", "in_flight", "restarts",
                                "draining")},
            "fleet": {k: v for k, v in snaps["fleet"].items() if k != "replica_detail"},
            "detail_missing": [sorted(s.serving.HEALTH_KEYS - set(d))
                               for d in snaps["fleet"]["replica_detail"]]}


def retry_jitter(s):
    base = s.rel.RetryPolicy(backoff_base_s=1.0, backoff_factor=2.0, backoff_max_s=30.0)
    jittered = s.rel.RetryPolicy(backoff_base_s=1.0, jitter=0.5)
    sleeps, attempts = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError("transient")
        return "ok"

    out = s.rel.call_with_retry(flaky, s.rel.RetryPolicy(max_retries=3, backoff_base_s=1.0, jitter=1.0),
                                sleep=sleeps.append, rng=random.Random(3))
    try:
        s.rel.RetryPolicy(jitter=-0.1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"base": [base.delay_s(k) for k in range(4)], "no_rng": jittered.delay_s(0),
            "seeded": [jittered.delay_s(k, rng=random.Random(7)) for k in range(3)],
            "call": out, "sleeps": sleeps, "refused": refused}


def breaker_lifecycle(s):
    clock = s.rel.FakeClock()
    br = s.fleet_mod.CircuitBreaker(failure_threshold=2, cooldown_s=10.0, clock=clock)
    seq = [br.poll(), br.record_failure()]
    br.record_success()
    seq += [br.record_failure(), br.record_failure(), br.poll()]
    clock.advance(9.0)
    seq.append(br.poll())
    clock.advance(1.0)
    seq += [br.poll(), br.record_failure(), br.opened_total]
    clock.advance(10.0)
    seq.append(br.poll())
    br.record_success()
    return {"seq": seq, "state": br.state, "failures": br.consecutive_failures}


def single_replica_identity(s):
    prompts = _prompts()
    engine = s.bucket(_gen(s), _table(s), clock=s.rel.FakeClock())
    direct = engine.serve(prompts)
    clock = s.rel.FakeClock()
    fleet = s.serving.FleetRouter([lambda: s.bucket(_gen(s), _table(s), clock=clock)], clock=clock,
                                  failover=False)
    via = fleet.serve(prompts)
    return {"direct": [np.asarray(r).tolist() for r in direct], "fleet": [np.asarray(r).tolist() for r in via],
            "engine_counters": {k: v for k, v in engine.registry.counters().items() if v},
            "view": K.fleet_view(fleet)}


def load_aware_dispatch(s):
    return reference(s)


def crash_mid_decode(s):
    chaos = s.rel.ChaosRegistry()
    chaos.crash_replica(0, 3)
    fleet, _ = _fleet(s, chaos=chaos)
    reqs = [fleet.submit(p) for p in _prompts()]
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, reqs), fired=chaos.fired_count("fleet.replica_step.0"))


def hung_replica(s):
    chaos = s.rel.ChaosRegistry()
    chaos.hang_replica(1, 2, delay_s=50.0)
    fleet, clock = _fleet(s, chaos=chaos, step_timeout_s=10.0, breaker_threshold=1, breaker_cooldown_s=5.0)
    reqs = [fleet.submit(p) for p in _prompts()]
    for _ in range(80):
        fleet.step()
        clock.advance(1.0)
        if not fleet.pending():
            break
    before_drain = K.tokens(reqs)
    fleet.drain()
    return dict(K.fleet_view(fleet, reqs), before_drain=before_drain)


def stale_copy_wins(s):
    chaos = s.rel.ChaosRegistry()
    chaos.hang_replica(0, 3, delay_s=50.0)
    fleet, clock = _fleet(s, n=1, chaos=chaos, step_timeout_s=10.0, breaker_threshold=2)
    reqs = [fleet.submit(p) for p in _prompts(2, lengths=(5, 7))]
    for _ in range(40):
        fleet.step()
        clock.advance(0.1)
        if not fleet.pending():
            break
    return K.fleet_view(fleet, reqs)


def breaker_reintegrates(s):
    chaos = s.rel.ChaosRegistry()
    chaos.crash_replica(0, 1, count=2)
    fleet, clock = _fleet(s, n=2, chaos=chaos, breaker_threshold=2, breaker_cooldown_s=30.0)
    replica0 = fleet.replicas[0]
    reqs = [fleet.submit(p) for p in _prompts(4)]
    for _ in range(30):
        fleet.step()
        if chaos.fired_count("fleet.replica_step.0") >= 1:
            break
    states = [replica0.breaker.state]
    reqs += [fleet.submit(p) for p in _prompts()[4:6]]
    for _ in range(30):
        fleet.step()
        if replica0.breaker.state == "open":
            break
    states += [replica0.breaker.state, fleet.registry.gauge("fleet_replicas_healthy")]
    fleet.run_until_idle()
    states += [replica0.breaker.state, len(replica0.handles)]
    clock.advance(30.0)
    probe = fleet.submit(_prompts()[0])
    fleet.step()
    states.append(replica0.breaker.state)
    fleet.run_until_idle()
    states += [replica0.breaker.state, fleet.registry.gauge("fleet_replicas_healthy")]
    return dict(K.fleet_view(fleet, reqs + [probe]), states=states)


def dispatch_fault_backoff(s):
    chaos = s.rel.ChaosRegistry()
    chaos.fail_dispatch(1)
    fleet, clock = _fleet(s, n=2, chaos=chaos,
                          redispatch_policy=s.rel.RetryPolicy(max_retries=3, backoff_base_s=2.0))
    req = fleet.submit(_prompts()[0])
    fleet.step()
    seen = [req.status, req.dispatches, req.not_before]
    fleet.step()
    seen.append(req.status)
    clock.advance(2.0)
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, [req]), seen=seen)


def poisoned_replica(s):
    clock = s.rel.FakeClock()

    def poisoned():
        poison = s.rel.ChaosRegistry()
        poison.add("serving.batch", "error", 1, count=10**6)
        return s.slot(_gen(s), _table(s), slots=2, clock=clock, chaos=poison)

    good = _factory(s, clock)
    fleet = s.serving.FleetRouter([poisoned, good, good], clock=clock, breaker_threshold=2,
                                  breaker_cooldown_s=1000.0)
    reqs = [fleet.submit(p) for p in _prompts(4)]
    fleet.run_until_idle()
    return K.fleet_view(fleet, reqs)


def dispatch_fault_opens_breaker(s):
    chaos = s.rel.ChaosRegistry()
    chaos.fail_dispatch(2)
    fleet, clock = _fleet(s, n=1, chaos=chaos, breaker_threshold=1, breaker_cooldown_s=5.0)
    a = fleet.submit(_prompts()[0])
    fleet.step()
    seen = [a.status]
    b = fleet.submit(_prompts()[1])
    fleet.step()
    seen += [a.status, b.status]
    try:
        fleet.run_until_idle()
    except RuntimeError as e:
        seen.append(str(e))
    clock.advance(5.0)
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, [a, b]), seen=seen)


def admission(s):
    fleet, clock = _fleet(s, n=2, max_pending=2, default_deadline_s=5.0)
    prompts = _prompts()
    reqs = [fleet.submit(prompts[0]), fleet.submit(prompts[1])]
    raised = []
    for p in (prompts[2], np.arange(1, 30, dtype=np.int32)):
        try:
            fleet.submit(p)
        except (s.rel.QueueFull, ValueError) as e:
            raised.append((type(e).__name__, str(e), e.trace_id))
    clock.advance(6.0)
    fleet.step()
    return dict(K.fleet_view(fleet, reqs), raised=raised)


def failover_disabled(s):
    chaos = s.rel.ChaosRegistry()
    chaos.crash_replica(0, 2)
    fleet, _ = _fleet(s, n=2, chaos=chaos, failover=False)
    reqs = [fleet.submit(p) for p in _prompts(4)]
    fleet.run_until_idle()
    return K.fleet_view(fleet, reqs)


def stall_guard(s):
    chaos = s.rel.ChaosRegistry()
    chaos.crash_replica(0, 1, count=100)
    chaos.crash_replica(1, 1, count=100)
    fleet, _ = _fleet(s, n=2, chaos=chaos, breaker_threshold=1, breaker_cooldown_s=100.0,
                      redispatch_policy=s.rel.RetryPolicy(max_retries=10, backoff_base_s=0.0))
    req = fleet.submit(_prompts()[0])
    try:
        fleet.run_until_idle()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return dict(K.fleet_view(fleet, [req]), raised=raised)


def rolling_restart(s):
    fleet, _ = _fleet(s, n=3)
    reqs = [fleet.submit(p) for p in _prompts()]
    for _ in range(2):
        fleet.step()
    restarted = fleet.rolling_restart()
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, reqs), restarted=restarted)


def slot_drain(s):
    engine = s.slot(_gen(s), _table(s), slots=2, clock=s.rel.FakeClock())
    reqs = [engine.submit(p) for p in _prompts(4)]
    engine.step()
    pending = engine.pending()
    drained = engine.drain()
    try:
        engine.submit(_prompts()[0])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return {"tokens": K.tokens(reqs), "status": [r.status for r in reqs], "pending": pending,
            "drained": drained, "refused": refused, "again": engine.drain(),
            "counters": {k: v for k, v in engine.registry.counters().items() if k not in K.PORT_ONLY}}


def obs_report(s):
    chaos = s.rel.ChaosRegistry()
    chaos.crash_replica(0, 3)
    fleet, _ = _fleet(s, chaos=chaos)
    reqs = [fleet.submit(p) for p in _prompts()]
    fleet.run_until_idle()
    analysis = s.report.analyze([sp.to_row() for sp in fleet.tracer.spans()], fleet.registry.snapshot())
    text = s.report.format_report(analysis)
    fleet_text = text.split("== fleet ==")[1].split("\n==")[0]
    empty = s.report.analyze([], {})
    return {"fleet": analysis["fleet"], "text": fleet_text, "status": [r.status for r in reqs],
            "empty": empty["fleet"], "empty_text": "== fleet ==" in s.report.format_report(empty),
            "completed_by_replica": fleet.stats()["completed_by_replica"]}


SCRIPTS = {f.__name__: f for f in (
    reference, health_schema, retry_jitter, breaker_lifecycle, single_replica_identity,
    load_aware_dispatch, crash_mid_decode, hung_replica, stale_copy_wins, breaker_reintegrates,
    dispatch_fault_backoff, poisoned_replica, dispatch_fault_opens_breaker, admission,
    failover_disabled, stall_guard, rolling_restart, slot_drain, obs_report)}
_RUNS = {}


def run(S, name):
    """Both packages' views of one script (each run once per module)."""
    if name not in _RUNS:
        _RUNS[name] = {side: SCRIPTS[name](S[side]) for side in ("jax", "port")}
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(S, name):
    views = run(S, name)
    assert views["port"] == views["jax"]


# -- each script's own bars (JAX's test), on the port's run ----------------
def test_health_schema_contract(S):
    v = run(S, "health_schema")["port"]
    assert all(not missing for missing in v["missing"].values())
    assert v["detail_missing"] == [[]]
    assert v["fleet"]["replicas"] == 1 and v["fleet"]["replicas_healthy"] == 1
    assert v["fleet"]["draining"] == 0 and v["replica_fields"]["breaker"] == "closed"


def test_retry_and_breaker_units(S):
    v = run(S, "retry_jitter")["port"]
    assert v["base"] == [1.0, 2.0, 4.0, 8.0] and v["no_rng"] == 1.0 and v["call"] == "ok"
    assert all(1.0 * 2 ** k <= d <= 1.5 * 2 ** k for k, d in enumerate(v["seeded"]))
    assert "jitter" in v["refused"]
    b = run(S, "breaker_lifecycle")["port"]
    assert b["seq"] == ["closed", False, False, True, "open", "open", "half_open", True, 2, "half_open"]
    assert b["state"] == "closed" and b["failures"] == 0


def test_single_replica_no_failover_behavior_identical(S):
    v = run(S, "single_replica_identity")["port"]
    assert v["direct"] == v["fleet"]
    st = v["view"]["stats"]
    assert st["submitted"] == st["completed"] == 6
    assert st["failovers"] == st["redispatches"] == st["breaker_opens"] == 0
    assert st["completed_by_replica"] == {"0": 6}


def test_dispatch_spreads_and_crash_recovers_token_identical(S):
    ref = run(S, "reference")["port"]
    assert ref["status"] == ["ok"] * 6
    assert sorted(ref["stats"]["completed_by_replica"]) == ["0", "1", "2"]
    assert all(n > 0 for n in ref["stats"]["completed_by_replica"].values())
    v = run(S, "crash_mid_decode")["port"]
    assert v["fired"] == 1 and v["status"] == ["ok"] * 6 and v["tokens"] == ref["tokens"]
    st = v["stats"]
    assert st["submitted"] == st["completed"] == 6 and st["failovers"] == 1
    assert st["replica_restarts"] == 1 and st["redispatches"] >= 1 and max(v["dispatches"]) > 1
    terminal = [sp for sp in v["spans"] if sp[0] == "fleet.request"]
    assert len(terminal) == 6 and all(sp[2] == "ok" for sp in terminal)


def test_hang_stale_copy_and_breaker(S):
    ref = run(S, "reference")["port"]["tokens"]
    hung = run(S, "hung_replica")["port"]
    assert hung["before_drain"] == ref and hung["stats"]["failovers"] == 1
    assert hung["stats"]["breaker_opens"] == 1 and hung["stats"]["completed"] == 6
    assert hung["stats"]["duplicate_results_ignored"] >= 1
    stale = run(S, "stale_copy_wins")["port"]
    assert stale["tokens"] == ref[:2] and stale["dispatches"] == [1, 1]
    assert stale["stats"]["redispatches"] == 2 and stale["stats"]["duplicate_results_ignored"] == 0
    br = run(S, "breaker_reintegrates")["port"]
    assert br["states"] == ["closed", "open", 1, "open", 0, br["states"][5], "closed", 2]
    assert br["states"][5] in ("half_open", "closed")
    assert br["stats"]["completed_by_replica"] == {"0": 1, "1": 6}


def test_dispatch_faults_and_poison(S):
    ref = run(S, "reference")["port"]["tokens"]
    d = run(S, "dispatch_fault_backoff")["port"]
    assert d["seen"] == ["queued", 1, 2.0, "queued"] and d["status"] == ["ok"] and d["dispatches"] == [2]
    p = run(S, "poisoned_replica")["port"]
    assert p["status"] == ["ok"] * 4 and p["tokens"] == ref[:4]
    assert p["stats"]["breaker_opens"] == 1 and p["replicas"][0]["breaker"] == "open"
    assert p["stats"]["completed_by_replica"]["0"] == 0 and max(p["dispatches"]) == 2
    o = run(S, "dispatch_fault_opens_breaker")["port"]
    assert o["seen"][:3] == ["dispatched", "queued", "queued"] and "fleet stalled" in o["seen"][3]
    assert o["status"] == ["ok", "ok"] and o["replicas"][0]["breaker"] == "closed"


def test_admission_failover_off_stall_and_restart(S):
    a = run(S, "admission")["port"]
    assert [r[0] for r in a["raised"]] == ["QueueFull", "ValueError"]
    assert "max_pending=2" in a["raised"][0][1] and "exceeds the largest bucket" in a["raised"][1][1]
    assert a["raised"][0][2] is not None
    assert sorted(sp[2] for sp in a["spans"] if sp[0] == "fleet.request") == \
        ["rejected", "shed", "timed_out", "timed_out"]
    f = run(S, "failover_disabled")["port"]
    assert {"failed", "ok"} <= set(f["status"]) and f["stats"]["failovers"] == 0
    assert all("failover disabled" in e for e, st in zip(f["errors"], f["status"]) if st == "failed")
    assert "fleet stalled" in run(S, "stall_guard")["port"]["raised"]
    r = run(S, "rolling_restart")["port"]
    assert r["restarted"] == 3 and r["tokens"] == run(S, "reference")["port"]["tokens"]
    assert [rep["restarts"] for rep in r["replicas"]] == [1, 1, 1]
    d = run(S, "slot_drain")["port"]
    assert d["status"] == ["ok"] * 4 and d["pending"] and "draining" in d["refused"] and d["again"] == 0


def test_obs_report_fleet_section(S):
    v = run(S, "obs_report")["port"]
    assert v["fleet"]["terminal_spans"] == 6 and v["fleet"]["by_status"] == {"ok": 6}
    assert v["fleet"]["failovers"] == 1 and v["fleet"]["replicas_healthy"] == 3
    assert v["fleet"]["completed_by_replica"] == {k: n for k, n in v["completed_by_replica"].items() if n}
    assert "failovers" in v["text"] and v["empty"] is None and not v["empty_text"]
