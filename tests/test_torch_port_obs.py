"""The port's observability host modules against the JAX package's, on the CPU.

Each case runs ONE scripted sequence through both packages under a fake
clock and compares what comes out, byte for byte: the registry's
``snapshot_json`` and ``to_prometheus_text``; the tracer's ``events.jsonl``
lines (trace ids, nesting, sampling decisions, the rotation byte);
``compat.read_metrics_jsonl``; the SLO monitor's breach and recovery ticks;
the profiler trigger's arming step; the build ledger's records and retrace
reasons; the step timeline's ring and export; the flight recorder's
bundles. Then the offline analyzers (``obs report|incident|timeline``) over
the checked-in fixtures, called directly and through both CLIs, print
the same text and JSON. Tolerance: equality everywhere.
"""
import importlib
import json
import os
import types

import pytest

import perceiver_io_tpu.observability as jax_obs
import perceiver_io_tpu_torch.observability as port_obs
from perceiver_io_tpu.reliability import FakeClock as JaxFakeClock
from perceiver_io_tpu_torch.reliability import FakeClock as PortFakeClock

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODULES = ("registry", "tracing", "exporters", "compat", "slo", "trigger", "ledger", "timeline",
           "flight_recorder", "report", "loadgen")
#: help lines the port rewrites to say what its value is (the family names
#: stay JAX's); every other line of the Prometheus text is byte-equal
PORT_HELP = ("compile_ms", "compile_total", "compile_ledger_fallback_total", "hbm_bytes_in_use",
             "executor_resident_bytes", "kv_ragged_kernel_steps_total")


def _pkg(root: str, clock_cls):
    ns = types.SimpleNamespace(FakeClock=clock_cls, root=root)
    for name in MODULES:
        setattr(ns, name, importlib.import_module(f"{root}.observability.{name}"))
    return ns


PKGS = {"jax": _pkg("perceiver_io_tpu", JaxFakeClock), "port": _pkg("perceiver_io_tpu_torch", PortFakeClock)}


def _both(script, tmp_path):
    """``script(pkg, dir)`` in both packages, each in its own directory."""
    out = {}
    for side, pkg in PKGS.items():
        d = tmp_path / side
        d.mkdir()
        out[side] = script(pkg, str(d))
    return out["jax"], out["port"]


def _strip_port_help(text: str) -> str:
    return "\n".join(line for line in text.splitlines()
                     if not any(line.startswith(f"# HELP {n} ") for n in PORT_HELP))


# -- registry and exporters --------------------------------------------------
def _registry_script(pkg, d):
    clock = pkg.FakeClock()
    reg = pkg.registry.MetricsRegistry(clock=clock, histogram_window=8)
    reg.declare_counters("serving_requests_completed_total", "serving_requests_shed_total")
    for i in range(13):
        reg.inc("serving_requests_completed_total")
        reg.observe("serving_ttft_ms", 3.0 * i + 0.25)
        reg.observe("serving_inter_token_ms", (i % 5) * 1.5)
        with reg.timer("serving_decode_step_ms"):
            clock.advance(0.001 * (i + 1))
    reg.inc("serving_tokens_generated_total", 7)
    reg.set_gauge("kv_cache_resident_bytes", 4096)
    reg.set_gauge("custom_gauge", -1.5)
    reg.inc("compile_total", 2)
    reg.observe("compile_ms", 12.5)
    writer = pkg.exporters.SnapshotWriter(reg, os.path.join(d, "snap.json"), every_s=1.0,
                                          clock=clock)
    wrote = [writer.maybe_write(), writer.maybe_write()]
    clock.advance(2.0)
    wrote.append(writer.maybe_write())
    with open(os.path.join(d, "snap.json")) as fh:
        snap = json.load(fh)
    snap.pop("t", None)
    reg.reset("serving_inter")
    return {
        "json": pkg.exporters.snapshot_json(reg, indent=1),
        "prom": _strip_port_help(pkg.exporters.to_prometheus_text(reg)),
        "p95": reg.percentile("serving_ttft_ms", 95.0),
        "summary": reg.histogram("serving_ttft_ms").summary(),
        "counters": reg.counters(),
        "wrote": wrote,
        "file": snap,
        "help": {k: pkg.exporters.help_text(k) for k in ("serving_ttft_ms", "trainer_loss")},
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_registry_and_exporters_are_byte_equal(tmp_path):
    j, p = _both(_registry_script, tmp_path)
    assert j == p


def test_port_help_lines_name_the_port_values():
    for name in PORT_HELP:
        assert port_obs.help_text(name) and port_obs.help_text(name) != jax_obs.help_text(name)
        assert "XLA" not in port_obs.help_text(name) and "jit" not in port_obs.help_text(name)
    # the port's one family of its own, the slot engine's boundary steps
    assert set(port_obs.HELP_TEXT) == set(jax_obs.HELP_TEXT) | {"serving_decode_boundary_steps_total"}
    assert set(port_obs.__all__) == set(jax_obs.__all__) - {"LedgeredExecutor"}


# -- tracing ------------------------------------------------------------------
def _tracing_script(pkg, d, *, rate=None, keep_slow_ms=None, max_bytes=None):
    clock = pkg.FakeClock()
    reg = pkg.registry.MetricsRegistry(clock=clock)
    path = os.path.join(d, "events.jsonl")
    sink = pkg.tracing.JsonlSpanSink(path, max_bytes=max_bytes)
    outer = sink if rate is None else pkg.tracing.SamplingSpanSink(
        sink, rate=rate, keep_slow_ms=keep_slow_ms, registry=reg)
    tracer = pkg.tracing.Tracer(clock=clock, sink=outer, prefix="r.")
    for i in range(12):
        tid = tracer.new_trace_id()
        with tracer.span("serving.batch", trace_id=tid, size=i, bucket=[1, 8]):
            clock.advance(0.002)
            with tracer.span("serving.inner", trace_id=tid, note="x" * (i % 3)):
                clock.advance(0.001)
        tracer.event("serving.first_token", trace_id=tid, ttft_ms=round(1.5 * i, 3))
        span = tracer.start_span("serving.request", trace_id=tid, start_s=tracer.now() - 0.01 * i,
                                 request_id=i)
        tracer.end_span(span, status="ok" if i % 5 else "failed",
                        **({} if i % 5 else {"error": "boom"}))
    tracer.event("ledger.compile", site="kernel_build", compile_ms=3.0)
    outer.close()
    rows = pkg.tracing.read_events_jsonl(path)
    lines = []
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as fh:
            lines.append((name, fh.read()))
    return {"rows": rows, "files": lines, "counters": reg.counters(),
            "stats": getattr(outer, "stats", lambda: None)(),
            "ring": [s.to_row() for s in tracer.spans()]}


@pytest.mark.parametrize("rate,keep_slow_ms,max_bytes", [
    (None, None, None),  # every span, nesting and ids
    (0.25, None, None),  # head sampling keeps and drops the same traces
    (0.25, 40.0, None),  # tail-keep of slow terminals
    (None, None, 1500),  # rotation at the same byte
], ids=["plain", "sampled", "tail_keep", "rotated"])
def test_tracer_events_jsonl_equal(tmp_path, rate, keep_slow_ms, max_bytes):
    j, p = _both(lambda pkg, d: _tracing_script(pkg, d, rate=rate, keep_slow_ms=keep_slow_ms,
                                                max_bytes=max_bytes), tmp_path)
    assert j == p
    if max_bytes is not None:
        assert [name for name, _ in p["files"]] == ["events.jsonl", "events.jsonl.1"]


def test_cpu_tensor_attribute_is_written_as_a_number(tmp_path):
    import numpy as np
    import torch

    path = str(tmp_path / "events.jsonl")
    sink = port_obs.JsonlSpanSink(path)
    tracer = port_obs.Tracer(clock=PortFakeClock(), sink=sink)
    tracer.event("x", loss=torch.tensor(2.5), step=np.int64(3), ids=torch.tensor([1, 2]))
    sink.close()
    attrs = port_obs.read_events_jsonl(path)[0]["attrs"]
    assert attrs["loss"] == 2.5 and isinstance(attrs["loss"], float) and attrs["step"] == 3
    assert isinstance(attrs["ids"], str) and sink.write_errors == 0


# -- compat -------------------------------------------------------------------
def test_read_metrics_jsonl_equal(tmp_path):
    path = tmp_path / "metrics.jsonl"
    rows = [{"step": 1, "loss": 2.0, "lr": 1e-3}, {"step": 2, "train/loss": 1.5},
            {"step": 2, "text": {"sample": "hi"}}, {"step": 3, "val/loss": 1.25, "train/lr": 2e-3}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    j = jax_obs.read_metrics_jsonl(str(path))
    p = port_obs.read_metrics_jsonl(str(path))
    assert j == p and [port_obs.normalize_row(r) for r in rows] == [jax_obs.normalize_row(r) for r in rows]


# -- SLO monitor ----------------------------------------------------------------
def _slo_script(pkg, d):
    clock = pkg.FakeClock()
    reg = pkg.registry.MetricsRegistry(clock=clock)
    tracer = pkg.tracing.Tracer(clock=clock)
    captured = []
    trigger = pkg.trigger.ProfilerTrigger(d, min_samples=2, capture_fn=captured.append)
    counts = {"serving_requests_submitted_total": 0, "serving_requests_completed_total": 0,
              "serving_requests_failed_total": 0}
    mon = pkg.slo.SLOMonitor(pkg.slo.SLOPolicy(ttft_p95_ms=50.0, error_rate=0.1), clock=clock,
                             registry=reg, tracer=tracer, profiler_trigger=trigger,
                             fast_window_s=5.0, slow_window_s=20.0, min_samples=3)
    mon.watch_counters(lambda: dict(counts), prefix="serving")
    ticks = []
    for t in range(60):
        slow = 20 <= t < 32
        mon.sink("serving_ttft_ms", 120.0 if slow else 10.0)
        mon.sink("serving_inter_token_ms", 3.0)
        counts["serving_requests_submitted_total"] += 1
        key = "failed" if 40 <= t < 44 else "completed"
        counts[f"serving_requests_{key}_total"] += 1
        clock.advance(0.5)
        state = mon.poll()
        ticks.append((t, mon.breached, tuple(mon.active_breaches)))
    return {"ticks": ticks, "stats": mon.stats(), "state": state, "counters": reg.counters(),
            "gauges": reg.snapshot()["gauges"], "armed": trigger.armed,
            "events": [(s.name, s.attrs) for s in tracer.spans()],
            "goodput": pkg.slo.goodput_ratio(counts), "offered": pkg.slo.offered_load(counts)}


def test_slo_monitor_breaches_and_recovers_at_the_same_ticks(tmp_path):
    j, p = _both(_slo_script, tmp_path)
    assert j == p
    flips = [t for (t, b, _), (_, prev, _) in zip(p["ticks"][1:], p["ticks"]) if b != prev]
    assert len(flips) >= 2  # at least one breach and one recovery


# -- profiler trigger -----------------------------------------------------------
def _trigger_script(pkg, d):
    captured = []
    trig = pkg.trigger.ProfilerTrigger(d, factor=1.5, min_samples=4, cooldown=3, warmup=2,
                                       max_captures=2, capture_fn=lambda target: (
                                           captured.append(target) or _nullcontext()))
    log = []
    series = [100, 90] + [10, 11, 10, 12] + [10] * 3 + [30] * 6 + [10] * 5 + [40] * 8
    for i, ms in enumerate(series):
        armed_now = trig.observe(ms)
        if trig.armed:
            with trig.capture(step=i):
                pass
        log.append((i, armed_now, trig.armed, trig.captures))
    trig.arm()
    return {"log": log, "baseline": trig.baseline_p95, "captured": [os.path.basename(c) for c in captured],
            "after_arm": trig.armed}


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


def test_profiler_trigger_arms_at_the_same_step(tmp_path):
    j, p = _both(_trigger_script, tmp_path)
    assert j == p and p["captured"]


def test_port_trigger_captures_a_chrome_trace(tmp_path):
    # the default capture is the port's torch.profiler trace (CPU here)
    import torch

    trig = port_obs.ProfilerTrigger(str(tmp_path), min_samples=1, warmup=0)
    assert trig.arm()
    with trig.capture(step=7):
        torch.ones(4, 4) @ torch.ones(4, 4)
    path = tmp_path / "regress-step7" / "trace.json"
    trace = json.loads(path.read_text())
    assert trig.captures == 1 and not trig.armed
    assert any("aten::" in str(ev.get("name", "")) for ev in trace["traceEvents"])


# -- build ledger -----------------------------------------------------------------
BUILDS = [
    ("slot_decode", {"model": "m1", "bucket_shape": "(2, 8)"}, 12.0),
    ("slot_decode", {"model": "m1", "bucket_shape": "(2, 16)"}, 3.5),
    ("slot_decode", {"model": "m1", "bucket_shape": "(2, 16)"}, 1.25),
    ("generate", {"model": "m2", "trace_env": "a"}, 7.0),
    ("generate", {"model": "m2", "trace_env": "b", "phase_plan": "p"}, 2.0),
]


def _ledger_script(pkg, d):
    clock = pkg.FakeClock()
    reg = pkg.registry.MetricsRegistry(clock=clock)
    ledger = pkg.ledger.CompileLedger(registry=reg, clock=clock, keep=3)
    seen = []
    detach = ledger.attach(seen.append)
    for site, comps, ms in BUILDS:
        entry = {"site": site, "components": {k: str(v) for k, v in comps.items()}}
        if pkg.root == "perceiver_io_tpu":
            ledger._record_compiled(entry, ms, {"flops": None, "bytes_accessed": None},
                                    {k: None for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                                       "generated_code_bytes")})
        else:
            ledger.record_build(site, comps, ms)
    detach()
    ledger.set_kv_cache_bytes(1024)
    return {"snapshot": ledger.snapshot(), "records": ledger.records(site="slot_decode"),
            "seen": seen, "counters": reg.counters(), "gauges": reg.snapshot()["gauges"],
            "hists": reg.snapshot()["histograms"]}


def test_ledger_records_and_retrace_reasons_equal(tmp_path):
    j, p = _both(_ledger_script, tmp_path)
    assert j == p
    assert p["snapshot"]["retrace_reasons"] == {"bucket_shape": 1, "duplicate_key": 1,
                                                "phase_plan": 1, "trace_env": 1}


def test_kernel_build_records_attribute_a_header_edit_to_the_hash(tmp_path, monkeypatch):
    """``_build.py`` records each ``nvcc`` build at site ``kernel_build``: the
    source is the identity, so an edited header rebuilds under a new hash and
    counts as a retrace attributed to ``hash``; a loaded library records
    nothing."""
    from perceiver_io_tpu_torch import _build

    reg = port_obs.MetricsRegistry()
    ledger = port_obs.CompileLedger(registry=reg)
    monkeypatch.setattr("perceiver_io_tpu_torch.observability.default_ledger", lambda: ledger)
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "csrc" / "h.cuh").write_text("// one\n")

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "wb").close()
            return "ptxas info", None

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    _build.build_all()
    _build.build_all()  # built: loaded as it is, no record
    (tmp_path / "csrc" / "h.cuh").write_text("// two\n")
    _build.build_all()
    recs = ledger.records()
    assert [r["site"] for r in recs] == ["kernel_build"] * 2
    assert [r["components"]["source"] for r in recs] == ["csrc/k.cu"] * 2
    assert recs[0]["components"]["hash"] != recs[1]["components"]["hash"]
    assert [r["retrace_reasons"] for r in recs] == [[], ["hash"]]
    assert all(r["compile_ms"] >= 0 and r["flops"] is None and r["temp_bytes"] is None for r in recs)
    assert reg.counter("compile_total") == 2 and reg.counter("retrace_reason_hash_total") == 1


def test_device_gauge_is_skipped_without_a_card():
    reg = port_obs.MetricsRegistry()
    assert port_obs.CompileLedger(registry=reg).update_device_gauges() is None
    assert reg.gauge("hbm_bytes_in_use") is None


# -- step timeline ------------------------------------------------------------------
def _timeline_script(pkg, d):
    reg = pkg.registry.MetricsRegistry()
    tl = pkg.timeline.StepTimeline(cap=4, registry=reg)
    for i in range(7):
        tl.append({"engine": "slots", "t_start_s": i * 0.1, "t_end_s": i * 0.1 + 0.05,
                   "queue_depth": 7 - i, "slots": [i, None], "phases_ms": {"total": 50.0},
                   "admitted": [{"request_id": i, "slot": 0, "tenant": "t-a", "priority": -1}],
                   "finished": [{"request_id": i - 1, "status": "ok"}] if i else []})
    path = os.path.join(d, "timeline.jsonl")
    n = tl.write_jsonl(path)
    return {"n": n, "summary": tl.summary(), "records": tl.records(), "read": pkg.timeline.read_timeline_jsonl(path),
            "labels": [pkg.timeline.tenant_label(t) for t in (None, "a b", "x-1")]
            + [pkg.timeline.tier_label(t) for t in (-2, 0, 3)], "counters": reg.counters()}


def test_step_timeline_ring_and_export_equal(tmp_path):
    j, p = _both(_timeline_script, tmp_path)
    assert j == p and p["n"] == 4


# -- flight recorder ------------------------------------------------------------------
def _recorder_script(pkg, d):
    clock = pkg.FakeClock()
    reg = pkg.registry.MetricsRegistry(clock=clock)
    tracer = pkg.tracing.Tracer(clock=clock)
    rec = pkg.flight_recorder.FlightRecorder(os.path.join(d, "inc"), tracer=tracer, registry=reg,
                                             clock=clock, cooldown_s=10.0, max_bundles=2,
                                             keep_spans=16, snapshot_every_s=1.0)
    rec.add_source("health", lambda: {"ready": True, "queue_depth": 3})
    rec.add_source("broken", lambda: 1 / 0)
    for i in range(5):
        tid = tracer.new_trace_id()
        with tracer.span("serving.request", trace_id=tid, request_id=i):
            clock.advance(0.4)
        rec.maybe_record()
    fired = [rec.trigger("pool_exhausted", "no blocks", trace_ids=["t000002"], blocks=8),
             rec.trigger("pool_exhausted", "again"), None]
    clock.advance(11.0)
    fired[2] = rec.trigger("preemption_storm", "two victims", blocks_in_use=7)
    watch = pkg.flight_recorder.DisconnectWatch(threshold=3, window_s=1.0, clock=clock)
    notes = [watch.note() for _ in range(4)]
    bundles = []
    for b in rec.bundles:
        with open(os.path.join(b, "manifest.json")) as fh:
            manifest = json.load(fh)
        with open(os.path.join(b, "spans.jsonl")) as fh:
            spans = fh.read()
        bundles.append((os.path.basename(b), manifest, spans))
    return {"fired": [f if f is None else os.path.basename(f) for f in fired], "bundles": bundles,
            "stats": {k: v for k, v in rec.stats().items() if k != "dir"}, "notes": notes,
            "counters": reg.counters(), "incident": [pkg.report.run_incident(b) for b in rec.bundles]}


def test_flight_recorder_bundles_equal(tmp_path):
    j, p = _both(_recorder_script, tmp_path)
    assert j == p and len(p["bundles"]) == 2


# -- the offline analyzers over the checked-in fixtures ---------------------------------
ANALYZERS = {
    "report": lambda m: m.run(f"{FIXTURES}/events.jsonl", f"{FIXTURES}/metrics_snapshot.json"),
    "report_json": lambda m: m.run(f"{FIXTURES}/events.jsonl", f"{FIXTURES}/metrics_snapshot.json",
                                   as_json=True),
    "report_events_only": lambda m: m.run(f"{FIXTURES}/events.jsonl", top=5),
    "incident": lambda m: m.run_incident(f"{FIXTURES}/incident"),
    "incident_json": lambda m: m.run_incident(f"{FIXTURES}/incident", as_json=True),
    "timeline": lambda m: m.run_timeline(f"{FIXTURES}/timeline/timeline.jsonl",
                                         f"{FIXTURES}/timeline/events.jsonl"),
    "timeline_json": lambda m: m.run_timeline(f"{FIXTURES}/timeline/timeline.jsonl",
                                              f"{FIXTURES}/timeline/events.jsonl", as_json=True),
}


@pytest.mark.parametrize("name", sorted(ANALYZERS))
def test_analyzers_print_equal_text(name):
    j = ANALYZERS[name](PKGS["jax"].report)
    p = ANALYZERS[name](PKGS["port"].report)
    assert j == p and p


def test_timeline_trace_export_equal(tmp_path):
    out = {}
    for side, pkg in PKGS.items():
        path = str(tmp_path / f"{side}.json")
        pkg.report.run_timeline(f"{FIXTURES}/timeline/timeline.jsonl", trace_out=path)
        out[side] = json.loads(open(path).read())
    assert out["jax"] == out["port"]


OBS_ARGV = {
    "report": ["obs", "report", f"--events={FIXTURES}/events.jsonl",
               f"--snapshot={FIXTURES}/metrics_snapshot.json"],
    "report_json": ["obs", "report", f"--events={FIXTURES}/events.jsonl", "--json=true", "--top=3"],
    "incident": ["obs", "incident", f"--bundle={FIXTURES}/incident"],
    "timeline": ["obs", "timeline", f"--timeline={FIXTURES}/timeline/timeline.jsonl",
                 f"--events={FIXTURES}/timeline/events.jsonl"],
    "usage": ["obs", "graph"],
    "missing_events": ["obs", "report"],
    "missing_bundle": ["obs", "incident"],
    "bad_snapshot": ["obs", "report", f"--events={FIXTURES}/events.jsonl",
                     f"--snapshot={FIXTURES}/events.jsonl"],
    "no_file": ["obs", "report", "--events=/nonexistent/events.jsonl"],
}


@pytest.mark.parametrize("name", sorted(OBS_ARGV))
def test_obs_subcommands_match_jax_cli(name, capsys):
    from perceiver_io_tpu.scripts.text import clm as jax_clm
    from perceiver_io_tpu_torch.scripts.text import clm as port_clm

    results = []
    for mod in (jax_clm, port_clm):
        try:
            out = ("ok", mod.main(OBS_ARGV[name]))
        except SystemExit as e:
            out = ("exit", str(e))
        results.append((out, capsys.readouterr().out))
    assert results[0] == results[1]


def test_step_timer_publishes_gauges_and_names_the_h100_peak():
    import torch

    from perceiver_io_tpu_torch.utils import profiling

    reg = port_obs.MetricsRegistry()
    calls = []
    out = profiling.StepTimer(warmup=2).measure(lambda: calls.append(torch.ones(8).sum()), iters=5,
                                                flops_per_step=1000, peak_flops=1e6, registry=reg,
                                                name="probe")
    assert len(calls) == 7 and out["steps_per_sec"] == pytest.approx(1.0 / out["step_time_s"])
    assert out["mfu"] == pytest.approx(out["flops_per_sec"] / 1e6)
    assert sorted(reg.snapshot()["gauges"]) == ["probe_flops_per_sec", "probe_mfu", "probe_step_time_ms",
                                                "probe_steps_per_sec"]
    assert profiling.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_flops_for("NVIDIA A100-SXM4-80GB") is None
