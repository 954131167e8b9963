"""The port's HTTP/SSE streaming gateway (``serving/gateway.py``), the
engines' token sinks and ``cancel``, and the fleet's ``cancel`` and TTFT
anchor, against the JAX package's, on the CPU.

Every script of JAX's ``tests/test_gateway.py`` (its bench probes and the
speculative-burst cases, which JAX marks slow, excepted) runs through both
packages over the same tiny CLM. Engine-level scripts run on a
``FakeClock`` and are held exactly (tokens, sink calls, statuses, counters,
pool frees by cause, spans and events with their attributes). Socket
scripts bind ``127.0.0.1:0``, run each gateway's event loop in its own
thread and open the connections one after another, so stream and request
ids follow accept order; they are held to the frames each client reads
(SSE or JSON lines, less ``trace_id``), the status codes and error bodies,
the gateway's stream counters and its ``gateway.request`` events, and the
zero-leak pool. What depends on when a socket event lands against an
engine step (how many pages a disconnected stream held) is held to its
sign, not its value. Greedy tokens also equal per-request ``generate()``.
"""
import dataclasses
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests import _torch_port_serving as K

TINY = dict(vocab_size=89, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=1, cross_attention_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_PORT = {}


@pytest.fixture(scope="module")
def S():
    both = K.sides(K.tiny_pair(**TINY))
    _PORT["side"] = both["port"]
    return both


def _oracle(prompt, cfg) -> list:
    """Per-request ``generate()`` of the port (held to JAX's by
    ``tests/test_torch_port_serving.py``), for either side's config: JAX's
    ``generate`` would compile once per prompt length."""
    port = _PORT["side"]
    return port.ref(prompt, port.gen(max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents,
                                     eos_token_id=cfg.eos_token_id)).tolist()


def _gcfg(s, max_new=4, num_latents=2, **kw):
    return s.gen(max_new_tokens=max_new, num_latents=num_latents, **kw)


def _table(s):
    return s.table((8,))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 80, size=int(n)).astype(np.int32) for n in lengths]


# -- http helpers -----------------------------------------------------------
def _post(host, port, payload, timeout=60):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", "/v1/generate", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _frames(resp) -> list:
    """Every record of an SSE or JSON-lines response, ``trace_id`` dropped,
    with the framing each line came in."""
    out = []
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        sse = line.startswith(b"data:")
        rec = json.loads(line[5:].strip() if sse else line)
        rec.pop("trace_id", None)
        out.append(("sse" if sse else "jsonl", rec))
        if rec.get("done"):
            break
    return out


def _tokens(frames) -> list:
    return [rec["token"] for _, rec in frames if "token" in rec]


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _wait_for(predicate, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _streams(gw) -> dict:
    st = gw.stats()
    return {k: st[k] for k in ("connections", "streams", "streams_completed", "streams_cancelled",
                               "streams_rejected", "driver_errors", "streams_by_tenant")}


def _gw_events(tracer) -> list:
    """``gateway.request`` events by stream id: mode, status, tokens."""
    return sorted((sp.attrs["stream_id"], sp.attrs["mode"], sp.status, sp.attrs["tokens"])
                  for sp in tracer.spans("gateway.request"))


def _pool(engine) -> dict:
    st = engine._pool.stats()
    return {k: st[k] for k in ("in_use", "reserved", "leaked")}


# -- engine-level scripts (FakeClock: held exactly) -------------------------
def slot_on_token(s):
    cfg = _gcfg(s, max_new=5)
    engine = s.slot(cfg, _table(s), slots=2, clock=s.rel.FakeClock())
    engine.warmup()
    prompts = _prompts(0, [4, 7])
    sinks = [[], []]
    reqs = [engine.submit(p, on_token=lambda i, t, sk=sinks[j]: sk.append((i, int(t))))
            for j, p in enumerate(prompts)]
    growth = []
    while engine.pending():
        before = sum(len(sk) for sk in sinks)
        engine.step()
        growth.append(sum(len(sk) for sk in sinks) - before)
    return {"growth": growth, "sinks": sinks, "tokens": K.tokens(reqs),
            "ref": [_oracle(p, cfg) for p in prompts]}


def bucket_on_token(s):
    cfg = _gcfg(s, max_new=4)
    probe = _prompts(1, [5])[0]
    eos = int(_oracle(probe, cfg)[1])
    engine = s.bucket(dataclasses.replace(cfg, eos_token_id=eos), _table(s), clock=s.rel.FakeClock())
    sink = []
    req = engine.submit(probe, on_token=lambda i, t: sink.append((i, int(t))))
    before = list(sink)
    engine.step()
    return {"eos": eos, "before": before, "sink": sink, "status": req.status, "tokens": K.tokens([req])}


def raising_sink(s):
    engine = s.slot(_gcfg(s, max_new=3), _table(s), slots=2, clock=s.rel.FakeClock())

    def bad_sink(i, t):
        raise RuntimeError("consumer gone")

    req = engine.submit(_prompts(2, [4])[0], on_token=bad_sink)
    engine.run_until_idle()
    return {"status": req.status, "tokens": K.tokens([req]),
            "errors": engine.registry.counter("serving_token_sink_errors_total")}


def cancel_resident(s):
    cfg = _gcfg(s, max_new=8)
    clock = s.rel.FakeClock()
    tracer = s.obs.Tracer(clock=clock)
    engine = s.slot(cfg, _table(s), slots=2, clock=clock, kv_layout="paged", tracer=tracer)
    engine.warmup()
    prompts = _prompts(3, [5, 8, 6])
    reqs = [engine.submit(p) for p in prompts]
    for _ in range(2):
        engine.step()
    victim = reqs[0]
    seen = [engine._pool.in_use, engine._pool.mapped_blocks(0), engine.cancel(victim.request_id),
            engine._pool.mapped_blocks(0), engine._pool.in_use, dict(engine._pool.frees_by_cause),
            victim.status, victim.result]
    engine.run_until_idle()
    stats = engine.stats()
    return {"seen": seen, "tokens": K.tokens(reqs), "ref": [_oracle(p, cfg) for p in prompts[1:]],
            "pool": _pool(engine), "frees": dict(engine._pool.frees_by_cause),
            "spans": K.span_view(tracer, "serving.request") + K.span_view(tracer, "serving.cancelled"),
            "health_cancelled": engine.health()["cancelled"], "cancelled": stats["cancelled"],
            "completed": stats["completed"], "again": engine.cancel(victim.request_id)}


def cancel_queued_and_admitting(s):
    clock = s.rel.FakeClock()
    tracer = s.obs.Tracer(clock=clock)
    engine = s.slot(_gcfg(s, max_new=3), _table(s), slots=1, clock=clock, kv_layout="paged",
                    prefill_chunk=2, tracer=tracer)
    admitting, queued = [engine.submit(p) for p in _prompts(4, [8, 4])]
    engine.step()
    seen = [engine._admitting is not None, engine.cancel(queued.request_id), queued.status,
            engine.cancel(admitting.request_id), admitting.status, engine._admitting is None]
    return {"seen": seen, "pool": _pool(engine), "frees": dict(engine._pool.frees_by_cause),
            "spans": K.span_view(tracer, "serving.cancelled"), "pending": engine.pending()}


def fleet_cancel_and_anchor(s):
    cfg = _gcfg(s, max_new=4)
    clock = s.rel.FakeClock(100.0)
    tracer = s.obs.Tracer(clock=clock)

    def factory():
        return s.slot(cfg, _table(s), slots=2, clock=clock)

    fleet = s.serving.FleetRouter([factory, factory], clock=clock, tracer=tracer)
    prompts = _prompts(5, [5, 6])
    anchored = fleet.submit(prompts[0], ttft_anchor_s=clock() - 3.0)
    plain = fleet.submit(prompts[1])
    fleet.run_until_idle()
    gap = (fleet.registry.percentile("serving_ttft_ms", 100.0)
           - fleet.registry.percentile("serving_ttft_ms", 0.0))
    sink = []
    victim = fleet.submit(prompts[0], on_token=lambda i, t: sink.append(int(t)))
    survivor = fleet.submit(prompts[1])
    fleet.step()
    fleet.step()
    seen = [victim.status, list(sink), fleet.cancel(victim.request_id), victim.status,
            sum(r.engine.registry.counter("serving_requests_cancelled_total") for r in fleet.replicas)]
    fleet.run_until_idle()
    return dict(K.fleet_view(fleet, [anchored, plain, victim, survivor]), gap_is_anchor=abs(gap - 3000.0) < 1e-6,
                seen=seen, again=fleet.cancel(victim.request_id), health_cancelled=fleet.health()["cancelled"],
                ref=_oracle(prompts[1], cfg))


# -- socket scripts ---------------------------------------------------------
def http_paged(s):
    cfg = _gcfg(s, max_new=5)
    tracer = s.obs.Tracer()
    engine = s.slot(cfg, _table(s), slots=2, kv_layout="paged", tracer=tracer)
    engine.warmup()
    gw = s.serving.StreamingGateway(engine, tracer=tracer).run_in_thread()
    prompts = _prompts(6, [4, 7, 6])
    payloads = [{"prompt_ids": prompts[0].tolist()},
                {"prompt_ids": prompts[1].tolist(), "stream": "jsonl"},
                {"prompt_ids": prompts[2].tolist(), "max_new_tokens": 3, "tenant": "acme"}]
    try:
        # connect one after another (accept order), then read all streams at once
        conns = [_post(gw.host, gw.port, p) for p in payloads]
        results = [None] * 3

        def read(i):
            results[i] = (conns[i][1].status, _frames(conns[i][1]))
            conns[i][0].close()

        threads = [threading.Thread(target=read, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        _wait_for(lambda: gw.stats()["streams_completed"] >= 3, what="streams settled")
        stats = _streams(gw)
    finally:
        gw.close()
    reg = engine.registry
    cfgs = [cfg, cfg, dataclasses.replace(cfg, max_new_tokens=3)]
    return {"results": results, "ref": [_oracle(p, c) for p, c in zip(prompts, cfgs)],
            "pool": _pool(engine), "streams": stats, "events": _gw_events(tracer),
            "joined": ({sp.trace_id for sp in tracer.spans("gateway.request")}
                       == {sp.trace_id for sp in tracer.spans("serving.request")}),
            "socket_ttft_count": reg.snapshot()["histograms"]["gateway_socket_ttft_ms"]["count"],
            "socket_at_least_engine": (reg.percentile("gateway_socket_ttft_ms", 50.0)
                                       >= reg.percentile("serving_ttft_ms", 50.0) > 0.0)}


def http_fleet_and_bucket(s):
    cfg = _gcfg(s, max_new=4)

    def factory():
        return s.slot(cfg, _table(s), slots=2)

    fleet = s.serving.FleetRouter([factory, factory], registry=s.obs.MetricsRegistry())
    fleet.warmup()
    gw = s.serving.StreamingGateway(fleet).run_in_thread()
    prompts = _prompts(7, [5, 7])
    out = {"fleet": [], "ref": [_oracle(p, cfg) for p in prompts]}
    try:
        for p in prompts:
            conn, resp = _post(gw.host, gw.port, {"prompt_ids": p.tolist(), "stream": "jsonl"})
            out["fleet"].append((resp.status, _frames(resp)))
            conn.close()
    finally:
        gw.close()
    # read once the gateway stopped: a stream counts after its last write
    out["fleet_streams"] = _streams(gw)
    out["fleet_counters"] = {k: v for k, v in fleet.registry.counters().items()
                             if k.startswith("fleet_") or (k.startswith("gateway_") and "bytes" not in k)}
    engine = s.bucket(cfg, _table(s))
    gw2 = s.serving.StreamingGateway(engine).run_in_thread()
    try:
        conn, resp = _post(gw2.host, gw2.port, {"prompt_ids": prompts[0].tolist()})
        out["bucket"] = (resp.status, _frames(resp))
        conn.close()
    finally:
        gw2.close()
    return out


def http_disconnect(s):
    cfg = _gcfg(s, max_new=16)
    tracer = s.obs.Tracer()
    engine = s.slot(cfg, _table(s), slots=2, kv_layout="paged", tracer=tracer)
    engine.warmup()
    orig_step = engine.step
    engine.step = lambda: (time.sleep(0.03), orig_step())[1]  # widen the window
    gw = s.serving.StreamingGateway(engine, tracer=tracer).run_in_thread()
    prompts = _prompts(8, [5, 7])
    survivor = {}

    def survive():
        conn, resp = _post(gw.host, gw.port, {"prompt_ids": prompts[1].tolist(), "stream": "jsonl"})
        try:
            survivor["frames"] = _frames(resp)
        finally:
            conn.close()

    t = threading.Thread(target=survive)
    try:
        sock = socket.create_connection((gw.host, gw.port), timeout=30)
        body = json.dumps({"prompt_ids": prompts[0].tolist(), "stream": "jsonl"}).encode()
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        _wait_for(lambda: engine.registry.counter("serving_requests_submitted_total") >= 1,
                  what="the victim's submit")
        t.start()
        buf = b""
        while b'"token"' not in buf:
            chunk = sock.recv(4096)
            assert chunk, "gateway closed the victim stream prematurely"
            buf += chunk
        sock.close()
        _wait_for(lambda: engine.registry.counter("serving_requests_cancelled_total") >= 1,
                  what="disconnect-propagated cancellation")
        t.join(60)
        _wait_for(lambda: gw.stats()["streams_completed"] + gw.stats()["streams_cancelled"] >= 2,
                  what="streams settled")
        stats = _streams(gw)
    finally:
        gw.close()
    return {"survivor": survivor["frames"], "ref": _oracle(prompts[1], cfg), "pool": _pool(engine),
            "cancelled_pages": engine._pool.frees_by_cause.get("cancelled", 0) > 0, "streams": stats,
            "terminal": sorted(sp.status for sp in tracer.spans("serving.request")),
            "events": [e[1:3] for e in _gw_events(tracer)]}


def http_mass_abandonment(s, tmp_root):
    cfg = _gcfg(s, max_new=10)
    chaos = s.rel.ChaosRegistry()
    chaos.disconnect_stream(1, after_tokens=2)
    chaos.disconnect_stream(3, after_tokens=2)
    tracer = s.obs.Tracer()
    engine = s.slot(cfg, _table(s), slots=2, kv_layout="paged", tracer=tracer)
    engine.warmup()
    recorder = s.obs.FlightRecorder(str(tmp_root / s.name), tracer=tracer, registry=engine.registry,
                                    cooldown_s=3600.0)
    gw = s.serving.StreamingGateway(engine, tracer=tracer, chaos=chaos, flight_recorder=recorder,
                                    mass_disconnect_threshold=2, mass_disconnect_window_s=60.0).run_in_thread()
    prompts = _prompts(9, [5, 6, 7, 8])
    try:
        conns = [_post(gw.host, gw.port, {"prompt_ids": p.tolist(), "stream": "jsonl"}) for p in prompts]
        results = []
        for conn, resp in conns:
            results.append(_frames(resp))
            conn.close()
        _wait_for(lambda: gw.stats()["streams_completed"] + gw.stats()["streams_cancelled"] >= 4,
                  what="all streams terminal")
        stats = _streams(gw)
    finally:
        gw.close()
    counts = engine.registry.counters()
    bundles = [b.rstrip("/").split("/")[-1] for b in recorder.bundles]
    return {"results": results, "ref": [_oracle(p, cfg) for p in prompts], "pool": _pool(engine),
            "streams": stats, "fired": chaos.fired_count(),
            "counts": {k: counts[k] for k in ("serving_requests_cancelled_total",
                                              "serving_requests_completed_total",
                                              "serving_requests_submitted_total")},
            "events": _gw_events(tracer), "bundles": bundles,
            "triggers": int(engine.registry.counter("incident_triggers_total"))}


def endpoints(s):
    engine = s.slot(_gcfg(s, max_new=3), _table(s), slots=2)
    gw = s.serving.StreamingGateway(engine).run_in_thread()
    out = []
    try:
        status, body = _get(gw.host, gw.port, "/healthz")
        health = json.loads(body)
        out.append((status, health["ready"], "cancelled" in health))
        status, body = _get(gw.host, gw.port, "/metrics")
        out.append((status, [f for f in s.gateway_mod.GATEWAY_COUNTERS if f"# HELP {f} " in body.decode()]))
        out.append(_get(gw.host, gw.port, "/nope"))
        conn = http.client.HTTPConnection(gw.host, gw.port, timeout=30)
        conn.request("GET", "/v1/generate")
        resp = conn.getresponse()
        out.append((resp.status, resp.read()))
        conn.close()
        for bad in (None, {"prompt_ids": list(range(1, 20))}, {"prompt_ids": [1, 2], "deadline_s": "5"},
                    {"prompt_ids": [1, 2], "max_new_tokens": [4]}, {"prompt_ids": "not-ids"},
                    {"prompt_ids": [1, 2], "max_new_tokens": 10**9},
                    {"prompt_ids": [1, 2], "max_new_tokens": 0}, {"prompt_ids": [1, 2], "priority": 101},
                    {"prompt_ids": [1, 2], "tenant": ""}, {"prompt": "text, no tokenizer"}):
            conn, resp = _post(gw.host, gw.port, bad)
            detail = json.loads(resp.read())
            detail.pop("trace_id", None)
            out.append((resp.status, detail))
            conn.close()
        sock = socket.create_connection((gw.host, gw.port), timeout=30)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 9999999999\r\n\r\n")
        out.append(sock.recv(4096).split(b"\r\n", 1)[0])
        sock.close()
    finally:
        gw.close()
    out.append({k: engine.registry.counter(k) for k in ("serving_requests_rejected_total",
                                                         "gateway_streams_rejected_total")})

    class SheddingStub:
        registry = s.obs.MetricsRegistry()
        tracer = None

        def submit(self, *a, **k):
            raise s.rel.QueueFull("stub at capacity")

        def pending(self):
            return False

        def step(self):
            return 0

        def health(self):
            return {"ready": False}

        def cancel(self, request_id):
            return False

    gw2 = s.serving.StreamingGateway(SheddingStub()).run_in_thread()
    try:
        conn, resp = _post(gw2.host, gw2.port, {"prompt_ids": [1, 2, 3]})
        out.append((resp.status, resp.getheader("Retry-After"), json.loads(resp.read())))
        conn.close()
        out.append(_get(gw2.host, gw2.port, "/healthz")[0])
        client = s.obs.GatewayHttpClient(gw2.host, gw2.port)
        try:
            client.submit(np.asarray([1, 2, 3], np.int32))
        except s.rel.QueueFull as e:
            out.append(("QueueFull", str(e)))
    finally:
        gw2.close()
    try:
        s.serving.StreamingGateway(SheddingStub(), stream="bogus")
    except ValueError as e:
        out.append(str(e))
    dead = s.obs.GatewayHttpClient("127.0.0.1", 9, timeout_s=0.5)
    handle = dead.submit(np.asarray([1, 2], np.int32))
    out.append((handle.status, bool(handle.error), dead.pending()))
    return out


def loadgen_http(s):
    cfg = _gcfg(s, max_new=3)
    engine = s.slot(cfg, _table(s), slots=2, tracer=s.obs.Tracer())
    engine.warmup()
    gw = s.serving.StreamingGateway(engine).run_in_thread()
    try:
        client = s.obs.GatewayHttpClient(gw.host, gw.port)
        gen = s.obs.LoadGenerator(
            client, workload=s.obs.WorkloadSpec(prompt_len=(4, 8), max_new_tokens=(2, 3), vocab=(1, 80)),
            mode="open", arrival="uniform", rate_rps=50.0, max_requests=5, config=cfg, rng=3)
        report = gen.run()
    finally:
        gw.close()
    return {"report": {k: report[k] for k in ("offered", "completed", "goodput_ratio")},
            "bytes": report["bytes_on_wire"] > 0,
            "handles": [(h.status, np.asarray(h.result).tolist(), h.trace_id is not None) for h in gen.handles]}


def report_fixtures(s):
    analysis = json.loads(s.report.run("tests/fixtures/events.jsonl", "tests/fixtures/metrics_snapshot.json",
                                       as_json=True))
    text = s.report.run("tests/fixtures/events.jsonl", "tests/fixtures/metrics_snapshot.json")
    rows = [{"span": "gateway.request", "trace_id": "t1", "start_s": 0.0, "duration_ms": 0.0, "status": "ok",
             "attrs": {"tokens": 3, "bytes": 10}},
            {"span": "gateway.request", "trace_id": "t2", "start_s": 0.0, "duration_ms": 0.0,
             "status": "cancelled", "attrs": {"tokens": 1, "bytes": 4}}]
    return {"gateway": analysis["gateway"], "text": text.split("== gateway ==")[1].split("\n==")[0],
            "fallback": s.report.analyze(rows, None)["gateway"],
            "fallback_text": s.report.format_report(s.report.analyze(rows, None)).split("== gateway ==")[1],
            "empty": s.report.analyze([], {})["gateway"]}


def help_families(s):
    engine = s.slot(_gcfg(s, max_new=3), _table(s), slots=2, kv_layout="paged")
    gw = s.serving.StreamingGateway(engine).run_in_thread()
    try:
        conn, resp = _post(gw.host, gw.port, {"prompt_ids": _prompts(12, [5])[0].tolist()})
        frames = _frames(resp)
        conn.close()
    finally:
        gw.close()
    snap = engine.registry.snapshot()
    published = sorted(set(snap["counters"]) | set(snap["gauges"]) | set(snap["histograms"]))
    text = s.exporters.to_prometheus_text(engine.registry)
    return {"frames": frames, "gateway": [n for n in published if n.startswith("gateway_")],
            "missing": [n for n in published if n not in s.exporters.HELP_TEXT],
            "no_help_line": [n for n in published if f"# HELP {n} " not in text]}


SCRIPTS = {f.__name__: f for f in (
    slot_on_token, bucket_on_token, raising_sink, cancel_resident, cancel_queued_and_admitting,
    fleet_cancel_and_anchor, http_paged, http_fleet_and_bucket, http_disconnect, http_mass_abandonment,
    endpoints, loadgen_http, report_fixtures, help_families)}
_RUNS = {}


def run(S, name, tmp_path_factory=None):
    if name not in _RUNS:
        views = {}
        for side in ("jax", "port"):
            if name == "http_mass_abandonment":
                views[side] = SCRIPTS[name](S[side], tmp_path_factory.mktemp("incidents"))
            else:
                views[side] = SCRIPTS[name](S[side])
        _RUNS[name] = views
    return _RUNS[name]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(S, name, tmp_path_factory):
    views = run(S, name, tmp_path_factory)
    assert views["port"] == views["jax"]


# -- each script's own bars (JAX's test), on the port's run ----------------
def test_token_sinks(S):
    v = run(S, "slot_on_token")["port"]
    assert max(v["growth"]) <= 2 and sum(1 for g in v["growth"] if g > 0) >= 5
    assert v["tokens"] == v["ref"]
    assert v["sinks"] == [[(i, t) for i, t in enumerate(ref)] for ref in v["ref"]]
    b = run(S, "bucket_on_token")["port"]
    assert b["before"] == [] and b["status"] == "ok"
    toks = b["tokens"][0]
    assert b["sink"] == [(i, t) for i, t in enumerate(toks[:toks.index(b["eos"]) + 1])] and len(b["sink"]) < 4
    r = run(S, "raising_sink")["port"]
    assert r["status"] == "ok" and r["errors"] == 3


def test_cancel_routes(S):
    v = run(S, "cancel_resident")["port"]
    in_use, mapped, cancelled, mapped_after, in_use_after, frees, status, result = v["seen"]
    assert in_use > 0 and mapped > 0 and cancelled and mapped_after == 0 and in_use_after < in_use
    assert frees.get("cancelled", 0) > 0 and status == "cancelled" and result is None
    assert v["tokens"][1:] == v["ref"] and v["pool"] == {"in_use": 0, "reserved": 0, "leaked": 0}
    assert [sp[2] for sp in v["spans"] if sp[0] == "serving.request"].count("cancelled") == 1
    assert [sp[3]["stage"] for sp in v["spans"] if sp[0] == "serving.cancelled"] == ["resident"]
    assert v["health_cancelled"] == v["cancelled"] == 1 and v["completed"] == 2 and v["again"] is False
    q = run(S, "cancel_queued_and_admitting")["port"]
    assert q["seen"] == [True, True, "cancelled", True, "cancelled", True]
    assert q["pool"]["in_use"] == q["pool"]["reserved"] == 0 and not q["pending"]
    assert sorted(sp[3]["stage"] for sp in q["spans"]) == ["admitting", "queued"]


def test_fleet_cancel_and_ttft_anchor(S):
    v = run(S, "fleet_cancel_and_anchor")["port"]
    assert v["gap_is_anchor"] and v["status"][:2] == ["ok", "ok"]
    assert v["seen"][0] == "dispatched" and len(v["seen"][1]) >= 1 and v["seen"][2:] == [True, "cancelled", 1]
    assert v["tokens"][3] == v["ref"] and v["again"] is False
    assert v["stats"]["cancelled"] == 1 and v["health_cancelled"] == 1


def test_gateway_streams(S):
    v = run(S, "http_paged")["port"]
    for (status, frames), ref in zip(v["results"], v["ref"]):
        assert status == 200 and frames[-1][1]["status"] == "ok" and _tokens(frames) == ref
    assert [f[0][0] for _, f in v["results"]] == ["sse", "jsonl", "sse"]
    assert v["pool"] == {"in_use": 0, "reserved": 0, "leaked": 0}
    assert v["streams"]["streams"] == 3 and v["streams"]["streams_completed"] == 3
    assert v["streams"]["streams_by_tenant"] == {"acme": 1, "default": 2}
    assert v["joined"] and v["socket_ttft_count"] == 3 and v["socket_at_least_engine"]
    f = run(S, "http_fleet_and_bucket")["port"]
    assert [_tokens(fr) for _, fr in f["fleet"]] == f["ref"]
    assert _tokens(f["bucket"][1]) == f["ref"][0]
    assert f["fleet_counters"]["fleet_requests_completed_total"] == 2


def test_gateway_disconnects(S, tmp_path_factory):
    d = run(S, "http_disconnect")["port"]
    assert d["survivor"][-1][1]["status"] == "ok" and _tokens(d["survivor"]) == d["ref"]
    assert d["pool"] == {"in_use": 0, "reserved": 0, "leaked": 0} and d["cancelled_pages"]
    assert d["terminal"] == ["cancelled", "ok"]
    assert d["streams"]["streams_cancelled"] == 1 and d["streams"]["streams_completed"] == 1
    m = run(S, "http_mass_abandonment", tmp_path_factory)["port"]
    for i in (0, 2):
        assert len(_tokens(m["results"][i])) == 1 and not any(r.get("done") for _, r in m["results"][i])
    for i in (1, 3):
        assert m["results"][i][-1][1]["status"] == "ok" and _tokens(m["results"][i]) == m["ref"][i]
    assert m["pool"] == {"in_use": 0, "reserved": 0, "leaked": 0} and m["fired"] == 2
    assert m["streams"]["streams_cancelled"] == 2 and m["streams"]["streams_completed"] == 2
    assert m["counts"] == {"serving_requests_cancelled_total": 2, "serving_requests_completed_total": 2,
                           "serving_requests_submitted_total": 4}
    assert m["bundles"] == ["incident-001-mass_disconnect"] and m["triggers"] == 1


def test_gateway_endpoints_loadgen_report_help(S):
    e = run(S, "endpoints")["port"]
    assert e[0] == (200, True, True) and e[1][0] == 200 and len(e[1][1]) == 6
    assert e[2][0] == 404 and e[3][0] == 405
    assert [code for code, _ in e[4:14]] == [400] * 10
    assert "exceeds the largest bucket" in e[5][1]["error"] and b"413" in e[14]
    assert e[15] == {"serving_requests_rejected_total": 1, "gateway_streams_rejected_total": 10}
    assert e[16][:2] == (503, "1") and e[17] == 503 and e[18][0] == "QueueFull"
    assert "stream must be one of" in e[19] and e[20] == ("failed", True, False)
    lg = run(S, "loadgen_http")["port"]
    assert lg["report"] == {"offered": 5, "completed": 5, "goodput_ratio": 1.0} and lg["bytes"]
    assert all(st == "ok" and len(res) >= 2 and tid for st, res, tid in lg["handles"])
    r = run(S, "report_fixtures")["port"]
    assert r["gateway"]["streams"]["total"] == 5 and r["gateway"]["streams"]["cancelled"] == 1
    assert r["gateway"]["socket_vs_engine_ttft_delta_ms"] == {"p50_ms": 2.0, "p95_ms": 3.0}
    assert r["fallback"]["source"] == "events" and "None" not in r["fallback_text"].split("\n==")[0]
    h = run(S, "help_families")["port"]
    assert h["frames"][-1][1]["status"] == "ok" and h["missing"] == [] and h["no_help_line"] == []
    assert {"gateway_socket_ttft_ms", "gateway_streams_total"} <= set(h["gateway"])
