"""``obs report`` — offline analyzer over ``events.jsonl`` + a metrics
snapshot: the dashboard-less debugging path.

A BENCH file or a production serve run leaves two artifacts behind —
span events (``--obs.events_path``) and a registry snapshot
(``--obs.snapshot_path``, ledger table included). This module turns them
back into the four questions an operator asks first, with no dashboard,
no scrape endpoint, and no live process:

1. **Per-phase latency breakdown** — every span family's count, total,
   p50/p95/max, so "where did the wall time go" reads off one table.
2. **Worst-request waterfall** — the slowest terminal ``serving.request``
   trace, with every span/event on that trace laid out by offset from
   submit.
3. **Compile/memory table** — the device-cost ledger's per-executor rows
   (compile ms, FLOPs, bytes accessed, temp/output/argument bytes, retrace
   reasons), read from the snapshot's ``compile_ledger`` or — when only
   events exist — from the ``ledger.compile`` events the serve CLI
   forwards.
4. **Padding waste** — prompt-token and decode-row real-vs-padded ratios
   from the snapshot counters.
5. **Fleet supervision** (when the run had one, docs/serving.md) —
   per-replica completion attribution from the terminal ``fleet.request``
   spans, plus failover / redispatch / breaker-open / duplicate-dedupe
   accounting from the ``fleet_*`` counters.

Percentiles are computed through the SAME
:class:`~perceiver_io_tpu_torch.observability.Histogram` the live registry uses
(nearest-rank over the window), so the report's request-latency breakdown
reproduces what ``stats()`` reported at record time — pinned by
``tests/test_ledger.py``.

Entry points: ``<family CLI> obs report --events events.jsonl
[--snapshot snap.json]`` or ``python -m
perceiver_io_tpu_torch.observability.report events.jsonl --snapshot snap.json``
(also behind ``make obs-report``). Stdlib-only: the analyzer must run
where jax does not.

**`obs incident`** (docs/observability.md "Flight recorder & incident
bundles") is the second analyzer in this module: point it at one
:class:`~perceiver_io_tpu_torch.observability.FlightRecorder` bundle and it
renders the trigger metadata, a causal timeline (breaches, replica
failures, breaker transitions, scale events, cancellations, every non-ok
terminal), the counter movement between the bundle's before/now registry
snapshots, captured state (engine/fleet health, KV pool, autoscaler), and
— the headline — a per-request **TTFT critical-path decomposition**
straight from the span events the engines already emit: front-door wait
(socket accept / fleet queue before the engine submit), engine queue
wait, prefill (chunked admissions included), and the first decode step,
telescoping EXACTLY to the request's recorded ``serving_ttft_ms`` — with
the worst request pinned against the registry's nearest-rank percentiles
like every other section.

**`obs timeline`** (docs/observability.md "Scheduler timeline &
post-mortems") is the third analyzer: point it at a
:class:`~perceiver_io_tpu_torch.observability.StepTimeline` JSONL export
(``--obs.timeline.export``) and it renders the scheduler flight deck — a
per-slot Gantt text view of admissions / prefill chunks / tokens /
retirements / preemptions, per-pass phase percentiles, disposition
accounting, and a per-request ``ttft + Σ itl`` decomposition that
telescopes exactly to the terminal span durations (0.0 unattributed on a
FakeClock run, same bar as the incident TTFT split). ``--trace-out``
additionally emits Chrome-trace JSON built from the ring AND the span
events — load it in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from perceiver_io_tpu_torch.observability.registry import Histogram
from perceiver_io_tpu_torch.observability.timeline import read_timeline_jsonl
from perceiver_io_tpu_torch.observability.tracing import (
    TAIL_KEEP_STATUSES,
    read_events_jsonl,
)


def _percentiles(values: List[float]) -> dict:
    """count/total/p50/p95/max via the registry's own Histogram at its
    default window, so offline numbers match the live export's nearest-rank
    convention — including the last-2048 sliding window on runs whose span
    count exceeds it (events stream in observation order)."""
    hist = Histogram()
    for v in values:
        hist.observe(v)
    summ = hist.summary()
    return {
        "count": summ["count"],
        "total_ms": summ["sum"],
        "p50_ms": summ["p50"],
        "p95_ms": summ["p95"],
        "max_ms": summ["max"],
    }


def analyze(events: List[dict], snapshot: Optional[dict] = None) -> dict:
    """Pure analysis over parsed events rows (+ optional snapshot dict);
    returns the JSON-able report body ``format_report`` renders."""
    snapshot = snapshot or {}
    by_span: Dict[str, List[float]] = {}
    for row in events:
        if row.get("span") == "ledger.compile":
            # a forwarded ledger record is a point event — its real cost is
            # attrs.compile_ms, rendered in the compile table below; a
            # 0-duration row here would contradict that table
            continue
        dur = row.get("duration_ms")
        if isinstance(dur, (int, float)):
            by_span.setdefault(row.get("span", "?"), []).append(float(dur))
    phases = {name: _percentiles(vals) for name, vals in sorted(by_span.items())}

    terminals = [r for r in events if r.get("span") == "serving.request"]
    by_status: Dict[str, int] = {}
    for r in terminals:
        status = r.get("status", "?")
        by_status[status] = by_status.get(status, 0) + 1
    latencies = [
        float(r["duration_ms"]) for r in terminals
        if isinstance(r.get("duration_ms"), (int, float))
    ]
    requests = {
        "terminal_spans": len(terminals),
        "by_status": dict(sorted(by_status.items())),
        "latency": _percentiles(latencies) if latencies else None,
    }

    worst = None
    timed = [r for r in terminals if isinstance(r.get("duration_ms"), (int, float))]
    if timed:
        worst_row = max(timed, key=lambda r: r["duration_ms"])
        trace_id = worst_row.get("trace_id")
        trace_rows = [r for r in events if r.get("trace_id") == trace_id]
        t0 = min(
            (r["start_s"] for r in trace_rows if isinstance(r.get("start_s"), (int, float))),
            default=0.0,
        )
        waterfall = []
        for r in sorted(trace_rows, key=lambda r: (r.get("start_s") or 0.0)):
            attrs = r.get("attrs") or {}
            waterfall.append({
                "span": r.get("span"),
                "offset_ms": round(((r.get("start_s") or t0) - t0) * 1e3, 3),
                "duration_ms": r.get("duration_ms"),
                "status": r.get("status"),
                # the scheduling attrs a human reads first; the rest stay
                # in the events file
                "attrs": {
                    k: attrs[k] for k in
                    ("slot", "bucket", "prefill_ms", "chunk", "decode_steps",
                     "size", "execute_ms", "error", "shared_tokens",
                     "shared_blocks", "cow")
                    if k in attrs
                },
            })
        worst = {
            "trace_id": trace_id,
            "status": worst_row.get("status"),
            "duration_ms": worst_row.get("duration_ms"),
            "spans": waterfall,
        }

    compiles = _compile_table(events, snapshot)
    padding = _padding_waste(snapshot)
    return {
        "phases": phases,
        "requests": requests,
        "worst_request": worst,
        "compiles": compiles,
        "padding": padding,
        "fleet": _fleet_section(events, snapshot),
        "kv_pool": _kv_pool_section(snapshot),
        "sharding": _sharding_section(snapshot),
        "slo": _slo_section(events, snapshot),
        "gateway": _gateway_section(events, snapshot),
        "elasticity": _elasticity_section(events, snapshot),
    }


def _elasticity_section(events: List[dict], snapshot: dict) -> Optional[dict]:
    """Fleet-elasticity rollup (docs/serving.md "Elasticity"): the
    scale-event timeline from the ``autoscaler.*`` events (scale-up/-down
    transitions, spawn failures, ladder-rung changes, each with its
    replica-count attrs), scale counts from the ``fleet_scale_*`` counters,
    and the autoscaler's ladder/hysteresis gauges. None when the run had no
    elasticity (pre-autoscaler artifacts stay unchanged)."""
    counters = snapshot.get("counters") or {}
    gauges = snapshot.get("gauges") or {}
    scale_events = [
        r for r in events
        if (r.get("span") or "").startswith("autoscaler.")
    ]
    # the fleet pre-declares fleet_scale_* at 0 (FLEET_COUNTERS), so key
    # PRESENCE means "a fleet ran", not "elasticity happened" — require an
    # autoscaler (its counters only exist when one was built), a nonzero
    # scale count (operator-driven add/remove), or an autoscaler.* event
    has_elasticity = bool(scale_events) or any(
        k.startswith("autoscaler_") for k in counters
    ) or any(
        counters.get(k) for k in counters if k.startswith("fleet_scale_")
    )
    if not has_elasticity:
        return None

    def c(name: str) -> Optional[int]:
        v = counters.get(name)
        return None if v is None else int(v)

    t0 = min(
        (r["start_s"] for r in events
         if isinstance(r.get("start_s"), (int, float))),
        default=0.0,
    )
    timeline = []
    by_event: Dict[str, int] = {}
    for r in sorted(scale_events, key=lambda r: r.get("start_s") or 0.0):
        name = r.get("span", "?")
        by_event[name] = by_event.get(name, 0) + 1
        attrs = r.get("attrs") or {}
        timeline.append({
            "offset_s": round(float(r.get("start_s") or t0) - t0, 6),
            "event": name,
            "replica": attrs.get("replica"),
            "reason": attrs.get("reason"),
            "rung": attrs.get("rung"),
            "replicas_after": attrs.get("replicas_after"),
            "in_flight_replayed": attrs.get("in_flight_replayed"),
        })
    rung = gauges.get("autoscaler_ladder_rung")
    return {
        "scale_ups": c("fleet_scale_up_total"),
        "scale_downs": c("fleet_scale_down_total"),
        "spawn_failures": c("fleet_scale_up_failed_total"),
        "evaluations": c("autoscaler_evaluations_total"),
        "holds": c("autoscaler_holds_total"),
        "ladder_rung": None if rung is None else int(rung),
        "replicas": (
            None if gauges.get("fleet_replicas") is None
            else int(gauges["fleet_replicas"])
        ),
        "events_by_kind": dict(sorted(by_event.items())),
        "timeline": timeline,
    }


def _gateway_section(events: List[dict], snapshot: dict) -> Optional[dict]:
    """HTTP streaming gateway rollup (docs/serving.md "Streaming"): the
    connection/stream table from the ``gateway_*`` counters, per-stream
    outcomes from the ``gateway.request`` events, cancellation accounting
    (``serving.cancelled`` events + the cancelled counters), and the
    socket-vs-engine TTFT delta — ``gateway_socket_ttft_ms`` measures
    accept → first token byte on the wire, ``serving_ttft_ms`` is anchored
    at the same accept instant but ends when the ENGINE materializes the
    token, so the difference is the response-path overhead. None when the
    run had no gateway (pre-gateway artifacts stay unchanged)."""
    counters = snapshot.get("counters") or {}
    gauges = snapshot.get("gauges") or {}
    hists = snapshot.get("histograms") or {}
    gw_events = [r for r in events if r.get("span") == "gateway.request"]
    cancel_events = [r for r in events if r.get("span") == "serving.cancelled"]
    has_gateway = gw_events or any(k.startswith("gateway_") for k in counters)
    if not has_gateway:
        return None

    def c(name: str) -> Optional[int]:
        v = counters.get(name)
        return None if v is None else int(v)

    by_status: Dict[str, int] = {}
    tokens = 0
    stream_bytes = 0
    for r in gw_events:
        status = r.get("status", "?")
        by_status[status] = by_status.get(status, 0) + 1
        attrs = r.get("attrs") or {}
        tokens += int(attrs.get("tokens") or 0)
        stream_bytes += int(attrs.get("bytes") or 0)

    def summ(name: str) -> Optional[dict]:
        h = hists.get(name)
        if h is None:
            return None
        return {
            "count": h.get("count"), "p50_ms": h.get("p50"),
            "p95_ms": h.get("p95"), "max_ms": h.get("max"),
        }

    socket_ttft = summ("gateway_socket_ttft_ms")
    engine_ttft = summ("serving_ttft_ms")
    ttft_delta = None
    if socket_ttft and engine_ttft:
        ttft_delta = {
            q: (
                None
                if socket_ttft[q] is None or engine_ttft[q] is None
                else round(socket_ttft[q] - engine_ttft[q], 3)
            )
            for q in ("p50_ms", "p95_ms")
        }
    # events-only fallback (the slo/fleet-section stance): with no snapshot,
    # the gateway.request events still yield the stream table. "completed"
    # means SERVER-SIDE terminal reached (ok/failed/timed_out alike — the
    # live gateway_streams_completed_total semantics), so it is everything
    # that was not client-cancelled; by_status carries the breakdown.
    streams_total = c("gateway_streams_total")
    streams_completed = c("gateway_streams_completed_total")
    streams_cancelled = c("gateway_streams_cancelled_total")
    source = "snapshot"
    if streams_total is None and gw_events:
        source = "events"
        streams_total = len(gw_events)
        streams_cancelled = by_status.get("cancelled", 0)
        streams_completed = streams_total - streams_cancelled
    return {
        "source": source,
        "connections": {
            "total": c("gateway_connections_total"),
            "active": (
                None if gauges.get("gateway_connections_active") is None
                else int(gauges["gateway_connections_active"])
            ),
        },
        "streams": {
            "total": streams_total,
            "completed": streams_completed,
            "cancelled": streams_cancelled,
            "rejected": c("gateway_streams_rejected_total"),
            "by_status": dict(sorted(by_status.items())),
            "events": len(gw_events),
            "tokens_streamed": tokens,
            "stream_bytes": stream_bytes,
        },
        "cancellations": {
            "events": len(cancel_events),
            "requests_cancelled": c("serving_requests_cancelled_total"),
            "fleet_requests_cancelled": c("fleet_requests_cancelled_total"),
        },
        "bytes_sent": c("gateway_bytes_sent_total"),
        "socket_ttft": socket_ttft,
        "engine_ttft": engine_ttft,
        "socket_vs_engine_ttft_delta_ms": ttft_delta,
    }


def _slo_section(events: List[dict], snapshot: dict) -> Optional[dict]:
    """SLO telemetry rollup (docs/observability.md): TTFT / inter-token
    latency tables, the breach timeline, burn-rate gauges, and the shared
    goodput-under-SLO accounting. Latency percentiles come straight from
    the snapshot's registry histogram summaries — the registry's own
    nearest-rank values, reproduced exactly — with a fallback recomputation
    from ``serving.first_token`` events through the SAME
    :class:`~perceiver_io_tpu_torch.observability.Histogram` when only events
    exist. None when the run recorded nothing SLO-shaped (old artifacts
    stay unchanged)."""
    from perceiver_io_tpu_torch.observability.slo import goodput_ratio, offered_load

    hists = snapshot.get("histograms") or {}
    counters = snapshot.get("counters") or {}
    gauges = snapshot.get("gauges") or {}
    first_tokens = [r for r in events if r.get("span") == "serving.first_token"]
    transitions = [
        r for r in events if r.get("span") in ("slo.breach", "slo.recover")
    ]
    has_slo = (
        "serving_ttft_ms" in hists or "serving_inter_token_ms" in hists
        or first_tokens or transitions
        or any(k.startswith("slo_") for k in counters)
    )
    if not has_slo:
        return None

    def latency(hist_name: str, event_attr: str) -> Optional[dict]:
        summ = hists.get(hist_name)
        if summ is not None:
            return {
                "source": "snapshot", "count": summ.get("count"),
                "p50_ms": summ.get("p50"), "p95_ms": summ.get("p95"),
                "p99_ms": summ.get("p99"), "max_ms": summ.get("max"),
            }
        vals = [
            float((r.get("attrs") or {})[event_attr]) for r in first_tokens
            if isinstance((r.get("attrs") or {}).get(event_attr), (int, float))
        ]
        if not vals:
            return None
        hist = Histogram()
        for v in vals:
            hist.observe(v)
        summ = hist.summary()
        return {
            "source": "events", "count": summ["count"],
            "p50_ms": summ["p50"], "p95_ms": summ["p95"],
            "p99_ms": summ["p99"], "max_ms": summ["max"],
        }

    t0 = min(
        (r["start_s"] for r in events
         if isinstance(r.get("start_s"), (int, float))),
        default=0.0,
    )
    timeline = [
        {
            "offset_s": round(float(r.get("start_s") or t0) - t0, 6),
            "event": r.get("span"),
            "dimension": (r.get("attrs") or {}).get("dimension"),
            "burn_fast": (r.get("attrs") or {}).get("burn_fast"),
            "burn_slow": (r.get("attrs") or {}).get("burn_slow"),
        }
        for r in sorted(transitions, key=lambda r: r.get("start_s") or 0.0)
    ]

    def c(name: str) -> Optional[int]:
        v = counters.get(name)
        return None if v is None else int(v)

    goodput = None
    prefix = "fleet" if any(
        k.startswith("fleet_requests_") for k in counters
    ) else "serving"
    if counters:
        goodput = {
            "prefix": prefix,
            "offered": offered_load(counters, prefix),
            "completed": c(f"{prefix}_requests_completed_total"),
            "ratio": round(goodput_ratio(counters, prefix), 4),
        }
    return {
        "ttft": latency("serving_ttft_ms", "ttft_ms"),
        "inter_token": latency("serving_inter_token_ms", "inter_token_ms"),
        "first_token_events": len(first_tokens),
        "breaches": c("slo_breach_total"),
        "recoveries": c("slo_recoveries_total"),
        "burn_rates": {
            k: gauges[k] for k in sorted(gauges) if k.startswith("slo_burn_rate")
        },
        "timeline": timeline,
        "goodput": goodput,
    }


def _kv_pool_section(snapshot: dict) -> Optional[dict]:
    """Block-paged KV pool rollup (docs/serving.md "Block-paged KV"):
    page utilization / high-water mark from the ``kv_pool_*`` gauges,
    alloc/free churn from the counters, and the live-vs-worst-case byte
    gauges (``kv_cache_resident_bytes`` vs ``kv_cache_capacity_bytes``).
    None when the run had no paged slot engine — dense-run artifacts stay
    unchanged."""
    gauges = snapshot.get("gauges") or {}
    counters = snapshot.get("counters") or {}
    blocks = gauges.get("kv_pool_blocks")
    if blocks is None:
        return None

    def g(name):
        v = gauges.get(name)
        return None if v is None else int(v)

    def c(name):
        v = counters.get(name)
        return None if v is None else int(v)

    in_use = g("kv_pool_blocks_in_use")
    high = g("kv_pool_blocks_high_water")
    # prefix-cache rollup (docs/serving.md "Prefix sharing"): hit/miss
    # ratio, skipped-projection tokens, COW/eviction churn from the
    # kv_prefix_* families (per-admission serving.prefix_hit events render
    # in the request waterfall). None when the run never enabled sharing —
    # pre-prefix artifacts stay unchanged.
    prefix = None
    hits = c("kv_prefix_hits_total")
    misses = c("kv_prefix_misses_total")
    if hits is not None or misses is not None:
        prefix = {
            "hits": hits or 0,
            "misses": misses or 0,
            "hit_ratio": round((hits or 0) / max(1, (hits or 0) + (misses or 0)), 4),
            "shared_blocks": c("kv_prefix_shared_blocks_total"),
            "shared_tokens": c("kv_prefix_shared_tokens_total"),
            "cow_copies": c("kv_prefix_cow_copies_total"),
            "evicted_blocks": c("kv_prefix_evicted_blocks_total"),
            "published_blocks": c("kv_prefix_published_blocks_total"),
            "cached_blocks": g("kv_prefix_cached_blocks"),
        }
    # preemption rollup (docs/serving.md "Preemption & priorities"):
    # preempt/readmit churn plus the live free-beyond-reservations
    # headroom gauge. None when the run never preempted AND never ran
    # lazily — strict-admission artifacts stay unchanged.
    preemption = None
    preempts = c("kv_preemptions_total")
    headroom = g("kv_pool_headroom_blocks")
    if preempts is not None or headroom is not None:
        preemption = {
            "preemptions": preempts or 0,
            "readmissions": c("kv_readmissions_total") or 0,
            "headroom_blocks": headroom,
        }
        # host-swap rollup (docs/serving.md "Host-swap preemption"):
        # victims that paid transfer instead of recompute. Omitted when
        # the run never swapped — recompute artifacts stay unchanged.
        swaps = c("kv_swaps_total")
        if swaps:
            preemption["swaps"] = swaps
            preemption["swap_restores"] = c("kv_swap_restores_total") or 0
            preemption["swap_bytes"] = c("kv_swap_bytes_total") or 0
    return {
        "blocks": int(blocks),
        "blocks_in_use": in_use,
        "blocks_reserved": g("kv_pool_blocks_reserved"),
        "high_water": high,
        "utilization": (
            None if in_use is None else round(in_use / max(1, int(blocks)), 4)
        ),
        "high_water_utilization": (
            None if high is None else round(high / max(1, int(blocks)), 4)
        ),
        "block_allocs": c("kv_pool_block_allocs_total"),
        "block_frees": c("kv_pool_block_frees_total"),
        "admit_waits": c("kv_pool_admit_waits_total"),
        "resident_bytes": g("kv_cache_resident_bytes"),
        "capacity_bytes": g("kv_cache_capacity_bytes"),
        # quantized-KV / ragged-kernel rollup (docs/serving.md "Quantized
        # KV"): nonzero block_scale_bytes is how a report reader tells an
        # int8 pool from an exact one without the engine's stats dict
        "block_bytes": g("kv_pool_block_bytes"),
        "block_scale_bytes": g("kv_pool_block_scale_bytes"),
        "quant_fallbacks": c("kv_quant_fallback_total"),
        "ragged_kernel_enabled": g("kv_ragged_kernel_enabled"),
        "ragged_kernel_steps": c("kv_ragged_kernel_steps_total"),
        "prefix_cache": prefix,
        "preemption": preemption,
    }


def _sharding_section(snapshot: dict) -> Optional[dict]:
    """Sharded-serving rollup (docs/serving.md "Sharded serving"): the mesh
    shape from the ``serving_mesh_*`` gauges, per-shard vs total live KV
    bytes, and the mesh-attributed retrace accounting — the
    ``retrace_reason_mesh_total`` counter plus the distinct ``mesh``
    components in the compile ledger (a mesh flip rebuilds; a reuse would
    show zero here and a stale single-device executor in production). None
    when the run served unsharded — pre-mesh artifacts stay unchanged."""
    gauges = snapshot.get("gauges") or {}
    counters = snapshot.get("counters") or {}
    devices = gauges.get("serving_mesh_devices")
    if devices is None:
        return None

    def g(name):
        v = gauges.get(name)
        return None if v is None else int(v)

    ledger = snapshot.get("compile_ledger") or {}
    meshes = sorted({
        str((rec.get("components") or {}).get("mesh"))
        for rec in ledger.get("records") or []
        if (rec.get("components") or {}).get("mesh")
    })
    resident = g("kv_cache_resident_bytes")
    per_shard = g("kv_cache_resident_bytes_per_shard")
    retraces = counters.get("retrace_reason_mesh_total")
    return {
        "devices": int(devices),
        "data": g("serving_mesh_data"),
        "model": g("serving_mesh_model"),
        "resident_bytes": resident,
        "per_shard_resident_bytes": per_shard,
        "mesh_retraces": None if retraces is None else int(retraces),
        "ledger_meshes": meshes,
    }


def _fleet_section(events: List[dict], snapshot: dict) -> Optional[dict]:
    """Fleet supervision rollup (docs/serving.md): terminal ``fleet.request``
    spans give per-replica completion attribution; the snapshot's ``fleet_*``
    counters give failover / redispatch / breaker accounting. None when the
    run had no fleet layer (single-engine artifacts stay unchanged)."""
    terminals = [r for r in events if r.get("span") == "fleet.request"]
    counters = snapshot.get("counters") or {}
    gauges = snapshot.get("gauges") or {}
    has_counters = any(k.startswith("fleet_") for k in counters)
    if not terminals and not has_counters:
        return None
    by_status: Dict[str, int] = {}
    by_replica: Dict[str, int] = {}
    redispatched = 0
    for r in terminals:
        status = r.get("status", "?")
        by_status[status] = by_status.get(status, 0) + 1
        attrs = r.get("attrs") or {}
        if status == "ok":
            rid = attrs.get("replica")
            if rid is not None:
                by_replica[str(rid)] = by_replica.get(str(rid), 0) + 1
        if (attrs.get("dispatches") or 0) > 1:
            redispatched += 1

    def c(name: str) -> Optional[int]:
        v = counters.get(name)
        return None if v is None else int(v)

    return {
        "terminal_spans": len(terminals),
        "by_status": dict(sorted(by_status.items())),
        "completed_by_replica": dict(sorted(by_replica.items())),
        "requests_redispatched": redispatched,
        "failovers": c("fleet_failover_total"),
        "redispatches": c("fleet_redispatch_total"),
        "breaker_opens": c("fleet_breaker_open_total"),
        "replica_failures": c("fleet_replica_failures_total"),
        "replica_restarts": c("fleet_replica_restarts_total"),
        "duplicates_ignored": c("fleet_duplicate_results_total"),
        "replicas": (
            None if gauges.get("fleet_replicas") is None
            else int(gauges["fleet_replicas"])
        ),
        "replicas_healthy": (
            None if gauges.get("fleet_replicas_healthy") is None
            else int(gauges["fleet_replicas_healthy"])
        ),
    }


def _compile_table(events: List[dict], snapshot: dict) -> dict:
    ledger = snapshot.get("compile_ledger") or {}
    records = list(ledger.get("records") or [])
    source = "snapshot" if records else None
    if not records:
        # fall back to the ledger.compile events the serve CLI forwards
        for row in events:
            if row.get("span") != "ledger.compile":
                continue
            attrs = row.get("attrs") or {}
            records.append({
                "site": attrs.get("site"),
                # the one component the CLI forwards per event — keeps
                # per-bucket rows distinguishable in the rendered table
                "components": (
                    {"bucket_shape": attrs["bucket_shape"]}
                    if attrs.get("bucket_shape") else {}
                ),
                "compile_ms": attrs.get("compile_ms"),
                "flops": attrs.get("flops"),
                "bytes_accessed": attrs.get("bytes_accessed"),
                "temp_bytes": attrs.get("temp_bytes"),
                "output_bytes": attrs.get("output_bytes"),
                "argument_bytes": attrs.get("argument_bytes"),
                "retrace": attrs.get("retrace"),
                "retrace_reasons": [
                    r for r in (attrs.get("reasons") or "").split(",") if r
                ],
            })
        source = "events" if records else None
    reasons: Dict[str, int] = dict(ledger.get("retrace_reasons") or {})
    if not reasons:
        for rec in records:
            for reason in rec.get("retrace_reasons") or []:
                reasons[reason] = reasons.get(reason, 0) + 1
    # prefer the snapshot's LIFETIME rollup fields: on long runs the record
    # table is FIFO-bounded (keep=512) and summing it would under-report;
    # events-only input recomputes from the rows it has
    count = ledger.get("compiles")
    retraces = ledger.get("retraces")
    total_ms = ledger.get("compile_ms_total")
    if count is None:
        count = len(records)
    if retraces is None:
        retraces = sum(1 for r in records if r.get("retrace"))
    if total_ms is None:
        total_ms = round(
            sum(float(r["compile_ms"]) for r in records
                if isinstance(r.get("compile_ms"), (int, float))), 3,
        )
    return {
        "source": source,
        "count": int(count),
        "retraces": int(retraces),
        "retrace_reasons": dict(sorted(reasons.items())),
        "compile_ms_total": float(total_ms),
        "records": records,
    }


def _padding_waste(snapshot: dict) -> Optional[dict]:
    counters = snapshot.get("counters") or {}
    if not counters:
        return None

    def ratio(padded_key: str, total_key: str) -> Optional[float]:
        total = counters.get(total_key)
        if not total:
            return None
        return round(float(counters.get(padded_key, 0.0)) / float(total), 4)

    real = counters.get("serving_prompt_tokens_real_total")
    padded = counters.get("serving_prompt_tokens_padded_total")
    return {
        "prompt_padding_efficiency": (
            None if not padded else round(float(real or 0.0) / float(padded), 4)
        ),
        "decode_rows_padding_waste": ratio(
            "serving_decode_rows_padded_total", "serving_decode_rows_total"
        ),
    }


def _fmt(value, width: int = 10) -> str:
    if value is None:
        return "-".rjust(width)
    if isinstance(value, float):
        return f"{value:,.2f}".rjust(width)
    return f"{value:,}".rjust(width)


def format_report(analysis: dict, *, top: int = 20) -> str:
    """Human-readable rendering of :func:`analyze`'s output."""
    out: List[str] = []

    out.append("== per-phase latency breakdown ==")
    phases = analysis["phases"]
    if phases:
        out.append(
            f"{'span':<28}{'count':>8}{'total_ms':>12}{'p50_ms':>10}"
            f"{'p95_ms':>10}{'max_ms':>10}"
        )
        for name, p in phases.items():
            out.append(
                f"{name:<28}{p['count']:>8}{_fmt(p['total_ms'], 12)}"
                f"{_fmt(p['p50_ms'])}{_fmt(p['p95_ms'])}{_fmt(p['max_ms'])}"
            )
    else:
        out.append("(no timed spans in events)")

    req = analysis["requests"]
    out.append("")
    out.append("== requests ==")
    out.append(
        f"terminal spans: {req['terminal_spans']}  by status: "
        + (", ".join(f"{k}={v}" for k, v in req["by_status"].items()) or "-")
    )
    if req["latency"]:
        lat = req["latency"]
        out.append(
            f"request latency ms: p50={lat['p50_ms']} p95={lat['p95_ms']} "
            f"max={lat['max_ms']} (n={lat['count']})"
        )

    worst = analysis["worst_request"]
    out.append("")
    out.append("== worst-request waterfall ==")
    if worst:
        out.append(
            f"trace {worst['trace_id']}  status={worst['status']}  "
            f"latency={worst['duration_ms']} ms"
        )
        for row in worst["spans"]:
            attrs = "".join(
                f" {k}={v}" for k, v in (row["attrs"] or {}).items()
            )
            out.append(
                f"  +{row['offset_ms']:>10.3f} ms  {row['span']:<24}"
                f" {row['duration_ms'] if row['duration_ms'] is not None else '-':>10}"
                f" ms  [{row['status']}]{attrs}"
            )
    else:
        out.append("(no timed terminal request spans)")

    comp = analysis["compiles"]
    out.append("")
    out.append("== compile/memory ledger ==")
    if comp["count"]:
        out.append(
            f"{comp['count']} compiles ({comp['retraces']} retraces) from "
            f"{comp['source']}; compile_ms_total={comp['compile_ms_total']}"
        )
        if comp["retrace_reasons"]:
            out.append(
                "retrace reasons: "
                + ", ".join(f"{k}={v}" for k, v in comp["retrace_reasons"].items())
            )
        out.append(
            f"{'site':<20}{'compile_ms':>12}{'flops':>14}{'bytes_acc':>12}"
            f"{'temp_B':>10}{'out_B':>10}  retrace"
        )
        ranked = sorted(
            comp["records"],
            key=lambda r: -(r.get("compile_ms") or 0.0),
        )[:top]
        for rec in ranked:
            comps = rec.get("components") or {}
            shape = comps.get("bucket_shape") or comps.get("chunk") or ""
            site = f"{rec.get('site')}{f'[{shape}]' if shape else ''}"
            reason = ",".join(rec.get("retrace_reasons") or []) or "-"
            out.append(
                f"{site:<20}{_fmt(rec.get('compile_ms'), 12)}"
                f"{_fmt(rec.get('flops'), 14)}{_fmt(rec.get('bytes_accessed'), 12)}"
                f"{_fmt(rec.get('temp_bytes'))}{_fmt(rec.get('output_bytes'))}"
                f"  {reason}"
            )
        if len(comp["records"]) > top:
            out.append(f"(+{len(comp['records']) - top} more; --top to widen)")
    else:
        out.append("(no ledger data: pass --snapshot or record ledger.compile events)")

    fleet = analysis.get("fleet")
    if fleet:
        out.append("")
        out.append("== fleet ==")
        replicas = fleet.get("replicas")
        healthy = fleet.get("replicas_healthy")
        if replicas is not None:
            out.append(f"replicas: {healthy}/{replicas} healthy")
        out.append(
            f"terminal spans: {fleet['terminal_spans']}  by status: "
            + (", ".join(f"{k}={v}" for k, v in fleet["by_status"].items()) or "-")
        )
        if fleet["completed_by_replica"]:
            out.append(
                "completed by replica: "
                + ", ".join(
                    f"r{k}={v}" for k, v in fleet["completed_by_replica"].items()
                )
            )
        if fleet["failovers"] is None:
            # events-only input: the fleet.request spans exist but the
            # fleet_* counters live in the snapshot (same fallback stance
            # as the compile table's no-ledger message)
            out.append(
                "(no snapshot: failover/breaker counters unavailable — "
                "pass --snapshot)"
            )
        else:
            out.append(
                f"failovers={fleet['failovers']}  "
                f"redispatches={fleet['redispatches']}  "
                f"breaker_opens={fleet['breaker_opens']}  "
                f"replica_restarts={fleet['replica_restarts']}  "
                f"duplicates_ignored={fleet['duplicates_ignored']}"
            )

    elastic = analysis.get("elasticity")
    if elastic:
        out.append("")
        out.append("== elasticity ==")

        def ev(value):
            return "-" if value is None else value

        out.append(
            f"scale_ups={ev(elastic['scale_ups'])}  "
            f"scale_downs={ev(elastic['scale_downs'])}  "
            f"spawn_failures={ev(elastic['spawn_failures'])}  "
            f"evaluations={ev(elastic['evaluations'])}  "
            f"holds={ev(elastic['holds'])}"
            + (
                f"  ladder_rung={elastic['ladder_rung']}"
                if elastic["ladder_rung"] is not None else ""
            )
            + (
                f"  replicas_now={elastic['replicas']}"
                if elastic["replicas"] is not None else ""
            )
        )
        if elastic["timeline"]:
            out.append("scale-event timeline:")
            for row in elastic["timeline"]:
                detail = "".join(
                    f" {k}={row[k]}" for k in
                    ("replica", "reason", "rung", "replicas_after",
                     "in_flight_replayed")
                    if row.get(k) is not None
                )
                out.append(
                    f"  +{row['offset_s']:>10.3f} s  {row['event']:<24}{detail}"
                )

    slo = analysis.get("slo")
    if slo:
        out.append("")
        out.append("== slo ==")
        out.append(
            f"{'metric':<18}{'count':>8}{'p50_ms':>10}{'p95_ms':>10}"
            f"{'p99_ms':>10}{'max_ms':>10}  source"
        )
        for label, key in (("ttft", "ttft"), ("inter_token", "inter_token")):
            row = slo.get(key)
            if row:
                out.append(
                    f"{label:<18}{_fmt(row['count'], 8)}{_fmt(row['p50_ms'])}"
                    f"{_fmt(row['p95_ms'])}{_fmt(row['p99_ms'])}"
                    f"{_fmt(row['max_ms'])}  {row['source']}"
                )
            else:
                out.append(f"{label:<18}{'-':>8}  (no samples)")
        if slo["breaches"] is not None:
            out.append(
                f"breaches={slo['breaches']}  recoveries={slo['recoveries']}"
            )
        if slo["burn_rates"]:
            out.append(
                "burn rates: "
                + ", ".join(f"{k}={v}" for k, v in slo["burn_rates"].items())
            )
        if slo["timeline"]:
            out.append("breach timeline:")
            for row in slo["timeline"]:
                out.append(
                    f"  +{row['offset_s']:>10.3f} s  {row['event']:<14}"
                    f" dim={row['dimension']}"
                    f" burn_fast={row['burn_fast']}"
                    + (f" burn_slow={row['burn_slow']}"
                       if row["burn_slow"] is not None else "")
                )
        if slo["goodput"]:
            g = slo["goodput"]
            out.append(
                f"goodput ({g['prefix']}): {g['completed']}/{g['offered']} "
                f"offered = {g['ratio']}"
            )

    kv = analysis.get("kv_pool")
    if kv:
        out.append("")
        out.append("== kv pool ==")
        out.append(
            f"blocks: {kv['blocks_in_use']}/{kv['blocks']} in use "
            f"(reserved {kv['blocks_reserved']}, high water {kv['high_water']}"
            f" = {kv['high_water_utilization']})"
        )
        out.append(
            f"churn: allocs={kv['block_allocs']} frees={kv['block_frees']} "
            f"admit_waits={kv['admit_waits']}"
        )
        if kv["resident_bytes"] is not None and kv["capacity_bytes"]:
            out.append(
                f"resident {kv['resident_bytes']:,} B of worst-case "
                f"{kv['capacity_bytes']:,} B "
                f"({kv['resident_bytes'] / kv['capacity_bytes']:.1%})"
            )
        if kv.get("block_bytes") is not None:
            scale = kv.get("block_scale_bytes") or 0
            layout = "paged_int8" if scale else "paged (exact)"
            out.append(
                f"layout: {layout}  block_bytes={kv['block_bytes']:,}"
                + (f" + {scale:,} scale" if scale else "")
                + (
                    f"  quant_fallbacks={kv['quant_fallbacks']}"
                    if kv.get("quant_fallbacks") else ""
                )
            )
        if kv.get("ragged_kernel_enabled"):
            out.append(
                "ragged kernel: on  steps="
                f"{kv.get('ragged_kernel_steps') or 0}"
            )
        pc = kv.get("prefix_cache")
        if pc:
            out.append(
                f"prefix cache: {pc['hits']}/{pc['hits'] + pc['misses']} "
                f"admissions hit (ratio {pc['hit_ratio']})  "
                f"shared_blocks={pc['shared_blocks']} "
                f"shared_tokens={pc['shared_tokens']}"
            )
            out.append(
                f"prefix churn: published={pc['published_blocks']} "
                f"evicted={pc['evicted_blocks']} cow={pc['cow_copies']} "
                f"cached_now={pc['cached_blocks']}"
            )
        pre = kv.get("preemption")
        if pre:
            out.append(
                f"preemption: {pre['preemptions']} preempted, "
                f"{pre['readmissions']} readmitted"
                + (
                    f"  headroom_blocks={pre['headroom_blocks']}"
                    if pre["headroom_blocks"] is not None else ""
                )
            )
            if pre.get("swaps"):
                out.append(
                    f"host swap: {pre['swaps']} swapped out, "
                    f"{pre['swap_restores']} restored, "
                    f"{pre['swap_bytes']:,} B over the link"
                )

    mesh = analysis.get("sharding")
    if mesh:
        out.append("")
        out.append("== sharded serving ==")
        shape = (
            f"{mesh['data']}x{mesh['model']}"
            if mesh["data"] is not None and mesh["model"] is not None
            else "?"
        )
        out.append(f"mesh: {shape} over {mesh['devices']} devices")
        if mesh["resident_bytes"] is not None:
            per = mesh["per_shard_resident_bytes"]
            out.append(
                f"kv resident: {mesh['resident_bytes']:,} B total"
                + (f", {per:,} B per model shard" if per is not None else "")
            )
        out.append(
            f"mesh-attributed retraces: "
            f"{mesh['mesh_retraces'] if mesh['mesh_retraces'] is not None else 0}"
            + (
                "  ledger meshes: " + ", ".join(mesh["ledger_meshes"])
                if mesh["ledger_meshes"] else ""
            )
        )

    gw = analysis.get("gateway")
    if gw:
        out.append("")
        out.append("== gateway ==")
        conns = gw["connections"]
        streams = gw["streams"]

        def v(value):
            return "-" if value is None else value

        out.append(
            f"connections: {v(conns['total'])} total"
            + (f" ({conns['active']} active)" if conns["active"] is not None else "")
            + f"  bytes sent: {v(gw['bytes_sent'])}"
        )
        out.append(
            f"streams: {v(streams['total'])} accepted  "
            f"completed={v(streams['completed'])}  "
            f"cancelled={v(streams['cancelled'])}  "
            f"rejected={v(streams['rejected'])}"
            + (
                "  by status: "
                + ", ".join(f"{k}={n}" for k, n in streams["by_status"].items())
                if streams["by_status"] else ""
            )
            + ("  (from events)" if gw.get("source") == "events" else "")
        )
        canc = gw["cancellations"]
        out.append(
            f"cancellations: {canc['events']} serving.cancelled events, "
            f"requests_cancelled={v(canc['requests_cancelled'])}"
            + (
                f", fleet={canc['fleet_requests_cancelled']}"
                if canc["fleet_requests_cancelled"] is not None else ""
            )
        )
        if gw["socket_ttft"]:
            s = gw["socket_ttft"]
            out.append(
                f"socket ttft ms: p50={s['p50_ms']} p95={s['p95_ms']} "
                f"(n={s['count']})"
            )
        if gw["socket_vs_engine_ttft_delta_ms"]:
            d = gw["socket_vs_engine_ttft_delta_ms"]
            out.append(
                f"socket-vs-engine ttft delta ms: p50={d['p50_ms']} "
                f"p95={d['p95_ms']} (response-path overhead)"
            )

    pad = analysis["padding"]
    out.append("")
    out.append("== padding waste ==")
    if pad:
        out.append(
            f"prompt_padding_efficiency={pad['prompt_padding_efficiency']}  "
            f"decode_rows_padding_waste={pad['decode_rows_padding_waste']}"
        )
    else:
        out.append("(no snapshot counters)")
    return "\n".join(out)


# -- `obs incident`: the flight-recorder bundle analyzer ---------------------

#: events that BELONG on an incident's causal timeline regardless of
#: status — the control-plane transitions around the trigger
_CAUSAL_EVENTS = frozenset({
    "slo.breach", "slo.recover",
    "fleet.replica_failed", "fleet.breaker_open", "fleet.breaker_close",
    "fleet.replica_restarted",
    "autoscaler.scale_up", "autoscaler.scale_down",
    "autoscaler.spawn_failed", "autoscaler.rung",
    "serving.cancelled", "incident.dump",
})

#: terminal statuses that put a request span on the timeline — the same
#: set the sampler tail-keeps, so every trace retained for being dirty
#: also surfaces here
_BAD_STATUSES = TAIL_KEEP_STATUSES


def load_bundle(path: str) -> Tuple[dict, List[dict]]:
    """Read one incident bundle — a directory holding ``manifest.json`` +
    ``spans.jsonl`` (or a direct path to the manifest). Returns
    ``(manifest, spans)``; raises ``ValueError`` on a schema the analyzer
    does not understand."""
    if os.path.isdir(path):
        manifest_path = os.path.join(path, "manifest.json")
    else:
        manifest_path = path
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    if manifest.get("schema") != "incident-bundle-v1":
        raise ValueError(
            f"{manifest_path} is not an incident bundle "
            f"(schema={manifest.get('schema')!r}; expected incident-bundle-v1)"
        )
    spans_path = os.path.join(os.path.dirname(manifest_path), "spans.jsonl")
    spans = read_events_jsonl(spans_path) if os.path.exists(spans_path) else []
    return manifest, spans


def _by_trace(events: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for row in events:
        tid = row.get("trace_id")
        if tid is not None:
            out.setdefault(tid, []).append(row)
    return out


def ttft_decomposition(events: List[dict]) -> List[dict]:
    """Per-request TTFT critical-path split from the span events the
    engines already emit, worst first. Anchors are reconstructed from the
    events themselves, so the components TELESCOPE: front_door + queue +
    prefill + first_step == the request's recorded ``serving_ttft_ms``
    exactly (``unattributed`` carries any rounding residue; 0.0 on a
    FakeClock run — the acceptance pin).

    Per trace: the terminal ``serving.request`` span's (backdated) start
    is the ENGINE submit instant; ``serving.first_token``'s start is the
    token instant and its ``ttft_ms`` attr reaches back to the TTFT
    anchor (fleet front door / gateway socket accept), so the gap before
    engine submit is the front-door share; ``serving.slot_assigned``
    marks prefill completion (``prefill_ms`` device time, first
    ``serving.prefill_chunk`` event marks the admission start when
    chunked); what remains up to the token instant is the first decode
    step. Bucket-engine traces (no slot events) fall back to a two-way
    front-door / engine split (``batch_granular``)."""
    rows: List[dict] = []
    for trace_id, trace in sorted(_by_trace(events).items()):
        first = next(
            (r for r in trace if r.get("span") == "serving.first_token"), None
        )
        if first is None:
            continue
        attrs = first.get("attrs") or {}
        ttft_ms = attrs.get("ttft_ms")
        token_s = first.get("start_s")
        if not isinstance(ttft_ms, (int, float)) or not isinstance(
            token_s, (int, float)
        ):
            continue
        anchor_s = token_s - ttft_ms / 1e3
        terminal = next(
            (r for r in trace if r.get("span") == "serving.request"), None
        )
        submit_s = terminal.get("start_s") if terminal else None
        assigned = next(
            (r for r in trace if r.get("span") == "serving.slot_assigned"),
            None,
        )
        row = {
            "trace_id": trace_id,
            "ttft_ms": round(float(ttft_ms), 3),
            "status": terminal.get("status") if terminal else None,
            "prompt_len": (
                (terminal.get("attrs") or {}).get("prompt_len")
                if terminal else None
            ),
            "slot": attrs.get("slot"),
        }
        components: Dict[str, float] = {}
        if assigned is not None and submit_s is not None:
            a_attrs = assigned.get("attrs") or {}
            prefill_end_s = assigned.get("start_s")
            prefill_ms = float(a_attrs.get("prefill_ms") or 0.0)
            chunks = sorted(
                (r for r in trace if r.get("span") == "serving.prefill_chunk"),
                key=lambda r: r.get("start_s") or 0.0,
            )
            if chunks:
                c0 = chunks[0]
                prefill_start_s = (
                    float(c0.get("start_s") or prefill_end_s)
                    - float((c0.get("attrs") or {}).get("ms") or 0.0) / 1e3
                )
            else:
                prefill_start_s = prefill_end_s - prefill_ms / 1e3
            components = {
                "front_door_ms": (submit_s - anchor_s) * 1e3,
                "queue_ms": (prefill_start_s - submit_s) * 1e3,
                "prefill_ms": (prefill_end_s - prefill_start_s) * 1e3,
                "first_step_ms": (token_s - prefill_end_s) * 1e3,
            }
            if a_attrs.get("chunks") is not None:
                row["prefill_chunks"] = a_attrs["chunks"]
        elif submit_s is not None:
            # bucket engine: tokens materialize at batch completion — only
            # the front-door / engine split is recoverable
            components = {
                "front_door_ms": (submit_s - anchor_s) * 1e3,
                "engine_ms": (token_s - submit_s) * 1e3,
            }
            row["batch_granular"] = True
        else:
            components = {"engine_ms": float(ttft_ms)}
        components = {k: round(v, 3) for k, v in components.items()}
        row["components"] = components
        row["unattributed_ms"] = round(
            float(ttft_ms) - sum(components.values()), 3
        )
        rows.append(row)
    rows.sort(key=lambda r: -r["ttft_ms"])
    return rows


def _counter_movement(manifest: dict) -> Optional[List[dict]]:
    """Counters that MOVED between the bundle's last periodic snapshot and
    the dump-time registry — the incident's disposition delta."""
    metrics = manifest.get("metrics") or {}
    before, now = metrics.get("before"), metrics.get("now")
    if not before or not now:
        return None
    before_c = before.get("counters") or {}
    out = []
    for name, value in sorted((now.get("counters") or {}).items()):
        delta = float(value) - float(before_c.get(name, 0.0))
        if delta:
            out.append({
                "name": name, "before": float(before_c.get(name, 0.0)),
                "now": float(value), "delta": round(delta, 6),
            })
    return out


def analyze_incident(manifest: dict, spans: List[dict]) -> dict:
    """Pure analysis over one loaded bundle; returns the JSON-able body
    ``format_incident_report`` renders."""
    trigger = dict(manifest.get("trigger") or {})
    t0 = min(
        (r["start_s"] for r in spans
         if isinstance(r.get("start_s"), (int, float))),
        default=float(trigger.get("at_s") or 0.0),
    )
    timeline = []
    for r in sorted(spans, key=lambda r: r.get("start_s") or 0.0):
        name = r.get("span", "?")
        status = r.get("status")
        if name not in _CAUSAL_EVENTS and status not in _BAD_STATUSES:
            continue
        attrs = r.get("attrs") or {}
        timeline.append({
            "offset_s": round(float(r.get("start_s") or t0) - t0, 6),
            "event": name,
            "status": status,
            "trace_id": r.get("trace_id"),
            "attrs": {
                k: attrs[k] for k in
                ("dimension", "burn_fast", "replica", "reason", "rung",
                 "error", "in_flight", "stage", "cause", "trigger",
                 "bundle", "replicas_after")
                if k in attrs
            },
        })
    now = (manifest.get("metrics") or {}).get("now") or {}
    hists = now.get("histograms") or {}

    def summ(name: str) -> Optional[dict]:
        h = hists.get(name)
        if h is None:
            return None
        return {
            "count": h.get("count"), "p50_ms": h.get("p50"),
            "p95_ms": h.get("p95"), "p99_ms": h.get("p99"),
            "max_ms": h.get("max"),
        }

    decomposition = ttft_decomposition(spans)
    replays = sum(
        1 for r in spans
        if r.get("span") == "fleet.dispatch"
        and ((r.get("attrs") or {}).get("attempt") or 1) > 1
    )
    return {
        "trigger": trigger,
        "seq": manifest.get("seq"),
        "spans": len(spans),
        "trigger_offset_s": (
            None if trigger.get("at_s") is None
            else round(float(trigger["at_s"]) - t0, 6)
        ),
        "timeline": timeline,
        "ttft": summ("serving_ttft_ms"),
        "inter_token": summ("serving_inter_token_ms"),
        "decomposition": decomposition,
        "failover_replays": replays,
        "counter_movement": _counter_movement(manifest),
        "sources": manifest.get("sources") or {},
    }


def format_incident_report(analysis: dict, *, top: int = 8) -> str:
    """Human-readable rendering of :func:`analyze_incident`'s output."""
    out: List[str] = []
    trig = analysis["trigger"]
    out.append("== incident ==")
    out.append(
        f"trigger: {trig.get('kind')}  seq={analysis.get('seq')}  "
        f"spans={analysis['spans']}"
        + (
            f"  at +{analysis['trigger_offset_s']:.3f} s"
            if analysis.get("trigger_offset_s") is not None else ""
        )
    )
    out.append(f"reason: {trig.get('reason')}")
    if trig.get("trace_ids"):
        out.append("trace ids: " + ", ".join(trig["trace_ids"]))

    out.append("")
    out.append("== causal timeline ==")
    if analysis["timeline"]:
        for row in analysis["timeline"]:
            attrs = "".join(
                f" {k}={v}" for k, v in (row["attrs"] or {}).items()
            )
            status = (
                f" [{row['status']}]"
                if row["status"] not in (None, "ok") else ""
            )
            trace = f"  ({row['trace_id']})" if row.get("trace_id") else ""
            out.append(
                f"  +{row['offset_s']:>10.3f} s  {row['event']:<26}"
                f"{status}{attrs}{trace}"
            )
    else:
        out.append("(no causal events in the span slice)")

    out.append("")
    out.append("== per-request ttft decomposition ==")
    rows = analysis["decomposition"]
    if rows:
        keys = ("front_door_ms", "queue_ms", "prefill_ms", "first_step_ms",
                "engine_ms")
        out.append(
            f"{'trace':<16}{'ttft_ms':>10}"
            + "".join(f"{k[:-3]:>12}" for k in keys)
            + f"{'unattrib':>10}  status"
        )
        for row in rows[:top]:
            comp = row["components"]
            out.append(
                f"{str(row['trace_id']):<16}{_fmt(row['ttft_ms'])}"
                + "".join(_fmt(comp.get(k), 12) for k in keys)
                + f"{_fmt(row['unattributed_ms'])}  {row.get('status') or '-'}"
            )
        if len(rows) > top:
            out.append(f"(+{len(rows) - top} more; --top to widen)")
        if analysis.get("failover_replays"):
            out.append(
                f"failover replays in slice: {analysis['failover_replays']} "
                "(re-dispatched requests replay from their prompts; the "
                "replay wait lands in front_door)"
            )
    else:
        out.append("(no serving.first_token events in the span slice)")

    ttft = analysis.get("ttft")
    if ttft:
        out.append("")
        out.append("== registry percentiles (nearest-rank, at dump) ==")
        out.append(
            f"{'metric':<14}{'count':>8}{'p50_ms':>10}{'p95_ms':>10}"
            f"{'p99_ms':>10}{'max_ms':>10}"
        )
        for label, key in (("ttft", "ttft"), ("inter_token", "inter_token")):
            row = analysis.get(key)
            if row:
                out.append(
                    f"{label:<14}{_fmt(row['count'], 8)}{_fmt(row['p50_ms'])}"
                    f"{_fmt(row['p95_ms'])}{_fmt(row['p99_ms'])}"
                    f"{_fmt(row['max_ms'])}"
                )
        if rows and rows[0]["ttft_ms"] is not None and ttft.get("max_ms"):
            out.append(
                f"worst decomposed request = {rows[0]['ttft_ms']} ms "
                f"(registry max {ttft['max_ms']} ms)"
            )

    movement = analysis.get("counter_movement")
    if movement:
        out.append("")
        out.append("== counter movement (last snapshot -> dump) ==")
        for row in movement:
            out.append(
                f"  {row['name']:<44} {row['before']:>10g} -> "
                f"{row['now']:<10g} (+{row['delta']:g})"
            )

    sources = analysis.get("sources") or {}
    if sources:
        out.append("")
        out.append("== captured state ==")
        for name in sorted(sources):
            state = sources[name]
            if isinstance(state, dict):
                # one line per source: the fields an operator reads first
                keys = [
                    k for k in (
                        "ready", "replicas", "replicas_healthy", "draining",
                        "queue_depth", "rung", "breached", "active_breaches",
                        "in_use", "reserved", "blocks", "leaked",
                        "frees_by_cause", "bundles", "error",
                    ) if k in state
                ]
                summary = "  ".join(f"{k}={state[k]}" for k in keys)
                out.append(f"  {name}: {summary or json.dumps(state)[:160]}")
            else:
                out.append(f"  {name}: {state}")
    return "\n".join(out)


def run_incident(bundle_path: str, *, top: int = 8,
                 as_json: bool = False) -> str:
    """Load one bundle, analyze, return the rendered incident report."""
    manifest, spans = load_bundle(bundle_path)
    analysis = analyze_incident(manifest, spans)
    if as_json:
        return json.dumps(analysis, indent=2, sort_keys=True)
    return format_incident_report(analysis, top=top)


def run(events_path: str, snapshot_path: Optional[str] = None, *,
        top: int = 20, as_json: bool = False) -> str:
    """Load artifacts, analyze, and return the rendered report (the string
    the CLI prints)."""
    events = read_events_jsonl(events_path)
    snapshot = None
    if snapshot_path:
        with open(snapshot_path) as fh:
            snapshot = json.load(fh)
    analysis = analyze(events, snapshot)
    if as_json:
        return json.dumps(analysis, indent=2, sort_keys=True)
    return format_report(analysis, top=top)


# ===========================================================================
# `obs timeline` — the scheduler flight deck (docs/observability.md
# "Scheduler timeline & post-mortems"): render a StepTimeline export as a
# per-slot Gantt text view + per-request phase decomposition, and/or emit
# Chrome-trace JSON (load in Perfetto / chrome://tracing) built from the
# ring and the span events together.
# ===========================================================================

#: Gantt cell glyphs, highest display priority first — a pass where a slot
#: was both decoded and preempted shows the preemption.
_GANTT_PRIORITY = "SXRrap#=."
_GANTT_LEGEND = (
    "S=swapped out  X=preempted  R=restored  r=retired  a=admitted  "
    "p=prefill chunk  #=token  ==resident (no token)  .=idle"
)


def load_timeline(path: str) -> List[dict]:
    """Read a ``--obs.timeline.export`` JSONL back (schema-checked)."""
    return read_timeline_jsonl(path)


def _terminal_spans_by_request(events: List[dict]) -> Dict[int, dict]:
    """``request_id -> terminal serving.request row`` — the join key between
    ring records (request_id) and the span stream (trace_id)."""
    out: Dict[int, dict] = {}
    for row in events:
        if row.get("span") != "serving.request":
            continue
        rid = (row.get("attrs") or {}).get("request_id")
        if rid is not None:
            out[int(rid)] = row
    return out


def _timeline_requests(records: List[dict],
                       events: List[dict]) -> List[dict]:
    """Per-request phase decomposition from the ring's token entries, worst
    first. Token entries carry the SAME rounded ``ttft_ms`` / ``itl_ms``
    values the registry observed, so ``ttft_ms + decode_ms`` telescopes
    exactly to the terminal ``serving.request`` span's duration
    (``unattributed_ms`` == 0.0 on a FakeClock run — the
    :func:`ttft_decomposition` exactness bar).

    A preemption replay re-anchors nothing: the replayed first token's
    ``ttft_ms`` still reaches back to the ORIGINAL anchor, so the segment
    from the LAST ``first=True`` entry onward covers the request end to end
    (earlier entries are the discarded replay — surfaced as
    ``replayed_tokens``). ``unattributed_ms`` goes negative exactly when a
    front door (fleet/gateway) anchored TTFT before the engine submit —
    that share lives outside the engine-side terminal span."""
    toks: Dict[int, List[dict]] = {}
    order: List[int] = []
    for rec in records:
        for e in rec.get("tokens") or []:
            rid = e.get("request_id")
            if rid is None:
                continue
            rid = int(rid)
            if rid not in toks:
                order.append(rid)
                toks[rid] = []
            toks[rid].append(e)
    terminals = _terminal_spans_by_request(events)
    rows: List[dict] = []
    for rid in order:
        entries = toks[rid]
        seg_start, attempts = 0, 0
        for i, e in enumerate(entries):
            if e.get("first"):
                attempts += 1
                seg_start = i
        seg = entries[seg_start:]
        ttft = seg[0].get("ttft_ms") if seg and seg[0].get("first") else None
        decode = round(
            sum(float(e.get("itl_ms") or 0.0) for e in seg[1:]), 3
        )
        row: dict = {
            "request_id": rid,
            "tokens": len(seg),
            "replayed_tokens": len(entries) - len(seg),
            "attempts": attempts,
            "ttft_ms": ttft,
            "decode_ms": decode,
        }
        if ttft is not None:
            row["total_ms"] = round(float(ttft) + decode, 3)
        term = terminals.get(rid)
        if term is not None:
            row["status"] = term.get("status")
            row["trace_id"] = term.get("trace_id")
            dur = term.get("duration_ms")
            if isinstance(dur, (int, float)) and ttft is not None:
                row["span_ms"] = round(float(dur), 3)
                row["unattributed_ms"] = round(
                    float(dur) - float(ttft) - decode, 3
                )
        rows.append(row)
    rows.sort(key=lambda r: -(r.get("total_ms") or -1.0))
    return rows


def analyze_timeline(records: List[dict],
                     events: Optional[List[dict]] = None,
                     snapshot: Optional[dict] = None) -> dict:
    """Pure analysis over StepTimeline records (+ optional span events for
    the request join, + optional registry snapshot for the accounting
    closure); returns the JSON-able body ``format_timeline`` renders."""
    events = events or []
    snapshot = snapshot or {}
    phase_vals: Dict[str, List[float]] = {}
    occ_busy = occ_total = 0
    rows_real = rows_padded = 0
    kinds: Dict[str, int] = {}
    by_status: Dict[str, int] = {}
    queue_depths: List[int] = []
    for rec in records:
        for key, val in (rec.get("phases_ms") or {}).items():
            phase_vals.setdefault(key, []).append(float(val))
        slots = rec.get("slots")
        if isinstance(slots, list):
            occ_busy += sum(1 for s in slots if s is not None)
            occ_total += len(slots)
        rows = rec.get("rows") or {}
        rows_real += int(rows.get("real", 0))
        rows_padded += int(rows.get("padded", 0))
        qd = rec.get("queue_depth")
        if isinstance(qd, int):
            queue_depths.append(qd)
        for kind in ("admitted", "chunks", "tokens", "finished",
                     "preempted", "readmitted", "swapped", "restored"):
            entries = rec.get(kind) or []
            if entries:
                kinds[kind] = kinds.get(kind, 0) + len(entries)
        for e in rec.get("finished") or []:
            status = e.get("status", "?")
            by_status[status] = by_status.get(status, 0) + 1
    # disposition closure over the retained ring: every admission is either
    # still resident, finished, or was preempted back to the queue (each
    # readmission re-admits, so preempted - readmitted nets the requeued)
    accounting = {
        "admitted": kinds.get("admitted", 0),
        "finished": sum(by_status.values()),
        "finished_by_status": dict(sorted(by_status.items())),
        "preempted": kinds.get("preempted", 0),
        "readmitted": kinds.get("readmitted", 0),
        "swapped": kinds.get("swapped", 0),
        "restored": kinds.get("restored", 0),
    }
    counters = snapshot.get("counters") or {}
    if counters:
        accounting["registry"] = {
            name: int(counters.get(f"serving_requests_{name}_total", 0))
            for name in ("completed", "cancelled", "timed_out", "failed")
        }
    last = records[-1] if records else None
    return {
        "meta": {
            "records": len(records),
            "steps": (
                None if not records
                else [records[0].get("step"), records[-1].get("step")]
            ),
            "engines": sorted(
                {str(r.get("engine", "?")) for r in records}
            ),
        },
        "phases": {
            k: _percentiles(v) for k, v in sorted(phase_vals.items())
        },
        "occupancy": {
            "slot_steps_busy": occ_busy,
            "slot_steps_total": occ_total,
            "fraction": (
                round(occ_busy / occ_total, 4) if occ_total else None
            ),
            "queue_depth_max": max(queue_depths, default=0),
        },
        "rows": {
            "real": rows_real,
            "padded": rows_padded,
            "padding_waste": (
                round(rows_padded / (rows_real + rows_padded), 4)
                if rows_real + rows_padded else None
            ),
        },
        "events": dict(sorted(kinds.items())),
        "accounting": accounting,
        "pool": (last or {}).get("pool"),
        "tenants": (last or {}).get("tenants"),
        "requests": _timeline_requests(records, events),
    }


def timeline_gantt(records: List[dict], *, width: int = 96) -> List[str]:
    """Per-slot Gantt over the most recent ``width`` passes: one text row
    per slot, one character per pass (legend: ``_GANTT_LEGEND``; a cell
    takes the highest-priority event that touched it). Bucket-engine rings
    (no occupancy vector) collapse to a single ``batch`` row."""
    slotted = [r for r in records if isinstance(r.get("slots"), list)]
    recs = (slotted or records)[-width:]
    if not recs:
        return ["(no records)"]
    nslots = (
        max(len(r["slots"]) for r in slotted[-width:]) if slotted else 1
    )
    prio = {ch: i for i, ch in enumerate(reversed(_GANTT_PRIORITY))}
    grid = [["."] * len(recs) for _ in range(nslots)]

    def mark(slot, col, ch):
        if slot is None or not 0 <= slot < nslots:
            return
        if prio[ch] > prio[grid[slot][col]]:
            grid[slot][col] = ch

    prev_slots: List = []
    for col, rec in enumerate(recs):
        slots = rec.get("slots") if isinstance(rec.get("slots"), list) else []
        # request -> slot map for slot-less `finished` entries: this pass's
        # slot-carrying events first, then residency (a retiring request
        # left the occupancy vector before the record was cut)
        rid2slot: Dict[int, int] = {}
        for kind in ("tokens", "chunks", "admitted", "preempted"):
            for e in rec.get(kind) or []:
                if e.get("request_id") is not None and e.get("slot") is not None:
                    rid2slot.setdefault(int(e["request_id"]), int(e["slot"]))
        for occ in (slots, prev_slots):
            for i, rid in enumerate(occ):
                if rid is not None:
                    rid2slot.setdefault(int(rid), i)
        for i, rid in enumerate(slots):
            if rid is not None:
                mark(i, col, "=")
        if not slots:  # bucket engine: everything lands on the one row
            if rec.get("tokens"):
                mark(0, col, "#")
            if rec.get("admitted"):
                mark(0, col, "a")
            if rec.get("finished"):
                mark(0, col, "r")
        for e in rec.get("tokens") or []:
            mark(e.get("slot"), col, "#")
        for e in rec.get("chunks") or []:
            mark(e.get("slot"), col, "p")
        for e in rec.get("admitted") or []:
            mark(e.get("slot"), col, "a")
        for e in rec.get("finished") or []:
            rid = e.get("request_id")
            if rid is not None:
                mark(rid2slot.get(int(rid)), col, "r")
        for e in rec.get("preempted") or []:
            mark(e.get("slot"), col, "X")
        for e in rec.get("swapped") or []:
            mark(e.get("slot"), col, "S")
        for e in rec.get("restored") or []:
            mark(e.get("slot"), col, "R")
        prev_slots = slots
    first_step = recs[0].get("step")
    last_step = recs[-1].get("step")
    out = [f"steps {first_step}..{last_step} (one column per pass)"]
    label = "batch" if not slotted else "slot"
    for i, row in enumerate(grid):
        name = label if not slotted else f"{label} {i}"
        out.append(f"  {name:<8}|{''.join(row)}|")
    out.append(f"  {_GANTT_LEGEND}")
    return out


def chrome_trace(records: List[dict],
                 events: Optional[List[dict]] = None) -> dict:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto load
    format) from the ring + span events: pid 1 holds the scheduler lane
    (one complete ``X`` event per pass, phases/pool in ``args``) and one
    lane per slot (contiguous residency runs as ``X``, lifecycle moments as
    ``i`` instants); pid 2 holds the request spans from events.jsonl, one
    lane per trace. Timestamps are microseconds on the engine clock, per
    the trace-event schema."""
    trace_events: List[dict] = []

    def us(t: float) -> float:
        return round(float(t) * 1e6, 3)

    trace_events.append({
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": "scheduler timeline"},
    })
    trace_events.append({
        "ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
        "args": {"name": "scheduler"},
    })
    nslots = max(
        (len(r["slots"]) for r in records
         if isinstance(r.get("slots"), list)),
        default=0,
    )
    for s in range(nslots):
        trace_events.append({
            "ph": "M", "pid": 1, "tid": s + 1, "name": "thread_name",
            "args": {"name": f"slot {s}"},
        })
    # residency runs: (slot, request_id, start_s) while the occupant holds
    runs: Dict[int, Tuple[int, float]] = {}
    for rec in records:
        t0, t1 = rec.get("t_start_s"), rec.get("t_end_s")
        if not isinstance(t0, (int, float)) or not isinstance(t1, (int, float)):
            continue
        args = {
            "step": rec.get("step"),
            "queue_depth": rec.get("queue_depth"),
            "phases_ms": rec.get("phases_ms"),
        }
        for key in ("pool", "rows", "tenants"):
            if rec.get(key) is not None:
                args[key] = rec[key]
        trace_events.append({
            "ph": "X", "pid": 1, "tid": 0, "cat": "scheduler",
            "name": f"step {rec.get('step')}",
            "ts": us(t0), "dur": max(us(t1) - us(t0), 0.0), "args": args,
        })
        for kind, label in (("admitted", "admit"), ("preempted", "preempt"),
                            ("swapped", "swap"), ("restored", "restore"),
                            ("readmitted", "readmit"), ("finished", "finish")):
            for e in rec.get(kind) or []:
                slot = e.get("slot")
                trace_events.append({
                    "ph": "i", "pid": 1, "s": "t", "cat": "lifecycle",
                    "tid": slot + 1 if isinstance(slot, int) else 0,
                    "ts": us(t1),
                    "name": f"{label} req {e.get('request_id')}",
                    "args": dict(e),
                })
        slots = rec.get("slots")
        if isinstance(slots, list):
            for i, rid in enumerate(slots):
                open_run = runs.get(i)
                if open_run is not None and (rid is None or int(rid) != open_run[0]):
                    trace_events.append({
                        "ph": "X", "pid": 1, "tid": i + 1, "cat": "residency",
                        "name": f"req {open_run[0]}", "ts": us(open_run[1]),
                        "dur": max(us(t0) - us(open_run[1]), 0.0),
                        "args": {"request_id": open_run[0]},
                    })
                    runs.pop(i)
                if rid is not None and i not in runs:
                    runs[i] = (int(rid), float(t0))
    if records and runs:
        t_last = records[-1].get("t_end_s") or 0.0
        for i, (rid, start) in sorted(runs.items()):
            trace_events.append({
                "ph": "X", "pid": 1, "tid": i + 1, "cat": "residency",
                "name": f"req {rid}", "ts": us(start),
                "dur": max(us(t_last) - us(start), 0.0),
                "args": {"request_id": rid},
            })
    if events:
        trace_events.append({
            "ph": "M", "pid": 2, "tid": 0, "name": "process_name",
            "args": {"name": "request spans"},
        })
        lanes: Dict[str, int] = {}
        for row in events:
            dur = row.get("duration_ms")
            t0 = row.get("start_s")
            if not isinstance(dur, (int, float)) or not isinstance(t0, (int, float)):
                continue
            trace_id = str(row.get("trace_id") or "?")
            tid = lanes.get(trace_id)
            if tid is None:
                tid = lanes[trace_id] = len(lanes) + 1
                trace_events.append({
                    "ph": "M", "pid": 2, "tid": tid, "name": "thread_name",
                    "args": {"name": trace_id},
                })
            args = {"trace_id": trace_id, "status": row.get("status")}
            if row.get("attrs"):
                args.update(row["attrs"])
            trace_events.append({
                "ph": "X", "pid": 2, "tid": tid, "cat": "span",
                "name": str(row.get("span", "?")),
                "ts": us(t0), "dur": round(float(dur) * 1e3, 3),
                "args": args,
            })
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": "step-timeline-v1"},
    }


def format_timeline(analysis: dict, records: List[dict], *,
                    top: int = 20, width: int = 96) -> str:
    """Human-readable flight-deck rendering of :func:`analyze_timeline`."""
    out: List[str] = []
    meta = analysis["meta"]
    out.append("== scheduler timeline ==")
    steps = meta["steps"]
    out.append(
        f"records: {meta['records']}"
        + (f"  steps {steps[0]}..{steps[1]}" if steps else "")
        + f"  engines: {', '.join(meta['engines']) or '-'}"
    )
    occ = analysis["occupancy"]
    if occ["slot_steps_total"]:
        out.append(
            f"occupancy: {occ['slot_steps_busy']}/{occ['slot_steps_total']} "
            f"slot-steps busy ({occ['fraction']})  "
            f"queue depth max: {occ['queue_depth_max']}"
        )
    rows = analysis["rows"]
    if rows["real"] or rows["padded"]:
        out.append(
            f"decode rows: real={rows['real']} padded={rows['padded']} "
            f"(waste {rows['padding_waste']})"
        )

    out.append("")
    out.append("== per-pass phases (ms) ==")
    if analysis["phases"]:
        out.append(
            f"{'phase':<12}{'count':>8}{'total_ms':>12}{'p50_ms':>10}"
            f"{'p95_ms':>10}{'max_ms':>10}"
        )
        for name, p in analysis["phases"].items():
            out.append(
                f"{name:<12}{p['count']:>8}{_fmt(p['total_ms'], 12)}"
                f"{_fmt(p['p50_ms'])}{_fmt(p['p95_ms'])}{_fmt(p['max_ms'])}"
            )
    else:
        out.append("(no phase marks in ring)")

    acct = analysis["accounting"]
    out.append("")
    out.append("== accounting ==")
    out.append(
        f"admitted={acct['admitted']}  finished={acct['finished']} "
        + (
            "("
            + ", ".join(
                f"{k}={v}" for k, v in acct["finished_by_status"].items()
            )
            + ")  " if acct["finished_by_status"] else " "
        )
        + f"preempted={acct['preempted']}  readmitted={acct['readmitted']}"
        + (
            f"  swapped={acct['swapped']}  restored={acct['restored']}"
            if acct.get("swapped") or acct.get("restored") else ""
        )
    )
    if acct.get("registry"):
        out.append(
            "registry: "
            + "  ".join(f"{k}={v}" for k, v in acct["registry"].items())
        )
    if analysis.get("pool"):
        pool = analysis["pool"]
        out.append(
            f"pool (last pass): in_use={pool.get('in_use')} "
            f"reserved={pool.get('reserved')} headroom={pool.get('headroom')}"
        )
    if analysis.get("tenants"):
        out.append(
            "tenant pages (last pass): "
            + ", ".join(
                f"{k}={v}" for k, v in analysis["tenants"].items()
            )
        )

    reqs = analysis["requests"]
    out.append("")
    out.append("== per-request decomposition (worst first) ==")
    if reqs:
        out.append(
            f"{'request':>8}{'status':>11}{'tok':>5}{'replay':>7}"
            f"{'ttft_ms':>10}{'decode_ms':>11}{'total_ms':>10}"
            f"{'span_ms':>10}{'unattr_ms':>10}"
        )
        for row in reqs[:top]:
            out.append(
                f"{row['request_id']:>8}{str(row.get('status') or '-'):>11}"
                f"{row['tokens']:>5}{row['replayed_tokens']:>7}"
                f"{_fmt(row.get('ttft_ms'))}{_fmt(row.get('decode_ms'), 11)}"
                f"{_fmt(row.get('total_ms'))}{_fmt(row.get('span_ms'))}"
                f"{_fmt(row.get('unattributed_ms'))}"
            )
        if len(reqs) > top:
            out.append(f"  ... {len(reqs) - top} more")
    else:
        out.append("(no token events in ring)")

    out.append("")
    out.append("== slot gantt ==")
    out.extend(timeline_gantt(records, width=width))
    return "\n".join(out)


def run_timeline(timeline_path: str, events_path: Optional[str] = None,
                 snapshot_path: Optional[str] = None, *,
                 trace_out: Optional[str] = None, top: int = 20,
                 as_json: bool = False) -> str:
    """Load a timeline export (+ optional events/snapshot), analyze, and
    return the rendered flight deck; ``trace_out`` additionally writes the
    Chrome-trace JSON next to it."""
    records = load_timeline(timeline_path)
    events = read_events_jsonl(events_path) if events_path else []
    snapshot = None
    if snapshot_path:
        with open(snapshot_path) as fh:
            snapshot = json.load(fh)
    analysis = analyze_timeline(records, events, snapshot)
    extra = ""
    if trace_out:
        with open(trace_out, "w", encoding="utf-8") as fh:
            json.dump(chrome_trace(records, events), fh, sort_keys=True)
        extra = f"\n\nchrome trace: {trace_out} (load in Perfetto)"
    if as_json:
        return json.dumps(analysis, indent=2, sort_keys=True)
    return format_timeline(analysis, records, top=top) + extra


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="perceiver_io_tpu_torch.observability.report",
        description=(
            "Offline obs report over events.jsonl (+ snapshot), or — with "
            "--incident — over one flight-recorder bundle."
        ),
    )
    parser.add_argument("events", nargs="?", default=None,
                        help="events.jsonl path (--obs.events_path)")
    parser.add_argument("--snapshot", default=None,
                        help="metrics snapshot JSON (--obs.snapshot_path)")
    parser.add_argument("--incident", default=None,
                        help="incident bundle directory (or its "
                             "manifest.json) — renders the incident report "
                             "instead of the events report")
    parser.add_argument("--timeline", default=None,
                        help="StepTimeline JSONL export "
                             "(--obs.timeline.export) — renders the "
                             "scheduler flight deck instead of the events "
                             "report (the events positional becomes the "
                             "optional span join input)")
    parser.add_argument("--trace-out", default=None,
                        help="with --timeline: also write Chrome-trace "
                             "JSON here (load in Perfetto / "
                             "chrome://tracing)")
    parser.add_argument("--top", type=int, default=20,
                        help="rows shown in the compile table (report) / "
                             "decomposition (incident)")
    parser.add_argument("--json", action="store_true",
                        help="emit the raw analysis JSON instead of text")
    args = parser.parse_args(argv)
    try:
        if args.incident is not None:
            print(run_incident(args.incident, top=args.top, as_json=args.json))
        elif args.timeline is not None:
            print(run_timeline(
                args.timeline, args.events, args.snapshot,
                trace_out=args.trace_out, top=args.top, as_json=args.json,
            ))
        elif args.events is None:
            parser.error(
                "an events.jsonl path (or --incident / --timeline) is "
                "required"
            )
        else:
            print(run(args.events, args.snapshot, top=args.top,
                      as_json=args.json))
    # JSONDecodeError IS a ValueError — it must be caught first or the
    # generic clause swallows it without the file-name context
    except json.JSONDecodeError as e:
        raise SystemExit(
            f"obs report: artifact is not valid JSON "
            f"({args.incident or args.timeline or args.snapshot or args.events}: {e})"
        )
    except (OSError, ValueError) as e:
        raise SystemExit(f"obs report: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
