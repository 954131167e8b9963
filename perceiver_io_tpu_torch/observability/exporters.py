"""Exporters: Prometheus text format and JSON snapshots of a
:class:`~perceiver_io_tpu_torch.observability.MetricsRegistry`.

Two formats, one source:

- :func:`to_prometheus_text` — the ``text/plain; version=0.0.4`` exposition
  format a scrape endpoint (or a human with ``curl``) reads. Histograms
  render as Prometheus *summaries* (quantile series + ``_sum``/``_count``):
  we keep raw reservoirs, not fixed buckets, so quantiles are the honest
  export.
- :func:`snapshot_json` / :class:`SnapshotWriter` — the machine-readable
  snapshot the serve CLI appends to ``serve_stats``, the trainer drops next
  to ``metrics.jsonl``, and ``bench.py`` embeds in its record so every
  BENCH_* file carries telemetry.

``SnapshotWriter`` is cadence-gated on an injectable clock
(``--obs.snapshot_every_s``): callers invoke :meth:`SnapshotWriter.maybe_write`
opportunistically from their own loop (the trainer at each log flush, the
serve CLI per drain pass) and the writer decides whether enough time has
passed — no background thread to leak.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from perceiver_io_tpu_torch.observability.registry import MetricsRegistry

_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))

#: one-line human descriptions for the canonical metric families
#: (docs/observability.md) — rendered as ``# HELP`` lines in the
#: exposition so a scrape endpoint is self-describing
HELP_TEXT = {
    "serving_requests_submitted_total": "Requests accepted into the serving queue.",
    "serving_requests_completed_total": "Requests that finished with a generated result.",
    "serving_requests_shed_total": "Submissions rejected by bounded-queue backpressure.",
    "serving_requests_timed_out_total": "Requests whose deadline expired before completion.",
    "serving_requests_failed_total": "Requests failed by an executor or injected fault.",
    "serving_requests_rejected_total": "Submissions rejected as infeasible (empty / over the largest bucket).",
    "serving_requests_cancelled_total": "Requests withdrawn mid-flight via cancel() (gateway client disconnects).",
    "serving_token_sink_errors_total": "Per-request on_token sinks that raised and were isolated.",
    "serving_batches_total": "Micro-batches executed by the bucket engine.",
    "serving_tokens_generated_total": "Real (non-filler) tokens generated across requests.",
    "serving_prompt_tokens_real_total": "Prompt tokens submitted by callers.",
    "serving_prompt_tokens_padded_total": "Prompt tokens after bucket padding (real + pad).",
    "serving_decode_rows_total": "Decode-step rows executed (real + filler).",
    "serving_decode_rows_padded_total": "Decode-step rows that were padding filler.",
    "serving_decode_steps_total": "Fixed-shape slot decode steps executed.",
    # the port's own family: the slot engine's boundary-variant decode steps
    "serving_decode_boundary_steps_total": "Slot decode steps that ran the boundary-phase variant (decode_strategy cached or recompute).",
    "serving_prefills_total": "Slot admissions prefilled (single-call or chunked).",
    "serving_prefill_chunks_total": "Chunked-prefill staging calls executed.",
    "serving_queue_wait_ms": "Queue wait per request: submit to batch/prefill start.",
    "serving_batch_assembly_ms": "Host-side micro-batch packing time.",
    "serving_device_execute_ms": "Device execute time per micro-batch (dispatch + fence).",
    "serving_request_latency_ms": "End-to-end request latency: submit to terminal state.",
    "serving_decode_step_ms": "One fixed-shape slot decode step (dispatch + fence).",
    "serving_prefill_ms": "Per-admission prefill time (summed chunks when chunked).",
    "serving_prefill_chunk_ms": "Per-call chunked-prefill stall (staging or finalize).",
    "serving_prefill_chunks": "Staging chunks per chunked admission.",
    "serving_slots_active": "Slots holding a resident request right now.",
    "serving_slots_idle": "Slots free for admission right now.",
    "serving_ttft_ms": "Time to first token per request: submit (fleet front door when fleeted) to first generated token.",
    "serving_inter_token_ms": "Inter-token latency: gap between a resident request's consecutive tokens (batch-amortized on the bucket engine).",
    "slo_breach_total": "SLO burn-rate breaches entered (any dimension; see slo_breach_<dim>_total).",
    "slo_recoveries_total": "SLO breach recoveries (fast-window burn back under threshold).",
    "slo_burn_rate": "Worst sustained SLO burn rate across dimensions (min of fast/slow windows).",
    "serving_throughput_tokens_per_sec": "Serving throughput gauge (bench probe).",
    "serving_goodput_ratio": "Completed / offered requests (bench probe).",
    "serving_mfu": "Serving model-FLOPs utilization gauge (bench probe).",
    "executor_cache_hits_total": "Executor-cache hits (no trace, no compile).",
    "executor_cache_misses_total": "Executor-cache misses (a fresh trace + compile).",
    "executor_cache_evictions_total": "Executors dropped by the FIFO cache bound.",
    "compile_total": "Builds recorded by the compile ledger (nvcc kernel builds).",
    "compile_ms": "Per-build wall time: one nvcc build of a kernel library (site kernel_build).",
    "retrace_total": "Rebuilds of a logically-same executor (see retrace_reason_*).",
    "compile_ledger_fallback_total": "Always 0 here: nothing is lowered ahead of time, so nothing falls back.",
    "hbm_bytes_in_use": "Live card memory from torch.cuda.memory_allocated() (absent without a card).",
    "kv_cache_resident_bytes": "Live slot-KV bytes: allocated pages + latent-stack caches under the paged layout; equals capacity when dense.",
    "kv_cache_capacity_bytes": "Worst-case slot-KV bytes from the resolved layout's dtype: pool blocks (+ int8 dequant scales) when paged, dense per-slot caches at full context otherwise, + latent-stack caches.",
    "kv_cache_resident_bytes_per_shard": "Model-axis shard of the live KV bytes on a sharded serving mesh (docs/serving.md \"Sharded serving\").",
    "serving_mesh_devices": "Devices claimed by the engine's serving mesh (data x model); absent when serving unsharded.",
    "serving_mesh_data": "Serving-mesh data-axis size (slot/batch parallelism).",
    "serving_mesh_model": "Serving-mesh model-axis size (attention-head / KV tensor parallelism).",
    "kv_pool_blocks": "Usable KV pool capacity in blocks (null block excluded).",
    "kv_pool_blocks_in_use": "Pool blocks currently mapped to live token positions.",
    "kv_pool_blocks_reserved": "Pool blocks reserved by resident requests' worst cases (mapped or not).",
    "kv_pool_blocks_high_water": "Peak pool blocks in use over the engine lifetime.",
    "kv_pool_block_bytes": "Bytes per pool block (block_size positions x per-position k+v at the resolved layout's dtype; scale bytes excluded).",
    "kv_pool_block_scale_bytes": "Per-block dequant-scale bytes under kv_layout='paged_int8' (f32 per position/head/tensor); 0 for exact layouts.",
    "kv_quant_fallback_total": "Autotune runs whose int8 quality gate failed, degrading the verdict to an exact layout (docs/serving.md \"Quantized KV\").",
    "kv_ragged_kernel_steps_total": "Plain paged decode steps whose attends ran the ragged paged-attention kernel (K4) on the card instead of the gather reference.",
    "kv_ragged_kernel_enabled": "1 when a paged engine dispatches the ragged paged-attention kernel, 0 when on the gather reference.",
    "kv_pool_block_allocs_total": "Pool block map operations (admit, chunk progress, decode page crossings).",
    "kv_pool_block_frees_total": "Pool blocks returned on retire/failure.",
    "kv_pool_admit_waits_total": "Requests that waited at the queue head for pool blocks to free.",
    "kv_prefix_hits_total": "Paged admissions that mapped at least one cached prefix block by reference.",
    "kv_prefix_misses_total": "Paged admissions with no usable cached prefix (prefix cache on).",
    "kv_prefix_shared_blocks_total": "Pool blocks mapped by reference (full + COW'd partial) across hit admissions.",
    "kv_prefix_shared_tokens_total": "Prompt token positions whose projection was skipped via prefix sharing.",
    "kv_prefix_cow_copies_total": "Copy-on-write page copies (partial/divergent block at admit, or the decode write guard).",
    "kv_prefix_evicted_blocks_total": "Cached prefix blocks LRU-dropped from the index under pool pressure.",
    "kv_prefix_published_blocks_total": "Full prefix blocks published into the prefix index after admission.",
    "kv_prefix_cached_blocks": "Pool blocks currently retained by the prefix index.",
    "kv_preemptions_total": "Residents preempted under pool pressure: pages returned, request requeued for recompute-from-prompt replay (docs/serving.md \"Preemption & priorities\").",
    "kv_readmissions_total": "Previously preempted requests readmitted to a slot (each eventually completing token-identically).",
    "kv_swaps_total": "Preemption victims whose KV pages were gathered to host memory instead of discarded (docs/serving.md \"Host-swap preemption\").",
    "kv_swap_restores_total": "Swapped victims restored into free pool blocks at readmission, resuming decode at their pre-preemption position (no prompt replay).",
    "kv_swap_bytes_total": "Bytes moved over the host link by swap extracts + restores (KV pages, int8 scales, and the resumable decode row).",
    "kv_swap_ms": "Fenced wall time of one swap transfer leg (device-to-host extract or host-to-device restore).",
    "kv_pool_headroom_blocks": "Free pool blocks beyond the sum of live reservations — the lazy-admission safety margin; 0 means the next boundary crossing may preempt.",
    "spec_rounds_total": "Speculative draft+verify rounds executed (one fixed-shape round per scheduler pass with speculation on; docs/serving.md \"Speculative decoding\").",
    "spec_tokens_proposed_total": "Draft tokens proposed by the truncated-stack self-draft head (k per active row per round).",
    "spec_tokens_accepted_total": "Draft tokens accepted by the batched verify pass (longest matching prefix; acceptance = accepted / proposed).",
    "spec_tokens_emitted_total": "Tokens emitted by speculative rounds (accepted drafts + the verify pass's own token per row).",
    "executor_resident_bytes": "Sum of recorded builds' temp+output bytes (0: kernel builds report no memory analysis).",
    "trainer_steps_total": "Executed optimizer steps (skipped steps included).",
    "trainer_skipped_steps_total": "Steps discarded by the non-finite skip policy.",
    "trainer_rollbacks_total": "Divergence rollbacks to a saved training state.",
    "trainer_callback_errors_total": "Callbacks that raised and were isolated.",
    "trainer_step_dispatch_ms": "Host dispatch time per step (unfenced; device async).",
    "trainer_step_ms": "Fenced true step time (profiler-trigger runs only).",
    "trainer_steps_per_sec": "Recent steady-state training step rate.",
    "trainer_loss": "Most recently logged training loss.",
    "fleet_requests_submitted_total": "Requests accepted fleet-wide.",
    "fleet_requests_completed_total": "Fleet requests completed exactly once.",
    "fleet_requests_shed_total": "Submissions shed by fleet-level max_pending backpressure.",
    "fleet_requests_timed_out_total": "Fleet requests whose deadline expired before completion.",
    "fleet_requests_failed_total": "Fleet requests failed terminally (failover budget spent or failover off).",
    "fleet_requests_rejected_total": "Submissions rejected as infeasible at the fleet front door.",
    "fleet_requests_cancelled_total": "Fleet requests withdrawn mid-flight via cancel() (gateway client disconnects).",
    "fleet_dispatch_total": "Successful request placements onto a replica.",
    "fleet_failover_total": "Replica-failure events that re-dispatched in-flight work.",
    "fleet_redispatch_total": "Requests re-queued for replay on another replica.",
    "fleet_breaker_open_total": "Circuit-breaker open transitions across replicas.",
    "fleet_replica_failures_total": "Replica failures observed (crash, hang, dispatch fault).",
    "fleet_replica_restarts_total": "Replica rebuilds (crash recovery or rolling restart).",
    "fleet_duplicate_results_total": "Late duplicate completions absorbed by exactly-once dedupe.",
    "fleet_slo_shed_total": "Sheds caused by SLO-tightened admission (also counted in fleet_requests_shed_total).",
    "fleet_replicas": "Replicas owned by the fleet router.",
    "fleet_replicas_healthy": "Replicas with a closed circuit breaker right now.",
    "fleet_replicas_draining": "Replicas currently draining (rolling restart or scale-down in progress).",
    "fleet_request_latency_ms": "Fleet request latency: submit to terminal state (failovers included).",
    "fleet_scale_up_total": "Replicas added to the fleet (autoscaler- or operator-driven).",
    "fleet_scale_down_total": "Replicas retired from the fleet with exactly-once failover of their in-flight work.",
    "fleet_scale_up_failed_total": "Replica spawn attempts that failed (factory raise / fleet.scale_up chaos fault).",
    "autoscaler_evaluations_total": "Autoscaler control-loop polls (one per fleet scheduling pass).",
    "autoscaler_holds_total": "Scale actions suppressed by cooldown or victim ineligibility (hysteresis at work).",
    "autoscaler_ladder_rung": "Current degradation-ladder rung index (0 steady, 1 tighten, 2 scale-up, 3 shed, 4 recover).",
    "autoscaler_breach_streak": "Consecutive polls of fresh scale-up evidence (breach / queue pressure / unhealthy capacity).",
    "autoscaler_healthy_streak": "Consecutive polls of fresh scale-down evidence (no breach, queue under the low watermark).",
    "gateway_connections_total": "TCP connections accepted by the HTTP streaming gateway.",
    "gateway_connections_active": "Gateway connections open right now.",
    "gateway_streams_total": "Generate streams accepted (submission admitted, response streaming).",
    "gateway_streams_active": "Generate streams currently in flight.",
    "gateway_streams_completed_total": "Streams whose request reached a server-side terminal state.",
    "gateway_streams_cancelled_total": "Streams abandoned by the client mid-generation (request cancelled, slot + pool pages freed).",
    "gateway_streams_rejected_total": "Generate submissions answered 400/503 (infeasible or shed) without becoming streams.",
    "gateway_bytes_sent_total": "Bytes written to gateway sockets (token events, terminals, error/metrics responses).",
    "gateway_socket_ttft_ms": "Socket-anchored time to first token: connection accept to the first token byte written.",
    "tracing_spans_total": "Spans offered to the sampling span sink (in-scope and pass-through alike).",
    "tracing_spans_kept_total": "Spans written through to the events sink (head-kept, tail-kept, or pass-through).",
    "tracing_spans_sampled_out_total": "Spans dropped by trace sampling (kept + sampled_out == total).",
    "tracing_traces_kept_total": "Request traces retained: head-sampled, non-ok terminal, or over the slow threshold.",
    "tracing_traces_sampled_out_total": "Clean request traces dropped by head sampling (still in the in-memory ring).",
    "incident_triggers_total": "Flight-recorder trigger firings from the wired seams (suppressed or not).",
    "incident_bundles_total": "Incident bundles written to disk by the flight recorder.",
    "incident_suppressed_total": "Triggers suppressed by per-kind cooldown or the max-bundles budget.",
    "incident_dump_errors_total": "Incident bundle dumps that failed (capture must never compound the incident).",
    "timeline_steps_total": "Scheduler passes recorded into the step timeline ring (docs/observability.md \"Scheduler timeline & post-mortems\").",
    "timeline_records_dropped_total": "Step-timeline records evicted past the ring capacity (--obs.timeline.steps).",
    "timeline_ring_records": "Step-timeline records currently retained in the ring.",
    # the always-published members of the per-tier / per-tenant attribution
    # families get direct entries (the *_has_direct_help satellite bar);
    # other labels resolve through _HELP_PREFIXES below
    "serving_tokens_tier_0_total": "Real tokens generated for requests at the default priority tier 0 (per-tier cost attribution).",
    "kv_pool_tenant_blocks_in_use_default": "Pool blocks currently mapped for untagged (no-tenant) resident requests (per-tenant cost attribution).",
}

#: prefix-matched fallbacks for generated families (per-reason counters,
#: StepTimer gauges) — first hit wins
_HELP_PREFIXES = (
    ("retrace_reason_", "Retraces attributed to this changed cache-key component."),
    ("slo_burn_rate_", "Per-dimension SLO burn rate over one window (bad fraction / error budget)."),
    ("slo_breach_", "SLO breaches entered on this dimension."),
    ("kv_preemptions_tier_", "Preemptions whose victim held this priority tier (neg<k> spells a negative tier)."),
    ("kv_pool_tenant_blocks_in_use_", "Pool blocks currently mapped for this tenant's resident requests (per-tenant cost attribution)."),
    ("serving_tokens_tier_", "Real tokens generated for requests at this priority tier (per-tier cost attribution)."),
)


def help_text(name: str) -> Optional[str]:
    """Human description for a canonical family, or None for ad-hoc names."""
    known = HELP_TEXT.get(name)
    if known is not None:
        return known
    for prefix, text in _HELP_PREFIXES:
        if name.startswith(prefix):
            return text
    return None


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if out and not out[0].isdigit() else f"_{out}"


def _num(value: float) -> str:
    """Full-precision numeric rendering: '%g' would quantize counters past
    1e6 (12,345,678 -> 1.23457e+07), corrupting scraped rate()/delta math.
    Integral values render bare; others use the shortest round-trip repr."""
    value = float(value)
    if value.is_integer():
        return str(int(value))
    return repr(value)


def to_prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus exposition format (counters,
    gauges, histogram summaries), sorted by name for stable diffs. Every
    canonical family gets a ``# HELP`` line (:data:`HELP_TEXT`); ad-hoc
    names render with ``# TYPE`` only."""
    snap = registry.snapshot()
    lines = []

    def _header(name: str, metric: str, kind: str) -> None:
        desc = help_text(name)
        if desc is not None:
            lines.append(f"# HELP {metric} {desc}")
        lines.append(f"# TYPE {metric} {kind}")

    for name, value in sorted(snap["counters"].items()):
        metric = _sanitize(name)
        _header(name, metric, "counter")
        lines.append(f"{metric} {_num(value)}")
    for name, value in sorted(snap["gauges"].items()):
        metric = _sanitize(name)
        _header(name, metric, "gauge")
        lines.append(f"{metric} {_num(value)}")
    for name, summ in sorted(snap["histograms"].items()):
        metric = _sanitize(name)
        _header(name, metric, "summary")
        for q, key in _QUANTILES:
            if summ[key] is not None:
                lines.append(f'{metric}{{quantile="{q}"}} {_num(summ[key])}')
        lines.append(f"{metric}_sum {_num(summ['sum'])}")
        lines.append(f"{metric}_count {_num(summ['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_json(registry: MetricsRegistry, *, indent: Optional[int] = None,
                  extra: Optional[dict] = None) -> str:
    """Registry snapshot as JSON; ``extra`` keys are merged at the top level
    (the serve CLI embeds the compile ledger's table this way, so an offline
    ``obs report`` over the snapshot sees the per-executor costs)."""
    snap = registry.snapshot()
    if extra:
        snap.update(extra)
    return json.dumps(snap, indent=indent, sort_keys=True)


class SnapshotWriter:
    """Periodically dump a registry snapshot to one JSON file, atomically
    (tmp + rename: a reader never sees a torn file).

    :param every_s: minimum seconds between writes; None = only explicit
        ``maybe_write(force=True)`` calls write.
    :param clock: injectable time source (FakeClock in tests).
    :param extra: optional zero-arg callable whose dict result is merged
        into every written snapshot (e.g. ``lambda: {"compile_ledger":
        default_ledger().snapshot()}``); a raising ``extra`` is dropped for
        that write, never fatal.
    """

    def __init__(self, registry: MetricsRegistry, path: str,
                 *, every_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 extra: Optional[Callable[[], dict]] = None):
        self.registry = registry
        self.path = path
        self.every_s = every_s
        self._clock = clock
        self._extra = extra
        self._last_write: Optional[float] = None
        self.writes = 0
        self.write_errors = 0

    def maybe_write(self, *, force: bool = False) -> bool:
        """Write if forced, or if ``every_s`` has elapsed since the last
        write (the first cadenced call always writes). Returns whether a
        write happened.

        A failing write (disk full, path removed mid-run) is counted in
        :attr:`write_errors` and returns False instead of raising —
        telemetry must never kill the run it observes. Path/permission
        misconfigurations still surface early: the CLI resolves and creates
        the parent directory at construction time."""
        now = self._clock()
        due = (
            self.every_s is not None
            and (self._last_write is None or now - self._last_write >= self.every_s)
        )
        if not (force or due):
            return False
        extra = None
        if self._extra is not None:
            try:
                extra = self._extra()
            except Exception:
                extra = None  # telemetry enrichment must not block the write
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(snapshot_json(self.registry, indent=2, extra=extra))
            os.replace(tmp, self.path)
        except OSError:
            self.write_errors += 1
            return False
        self._last_write = now
        self.writes += 1
        return True
