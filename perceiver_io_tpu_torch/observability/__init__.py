"""Unified telemetry of the port: one metrics registry, span tracing,
exporters, SLO burn monitoring, the incident flight recorder, the scheduler
step timeline, the profiler trigger and the build ledger. Counterpart of
``perceiver_io_tpu/observability/``; everything here is host code (no torch
import at module scope but the profiler's, inside the call), copied rather
than imported so that the port imports nothing of the JAX package.

- :class:`MetricsRegistry` — counters, gauges and windowed histograms under
  canonical Prometheus-style names; :func:`default_registry` is the
  process-wide one.
- :class:`Tracer` — one trace per request (serving) or per ``fit``
  (training), streamed to ``events.jsonl`` by :class:`JsonlSpanSink`.
- :func:`to_prometheus_text` / :class:`SnapshotWriter` — the export paths.
- :class:`ProfilerTrigger` — arms a ``torch.profiler`` capture of the next
  step when the step-time p95 regresses (a Chrome trace, where JAX writes
  an XPlane).
- :class:`CompileLedger` / :func:`default_ledger` — the build ledger: one
  ``kernel_build`` record per ``nvcc`` build of a ``csrc/*.cu`` library, the
  ``hbm_bytes_in_use`` and ``kv_cache_resident_bytes`` gauges.
- :class:`SLOMonitor`, :class:`FlightRecorder`, :class:`StepTimeline`,
  :class:`LoadGenerator` — SLO burn rates, incident bundles, the per-pass
  scheduler record, open-loop load.
- :mod:`~perceiver_io_tpu_torch.observability.report` — the offline
  ``obs report|incident|timeline`` analyzers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from perceiver_io_tpu_torch.observability.compat import normalize_row, read_metrics_jsonl
from perceiver_io_tpu_torch.observability.exporters import (
    HELP_TEXT,
    SnapshotWriter,
    help_text,
    snapshot_json,
    to_prometheus_text,
)
from perceiver_io_tpu_torch.observability.flight_recorder import (
    DisconnectWatch,
    FlightRecorder,
    IncidentArgs,
)
from perceiver_io_tpu_torch.observability.ledger import CompileLedger, default_ledger
from perceiver_io_tpu_torch.observability.loadgen import (
    GatewayHttpClient,
    HttpStreamHandle,
    LoadGenerator,
    TTFTProbe,
    WorkloadSpec,
)
from perceiver_io_tpu_torch.observability.registry import (
    Histogram,
    MetricsRegistry,
    default_registry,
)
from perceiver_io_tpu_torch.observability.slo import (
    SLOArgs,
    SLOMonitor,
    SLOPolicy,
    goodput_ratio,
    offered_load,
)
from perceiver_io_tpu_torch.observability.timeline import (
    StepTimeline,
    TimelineArgs,
    read_timeline_jsonl,
    tenant_label,
    tier_label,
)
from perceiver_io_tpu_torch.observability.tracing import (
    JsonlSpanSink,
    SamplingSpanSink,
    Span,
    Tracer,
    read_events_jsonl,
)
from perceiver_io_tpu_torch.observability.trigger import ProfilerTrigger


@dataclasses.dataclass
class ObservabilityArgs:
    """The CLI's ``--obs.*`` flag group, shared by ``fit`` and ``serve``.

    All fields default to off: telemetry costs nothing unless asked for,
    matching the ``chaos=None`` / ``tracer=None`` convention.
    """

    #: span events JSONL path (rank-0). For ``fit``, relative paths land
    #: under ``--trainer.default_root_dir``.
    events_path: Optional[str] = None
    #: write a registry snapshot JSON at most every N seconds (the trainer
    #: checks at each log flush; the serve CLI per drain pass)
    snapshot_every_s: Optional[float] = None
    #: snapshot destination; defaults next to the events/metrics files
    snapshot_path: Optional[str] = None
    #: arm a torch.profiler capture of the next step when the step-time p95
    #: exceeds this factor × the warmed-up baseline p95 (None disables).
    #: ``fit`` watches trainer step times; ``serve`` watches the decode
    #: path (slot-engine ``serving_decode_step_ms`` / bucket-engine
    #: ``serving_device_execute_ms``) and captures the next dispatch
    profile_on_regress_factor: Optional[float] = None
    #: head-sample the events.jsonl span stream: fraction of clean request
    #: traces kept, in (0, 1] (docs/observability.md "Trace sampling").
    #: Deterministic (counter-based, no RNG); traces ending in a non-ok
    #: terminal status are ALWAYS kept, as are terminals slower than
    #: ``trace_keep_slow_ms``. Requires ``events_path``. None = keep all.
    trace_sample: Optional[float] = None
    #: tail-keep latency threshold: a sampled-out trace whose terminal
    #: span is at least this slow is retained anyway (None disables)
    trace_keep_slow_ms: Optional[float] = None
    #: on-disk bound for events.jsonl: past it the file rotates once to
    #: ``events.jsonl.1`` (read back transparently); requires
    #: ``events_path``. None = unbounded append (the historical behavior)
    events_max_bytes: Optional[int] = None
    #: the ``--obs.slo.*`` sub-group: SLO targets (p95 TTFT / p95 ITL /
    #: error rate) plus burn-window knobs. Setting any target builds an
    #: :class:`SLOMonitor` for the serve run (docs/observability.md) —
    #: burn-rate gauges, breach counters/events, profiler-trigger arming,
    #: and (with ``--serve.replicas > 1``) tightened fleet admission.
    slo: SLOArgs = dataclasses.field(default_factory=SLOArgs)
    #: the ``--obs.incident.*`` sub-group: the incident flight recorder
    #: (docs/observability.md "Flight recorder & incident bundles").
    #: Setting ``incident.dir`` arms triggered incident bundles at the
    #: serving seams (SLO breach, replica failure, pool exhaustion,
    #: autoscaler escalation, gateway mass-disconnect), each a bounded
    #: atomic spans+state capture the ``obs incident`` analyzer reads.
    incident: IncidentArgs = dataclasses.field(default_factory=IncidentArgs)
    #: the ``--obs.timeline.*`` sub-group: the scheduler step timeline
    #: (docs/observability.md "Scheduler timeline & post-mortems").
    #: Setting ``timeline.steps`` attaches a bounded :class:`StepTimeline`
    #: ring to every serve-run engine — one structured record per
    #: scheduler pass (admissions, chunk progress, retirements,
    #: preemptions, occupancy, per-phase wall ms) the ``obs timeline``
    #: analyzer renders as a Gantt view / Chrome-trace JSON.
    timeline: TimelineArgs = dataclasses.field(default_factory=TimelineArgs)


__all__ = [
    "CompileLedger",
    "DisconnectWatch",
    "FlightRecorder",
    "GatewayHttpClient",
    "HELP_TEXT",
    "Histogram",
    "HttpStreamHandle",
    "IncidentArgs",
    "JsonlSpanSink",
    "LoadGenerator",
    "TTFTProbe",
    "MetricsRegistry",
    "ObservabilityArgs",
    "ProfilerTrigger",
    "SLOArgs",
    "SLOMonitor",
    "SLOPolicy",
    "SamplingSpanSink",
    "SnapshotWriter",
    "Span",
    "StepTimeline",
    "TimelineArgs",
    "Tracer",
    "WorkloadSpec",
    "default_ledger",
    "default_registry",
    "goodput_ratio",
    "help_text",
    "normalize_row",
    "offered_load",
    "read_events_jsonl",
    "read_metrics_jsonl",
    "read_timeline_jsonl",
    "snapshot_json",
    "tenant_label",
    "tier_label",
    "to_prometheus_text",
]
