"""Incident flight recorder: always-on cheap state capture, total recall
at incident time (docs/observability.md "Flight recorder & incident
bundles").

Steady-state telemetry is (deliberately) sampled and bounded — the trace
sampler keeps a fraction of clean traces, the registry keeps sliding
windows — which is exactly wrong at the moment something breaks: an SLO
breach, a replica crash, a pool exhaustion, or an autoscaler ladder walk
deserves *everything recent*, captured automatically, bounded on disk.
Production TPU serving stacks run this shape (PAPERS.md: the Gemma-on-TPU
serving comparison is the deployment reference): a ring buffer nobody
reads until the moment nobody can afford not to.

:class:`FlightRecorder` is that black box:

- **always-on ring** — the tracer's in-memory ``finished`` span deque
  (which retains sampled-out traces too), a bounded ring of periodic
  registry snapshots (:meth:`maybe_record`, cadence-gated like
  ``SnapshotWriter``), and the compile ledger's recent records, all read
  lazily at dump time — steady-state cost is one deque append the tracer
  already pays.
- **triggered bundles** — :meth:`trigger` fires from the wired seams
  (:data:`TRIGGER_KINDS`), respects a per-kind cooldown and a global
  ``max_bundles`` budget (the ProfilerTrigger discipline: a sustained
  incident must not bury the disk), and writes one ATOMIC bundle
  directory: ``spans.jsonl`` (the ring slice) + ``manifest.json``
  (trigger metadata with trace ids, before/after registry snapshots, the
  snapshot ring, recent ledger records, and every registered source's
  state — engine/fleet ``health()`` incl. ``replica_detail``, KV-pool
  stats incl. ``frees_by_cause``, autoscaler rung/streak state, SLO burn
  state). Bundles build under a dot-prefixed temp dir and rename into
  place, so a reader never sees a torn bundle.
- **observability of the observer** — ``incident_triggers_total`` /
  ``incident_bundles_total`` / ``incident_suppressed_total`` /
  ``incident_dump_errors_total`` counters, plus one ``incident.dump``
  span event per bundle (the events.jsonl join key for the analyzer).

Like every telemetry component here: injectable clock (FakeClock drills
replay bit-identically), ``trigger()`` NEVER raises (an incident capture
failing must not compound the incident), and components hold a
``flight_recorder=None`` attr and skip the seam when unset.

The offline side is ``obs incident``
(:mod:`~perceiver_io_tpu_torch.observability.report`): causal timeline plus the
per-request TTFT critical-path decomposition over a bundle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from perceiver_io_tpu_torch.observability.tracing import _json_default

#: the wired trigger seams → who fires them (docs/observability.md):
#:
#: ==========================  ================================================
#: kind                        seam
#: ==========================  ================================================
#: ``slo_breach``              :class:`~perceiver_io_tpu_torch.observability.slo.SLOMonitor`
#:                             breach transition (per dimension)
#: ``replica_failure``         ``FleetRouter._on_replica_failure`` (crash/hang)
#: ``breaker_open``            a replica circuit breaker opening
#: ``pool_exhausted``          slot-engine admission stalled on KV pool blocks
#:                             (the ``kv_pool_admit_waits_total`` instant)
#: ``autoscaler_escalation``   degradation-ladder rung walked UP to
#:                             scale_up/shed
#: ``spawn_failed``            autoscaler replica spawn failure
#: ``mass_disconnect``         gateway: ``threshold`` client disconnects
#:                             inside ``window_s`` (:class:`DisconnectWatch`)
#: ``manual``                  operator / test-driven :meth:`FlightRecorder.trigger`
#: ==========================  ================================================
TRIGGER_KINDS = (
    "slo_breach",
    "replica_failure",
    "breaker_open",
    "pool_exhausted",
    "autoscaler_escalation",
    "spawn_failed",
    "mass_disconnect",
    "manual",
)

INCIDENT_COUNTERS = (
    "incident_triggers_total",
    "incident_bundles_total",
    "incident_suppressed_total",
    "incident_dump_errors_total",
)

#: manifest schema tag — the analyzer refuses bundles it cannot read
BUNDLE_SCHEMA = "incident-bundle-v1"


@dataclasses.dataclass
class IncidentArgs:
    """The CLI's ``--obs.incident.*`` flag sub-group
    (docs/observability.md). Setting ``dir`` enables the recorder; the
    rest tune its budget — off by default like the whole ``--obs.*``
    group."""

    #: bundle destination directory; setting it enables the flight
    #: recorder (relative paths resolve like the other --obs paths)
    dir: Optional[str] = None
    #: per-trigger-kind cooldown, seconds on the run's clock
    cooldown_s: float = 60.0
    #: hard cap on bundles per process lifetime
    max_bundles: int = 8
    #: finished spans included per bundle (the ring slice)
    keep_spans: int = 512

    @property
    def enabled(self) -> bool:
        return self.dir is not None


class DisconnectWatch:
    """Sliding-window mass-disconnect detector for the gateway seam: one
    :meth:`note` per client-disconnect cancellation; returns True (and
    resets) when ``threshold`` disconnects landed inside ``window_s`` —
    one abandoned stream is churn, a burst is an incident. Deterministic
    on the injectable clock."""

    def __init__(self, *, threshold: int = 3, window_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self._clock = clock
        self._times: deque = deque()

    def note(self) -> bool:
        now = self._clock()
        self._times.append(now)
        while self._times and self._times[0] < now - self.window_s:
            self._times.popleft()
        if len(self._times) >= self.threshold:
            self._times.clear()
            return True
        return False


class FlightRecorder:
    """The serving fleet's black box (module docstring).

    :param dir: bundle destination; created if missing.
    :param tracer: the run's :class:`~perceiver_io_tpu_torch.observability.Tracer`
        — its ``finished`` ring is the span source, and bundles emit one
        ``incident.dump`` event onto it. Settable after construction (the
        CLI builds the recorder before the tracer is final).
    :param registry: where the ``incident_*`` counters live and whose
        snapshots the ring records (None skips both).
    :param clock: injectable time source (FakeClock in drills).
    :param cooldown_s: minimum seconds between bundles of the SAME kind —
        a breach polling every step must not write a bundle per poll.
    :param max_bundles: lifetime bundle budget; past it every trigger is
        suppressed (counted) — bounded disk is the whole point.
    :param keep_spans: ring-slice size per bundle.
    :param snapshot_every_s: cadence for :meth:`maybe_record`'s periodic
        registry snapshots (the "before" evidence).
    :param keep_snapshots: how many periodic snapshots the ring retains.
    """

    def __init__(self, dir: str, *, tracer=None, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 cooldown_s: float = 60.0, max_bundles: int = 8,
                 keep_spans: int = 512, snapshot_every_s: float = 5.0,
                 keep_snapshots: int = 8):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        if max_bundles < 1:
            raise ValueError(f"max_bundles must be >= 1, got {max_bundles}")
        if keep_spans < 1:
            raise ValueError(f"keep_spans must be >= 1, got {keep_spans}")
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.tracer = tracer
        self.registry = registry
        self._clock = clock
        self.cooldown_s = float(cooldown_s)
        self.max_bundles = int(max_bundles)
        self.keep_spans = int(keep_spans)
        self.snapshot_every_s = float(snapshot_every_s)
        self._lock = threading.Lock()
        self._last_fired: Dict[str, float] = {}
        self._last_record: Optional[float] = None
        self._snapshots: deque = deque(maxlen=max(1, int(keep_snapshots)))
        self._sources: Dict[str, Callable[[], object]] = {}
        # dumps reserved under the lock but not yet appended to `bundles`
        # — the budget check counts them so concurrent triggers of
        # DIFFERENT kinds cannot overshoot max_bundles together
        self._reserved = 0
        # resume the sequence past any bundles a previous process left in
        # the same dir, or the first dump's rename would collide with (and
        # lose) the new incident's capture
        self._seq = 0
        for entry in os.listdir(dir):
            parts = entry.split("-", 2)
            if len(parts) == 3 and parts[0] == "incident" and parts[1].isdigit():
                self._seq = max(self._seq, int(parts[1]))
        #: bundle paths written, oldest first
        self.bundles: List[str] = []
        if registry is not None:
            registry.declare_counters(*INCIDENT_COUNTERS)

    # -- always-on state -----------------------------------------------------
    def add_source(self, name: str, fn: Callable[[], object]) -> None:
        """Register a zero-arg state provider evaluated AT DUMP TIME
        (engine/fleet ``health()``, kv-pool stats, autoscaler stats, SLO
        burn state). A raising source contributes its error string instead
        of aborting the bundle."""
        self._sources[str(name)] = fn

    def maybe_record(self, *, force: bool = False) -> bool:
        """Cadence-gated periodic registry snapshot into the bounded ring
        (the bundle's "before" evidence) — call it opportunistically from
        the drive loop, the ``SnapshotWriter.maybe_write`` convention."""
        if self.registry is None:
            return False
        now = self._clock()
        with self._lock:
            if not force and self._last_record is not None and (
                now - self._last_record < self.snapshot_every_s
            ):
                return False
            self._last_record = now
            self._snapshots.append({"t": now, **self.registry.snapshot()})
            return True

    # -- the trigger path ----------------------------------------------------
    def trigger(self, kind: str, reason: str, *,
                trace_ids: Sequence[str] = (), **attrs) -> Optional[str]:
        """One incident signal from a wired seam: write a bundle unless the
        kind's cooldown or the lifetime budget suppresses it. Returns the
        bundle path, or None when suppressed or the dump failed. NEVER
        raises — the capture path must not compound the incident it
        records (failures count ``incident_dump_errors_total``)."""
        try:
            now = self._clock()
            with self._lock:
                self._inc("incident_triggers_total")
                last = self._last_fired.get(kind)
                if len(self.bundles) + self._reserved >= self.max_bundles or (
                    last is not None and now - last < self.cooldown_s
                ):
                    self._inc("incident_suppressed_total")
                    return None
                # reserve the cooldown AND a budget slot under the lock so
                # concurrent triggers (a scrape thread + the owner loop, or
                # two different kinds) cannot overshoot together
                self._last_fired[kind] = now
                self._reserved += 1
                self._seq += 1
                seq = self._seq
            try:
                path = self._dump(
                    seq, kind, reason, list(trace_ids), dict(attrs), now
                )
            except Exception as e:
                self._inc("incident_dump_errors_total")
                with self._lock:  # give back the cooldown and budget slot
                    self._reserved -= 1
                    if self._last_fired.get(kind) == now:
                        del self._last_fired[kind]
                try:  # a torn temp dir must not accumulate across retries
                    shutil.rmtree(
                        os.path.join(self.dir, f".incident-{seq:03d}-{kind}.tmp"),
                        ignore_errors=True,
                    )
                except Exception:
                    pass
                del e
                return None
            with self._lock:
                self._reserved -= 1
                self.bundles.append(path)
            self._inc("incident_bundles_total")
            if self.tracer is not None:
                self.tracer.event(
                    "incident.dump", trigger=kind, reason=reason,
                    bundle=os.path.basename(path), seq=seq,
                    trace_ids=list(trace_ids),
                )
            return path
        except Exception:
            try:
                self._inc("incident_dump_errors_total")
            except Exception:
                pass
            return None

    def _inc(self, name: str) -> None:
        if self.registry is not None:
            self.registry.inc(name)

    def _dump(self, seq: int, kind: str, reason: str, trace_ids: List[str],
              attrs: dict, now: float) -> str:
        name = f"incident-{seq:03d}-{kind}"
        final = os.path.join(self.dir, name)
        tmp = os.path.join(self.dir, f".{name}.tmp")
        os.makedirs(tmp, exist_ok=True)
        rows: List[dict] = []
        if self.tracer is not None:
            spans = list(self.tracer.finished)[-self.keep_spans:]
            rows = [s.to_row() for s in spans]
        with open(os.path.join(tmp, "spans.jsonl"), "w") as fh:
            for row in rows:
                fh.write(json.dumps(row, default=_json_default) + "\n")
        sources = {}
        for src_name, fn in self._sources.items():
            try:
                sources[src_name] = fn()
            except Exception as e:  # a broken source is itself evidence
                sources[src_name] = {"error": f"{type(e).__name__}: {e}"}
        ledger_records = None
        try:
            from perceiver_io_tpu_torch.observability.ledger import default_ledger

            snap = default_ledger().snapshot()
            snap["records"] = (snap.get("records") or [])[-64:]
            ledger_records = snap
        except Exception:
            pass
        with self._lock:
            snapshots = list(self._snapshots)
        manifest = {
            "schema": BUNDLE_SCHEMA,
            "seq": seq,
            "trigger": {
                "kind": kind,
                "reason": reason,
                "at_s": round(now, 6),
                "trace_ids": trace_ids,
                **attrs,
            },
            "metrics": {
                # last periodic ring entry = the steady state BEFORE the
                # incident; "now" = the registry at dump time
                "before": snapshots[-1] if snapshots else None,
                "now": (
                    None if self.registry is None else self.registry.snapshot()
                ),
            },
            "snapshots": snapshots,
            "compile_ledger": ledger_records,
            "sources": sources,
            "spans": len(rows),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=2, default=_json_default)
        os.rename(tmp, final)
        return final

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "bundles": len(self.bundles),
                "max_bundles": self.max_bundles,
                "cooldown_s": self.cooldown_s,
                "last_fired": {
                    k: round(v, 6) for k, v in sorted(self._last_fired.items())
                },
                "snapshots_recorded": len(self._snapshots),
                "sources": sorted(self._sources),
            }
