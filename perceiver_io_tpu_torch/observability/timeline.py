"""Scheduler step timeline (docs/observability.md "Scheduler timeline &
post-mortems").

Spans (``tracing.py``) answer *what happened to one request*; the metrics
registry answers *how much in aggregate*. Neither records **what the
scheduler did each pass** — which requests admitted, which slots decoded
real rows vs padding, who was preempted for whom, and where the wall time
of the pass went. The serving papers this repo reproduces (PAPERS.md: the
Gemma-on-TPU serving comparison, the ragged paged-attention kernel paper)
justify their scheduling and kernel choices with exactly that step-level
occupancy/phase evidence; :class:`StepTimeline` is the instrument.

Both engines (:class:`~perceiver_io_tpu_torch.serving.engine.ServingEngine`
micro-batch passes, :class:`~perceiver_io_tpu_torch.serving.slots.SlotServingEngine`
token-granular passes) append ONE structured record per scheduler pass when
an operator attaches a timeline (``engine.timeline = StepTimeline(...)`` /
``--obs.timeline.steps``). A record is a plain JSON-serializable dict:

- ``step``        monotone pass index (assigned here, never reused)
- ``engine``      ``"slots"`` | ``"bucket"``
- ``t_start_s`` / ``t_end_s``  pass window on the ENGINE clock (the
  injectable one — composes with :class:`~perceiver_io_tpu_torch.reliability.FakeClock`
  so chaos drills replay bit-identically)
- ``phases_ms``   per-phase wall ms within the pass (slots: ``admit`` /
  ``decode`` / ``account`` + ``total``; bucket: ``assemble`` / ``execute``
  + ``total``)
- ``slots``       occupancy vector: per-slot resident ``request_id`` or None
- ``rows``        real vs padded decode rows this pass (slot engine)
- ``pool``        KV pool blocks in_use / reserved / headroom
- ``tenants``     resident pool pages per tenant (sanitized label)
- event lists keyed by kind — ``admitted`` / ``chunks`` / ``tokens`` /
  ``finished`` / ``preempted`` / ``readmitted`` — each entry a small dict
  carrying the ids the ``obs timeline`` analyzer joins against span events.

Token entries carry the SAME rounded ``ttft_ms`` / ``itl_ms`` values the
span events do, so the analyzer's per-request phase decomposition
telescopes exactly to the registry-recorded ``serving_ttft_ms`` /
``serving_inter_token_ms`` (0.0 unattributed under FakeClock — the
``report.ttft_decomposition`` exactness bar).

The ring is bounded (``cap`` records; evictions counted on
``timeline_records_dropped_total``) and stdlib-only, same as the rest of
the observability package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from collections import deque
from typing import Deque, Dict, List, Optional

#: first line of a timeline JSONL export — readers verify before parsing
TIMELINE_SCHEMA = "step-timeline-v1"

_LABEL_RE = re.compile(r"[^0-9A-Za-z_]")


def tenant_label(tenant: Optional[str]) -> str:
    """Metric-safe label for a tenant id: ``None`` (untagged traffic) maps
    to ``"default"``; anything else keeps ``[0-9A-Za-z_]`` and replaces the
    rest with ``_`` (Prometheus metric-name charset). Collisions after
    sanitization share a label — attribution, not authentication."""
    if tenant is None:
        return "default"
    out = _LABEL_RE.sub("_", str(tenant))
    return out or "default"


def tier_label(tier: int) -> str:
    """Metric-safe label for a priority tier: metric names can't hold
    ``-``, so negative tiers spell the sign out (``neg1``) — the
    ``kv_preemptions_tier_*`` naming convention."""
    tier = int(tier)
    return f"neg{-tier}" if tier < 0 else str(tier)


@dataclasses.dataclass
class TimelineArgs:
    """The ``--obs.timeline.*`` CLI sub-group (nested in
    ``ObservabilityArgs`` like ``slo``/``incident``). Setting ``steps > 0``
    attaches a :class:`StepTimeline` to every serve-run engine; the other
    knobs require it (inapplicable-flag convention)."""

    #: ring capacity in scheduler passes; 0 disables the timeline
    steps: int = 0
    #: write the ring as JSONL here when the serve run ends (the ``obs
    #: timeline`` analyzer's input)
    export: Optional[str] = None
    #: modeled host-link bandwidth (GB/s, decimal) for the preemption
    #: post-mortems' hypothetical swap cost — victim bytes / this rate
    swap_gbps: float = 16.0

    @property
    def enabled(self) -> bool:
        return self.steps > 0


class StepTimeline:
    """Bounded ring of per-scheduler-pass records (one ``append`` per
    ``engine.step()`` call). Thread-compat with the engines' existing
    single-scheduler discipline — no lock; the appending engine owns it."""

    def __init__(self, cap: int = 256, registry=None):
        if cap < 1:
            raise ValueError(f"timeline cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self._records: Deque[dict] = deque(maxlen=self.cap)
        self._next_step = 0
        self.dropped = 0
        self.registry = registry
        if registry is not None:
            registry.declare_counters(
                "timeline_steps_total", "timeline_records_dropped_total"
            )

    def __len__(self) -> int:
        return len(self._records)

    def append(self, record: dict) -> dict:
        """Stamp ``record`` with the next pass index and append it,
        evicting (and counting) the oldest record past ``cap``."""
        record = dict(record)
        record["step"] = self._next_step
        self._next_step += 1
        if len(self._records) == self.cap:
            self.dropped += 1
            if self.registry is not None:
                self.registry.inc("timeline_records_dropped_total")
        self._records.append(record)
        if self.registry is not None:
            self.registry.inc("timeline_steps_total")
            self.registry.set_gauge("timeline_ring_records", len(self._records))
        return record

    def records(self) -> List[dict]:
        return list(self._records)

    def last(self) -> Optional[dict]:
        return self._records[-1] if self._records else None

    def clear(self) -> None:
        self._records.clear()

    def summary(self) -> dict:
        """Aggregate view for ``stats()`` / ``serve_stats``: pass counts,
        ring occupancy, and per-kind event totals over the retained ring."""
        kinds: Dict[str, int] = {}
        for rec in self._records:
            for key, value in rec.items():
                if isinstance(value, list) and key != "slots":
                    kinds[key] = kinds.get(key, 0) + len(value)
        return {
            "steps": self._next_step,
            "retained": len(self._records),
            "cap": self.cap,
            "dropped": self.dropped,
            "events": dict(sorted(kinds.items())),
        }

    # -- persistence ---------------------------------------------------------
    def write_jsonl(self, path: str) -> int:
        """Write the retained ring as JSONL: one schema header line, then
        one record per line (the ``obs timeline`` analyzer's input format).
        Returns the number of records written. Atomic (dot-tmp rename),
        same discipline as the flight recorder's bundle dump."""
        header = {
            "schema": TIMELINE_SCHEMA,
            "cap": self.cap,
            "dropped": self.dropped,
            "steps": self._next_step,
        }
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header, sort_keys=True) + "\n")
            for rec in self._records:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return len(self._records)


def read_timeline_jsonl(path: str) -> List[dict]:
    """Read a :meth:`StepTimeline.write_jsonl` export back: verifies the
    schema header and returns the record dicts in step order. Tolerates a
    torn final line (the events.jsonl reader's convention)."""
    records: List[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        first = fh.readline()
        if not first.strip():
            return records
        header = json.loads(first)
        schema = header.get("schema")
        if schema != TIMELINE_SCHEMA:
            raise ValueError(
                f"not a step-timeline export: schema {schema!r} "
                f"(expected {TIMELINE_SCHEMA!r})"
            )
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail from an interrupted writer
    return records
