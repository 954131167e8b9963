"""Span tracing: where did this request's (or this step's) latency go?

Counterpart of ``perceiver_io_tpu/observability/tracing.py``.

A :class:`Span` is one named, timed region with attributes; a
:class:`Tracer` allocates deterministic trace/span IDs, retains finished
spans in a bounded buffer (test introspection), and optionally streams each
finished span as one JSON line to a sink (:class:`JsonlSpanSink` →
``events.jsonl``).

The serving lifecycle threads ONE trace per request through
``submit → queued → batched → executed → split/complete`` — every submitted
request ends in exactly one terminal ``serving.request`` span whose
``status`` is ``ok``/``shed``/``timed_out``/``failed``/``rejected``, which
is what makes span accounting *closeable*: terminal spans reconcile 1:1
against ``ServingEngine.stats()`` counters. The trainer emits per-step
``trainer.data_wait`` / ``trainer.step`` / ``trainer.log_flush`` /
``trainer.checkpoint`` spans under one trace per ``fit``.

IDs are sequential (``t000001``, ``s000001``), not random: deterministic
under the chaos harness and trivially joinable from the serve CLI's JSON
lines. Because the JSONL sink appends, two *processes* writing the same
events file would collide on restarted IDs — pass a per-run ``prefix``
(the CLI derives one from the pid + start time) to disambiguate; the
default stays bare for deterministic tests.

Components take ``tracer=None`` and skip every span site when unset — the
same zero-cost-when-off contract as the chaos hooks.

**Trace sampling** (docs/observability.md "Trace sampling"): at fleet
scale the span stream is a firehose — every request writes ~6 lines — so
:class:`SamplingSpanSink` sits between the tracer and the JSONL sink and
keeps a deterministic fraction of *ok* request traces (head sampling on a
per-trace counter: every Nth new trace — no RNG, so FakeClock drills
replay bit-identically) while ALWAYS retaining the traces an operator
actually reads: any trace ending in a non-``ok`` terminal status
(:data:`TAIL_KEEP_STATUSES`) or whose terminal span exceeded
``keep_slow_ms``. Dropped spans are counted
(``tracing_spans_sampled_out_total`` etc.) so accounting stays closeable,
and sampled-out traces still land in the tracer's in-memory ring — the
:class:`~perceiver_io_tpu_torch.observability.flight_recorder.FlightRecorder`'s
incident bundles see everything recent regardless of the disk policy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One timed region. ``end_s`` is None while open; ``status`` is set at
    end time (``ok`` unless the region raised or the caller overrode it)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float
    end_s: Optional[float] = None
    status: str = "open"
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return (self.end_s - self.start_s) * 1e3

    def to_row(self) -> dict:
        """The events.jsonl line shape."""
        return {
            "span": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.start_s, 6),
            "duration_ms": None if self.duration_ms is None else round(self.duration_ms, 3),
            "status": self.status,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class Tracer:
    """Span factory + finished-span buffer + optional JSONL sink.

    :param clock: monotonic time source (``FakeClock`` for deterministic
        tests).
    :param sink: callable receiving each finished span's ``to_row()`` dict —
        usually a :class:`JsonlSpanSink`. None keeps spans in memory only.
    :param keep: how many finished spans the in-memory buffer retains.
    :param prefix: prepended to every trace/span ID. Default "" keeps IDs
        deterministic for tests; pass a per-run token when several runs
        append to one events file (trace IDs restart per process).
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 sink: Optional[Callable[[dict], None]] = None, keep: int = 8192,
                 prefix: str = ""):
        self._clock = clock
        self._sink = sink
        self._lock = threading.Lock()
        self._prefix = prefix
        self._next_trace = 0
        self._next_span = 0
        self.finished: deque = deque(maxlen=keep)

    def now(self) -> float:
        """The tracer's clock — callers that backdate spans from durations
        measured on a DIFFERENT clock must translate into this domain
        (``start_s = tracer.now() - duration``), or span durations mix two
        time bases (e.g. a FakeClock engine with a wall-clock tracer)."""
        return self._clock()

    # -- ids ----------------------------------------------------------------
    def new_trace_id(self) -> str:
        with self._lock:
            self._next_trace += 1
            return f"{self._prefix}t{self._next_trace:06d}"

    def _new_span_id(self) -> str:
        self._next_span += 1
        return f"{self._prefix}s{self._next_span:06d}"

    # -- span lifecycle -----------------------------------------------------
    def start_span(self, name: str, *, trace_id: Optional[str] = None,
                   parent: Optional[Span] = None,
                   start_s: Optional[float] = None, **attrs: Any) -> Span:
        """Open a span. ``start_s`` backdates it (the engine opens a request's
        terminal span at its recorded submit time)."""
        with self._lock:
            span_id = self._new_span_id()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else self.new_trace_id()
        return Span(
            name=name, trace_id=trace_id, span_id=span_id,
            parent_id=None if parent is None else parent.span_id,
            start_s=self._clock() if start_s is None else float(start_s),
            attrs=dict(attrs),
        )

    def end_span(self, span: Span, status: str = "ok", **attrs: Any) -> Span:
        span.end_s = self._clock()
        span.status = status
        span.attrs.update(attrs)
        with self._lock:
            self.finished.append(span)
            sink = self._sink
        if sink is not None:
            sink(span.to_row())
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent: Optional[Span] = None, **attrs: Any):
        """Context-managed span; a raising body ends it ``status="error"``
        (and re-raises)."""
        sp = self.start_span(name, trace_id=trace_id, parent=parent, **attrs)
        try:
            yield sp
        except BaseException:
            self.end_span(sp, status="error")
            raise
        self.end_span(sp)

    def event(self, name: str, *, trace_id: Optional[str] = None,
              status: str = "ok", start_s: Optional[float] = None,
              **attrs: Any) -> Span:
        """A point (or backdated) span ended immediately — terminal request
        states, shed/rejected submissions."""
        sp = self.start_span(name, trace_id=trace_id, start_s=start_s, **attrs)
        return self.end_span(sp, status=status)

    # -- introspection ------------------------------------------------------
    def spans(self, name: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[Span]:
        """Finished spans, optionally filtered — the accounting tests' view."""
        with self._lock:
            out = list(self.finished)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out


def _json_default(obj):
    """Last-resort JSON coercion for span attrs: numpy scalars and 0-d CPU
    tensors carry ``item()`` (their native Python value — keeps numbers
    numeric in the file); anything else degrades to ``str`` so one exotic
    attr can never poison the telemetry write path. A tensor on the card is
    written as ``str`` without ``item()``: reading it would synchronise the
    card on the span write path (every hook passes host numbers)."""
    device = getattr(obj, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        return str(obj)
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


class JsonlSpanSink:
    """Append finished spans to a JSONL file (``events.jsonl``), one line
    per span, flushed per write so a crashed run still leaves a complete
    prefix. Rank gating is the caller's job (the trainer only constructs a
    sink on process 0).

    Write failures — disk full, directory removed mid-run, and
    serialization failures alike (a span attr that ``json`` cannot encode
    is coerced via :func:`_json_default` first; only a genuinely
    un-stringable row fails) — are counted in :attr:`write_errors`, never
    raised: telemetry must not kill the run it observes (the same contract
    as ``SnapshotWriter.maybe_write``).

    :param max_bytes: on-disk bound. When appending a line would push the
        file past it, the current file rotates to ``<path>.1`` (replacing
        any previous rotation) and writing restarts fresh — single-file
        rotation, so the pair never exceeds ``2 × max_bytes`` (plus one
        line) and ``events.jsonl`` itself stays under the bound.
        :func:`read_events_jsonl` reads the rotated pair transparently.
        None (default) keeps the historical unbounded append."""

    def __init__(self, path: str, *, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.path = path
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._fh = open(path, "a")
        try:
            self._size = self._fh.tell()
        except OSError:
            self._size = 0
        self.write_errors = 0
        self.rotations = 0

    def _rotate_locked(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "w")
        self._size = 0
        self.rotations += 1

    def __call__(self, row: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            try:
                line = json.dumps(row, default=_json_default) + "\n"
            except (TypeError, ValueError):
                self.write_errors += 1
                return
            try:
                if (
                    self.max_bytes is not None
                    and self._size > 0
                    and self._size + len(line) > self.max_bytes
                ):
                    self._rotate_locked()
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
            except OSError:
                self.write_errors += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    self.write_errors += 1
                self._fh = None


#: terminal request-span names — a trace's sampling fate is decided when
#: one of these finishes (every submission ends in exactly one; the
#: docstring lifecycle diagram)
TERMINAL_SPANS = frozenset({"serving.request", "fleet.request"})

#: span-name prefixes subject to sampling: the per-request firehose.
#: Operational streams (``ledger.compile``, ``slo.*``, ``autoscaler.*``,
#: ``trainer.*``, ``incident.*``) always write through — they are rare and
#: exactly what an operator greps first.
SAMPLED_PREFIXES = ("serving.", "fleet.", "gateway.")

#: terminal statuses that tail-keep a trace regardless of head sampling —
#: every way a request can end other than cleanly
TAIL_KEEP_STATUSES = frozenset(
    {"shed", "timed_out", "failed", "rejected", "cancelled", "error"}
)


class SamplingSpanSink:
    """Deterministic head-sampled span sink with tail-keep (module
    docstring; docs/observability.md "Trace sampling").

    Sits between a :class:`Tracer` and its real sink (usually a
    :class:`JsonlSpanSink`). Per in-scope trace (:data:`SAMPLED_PREFIXES`),
    the FIRST span seen assigns the trace a sequence number; every
    ``stride``-th trace (``stride = round(1 / rate)``) is head-kept and
    streams through immediately. Other traces buffer until their terminal
    span (:data:`TERMINAL_SPANS`) decides them: a non-``ok`` status
    (:data:`TAIL_KEEP_STATUSES`) or a terminal duration at or above
    ``keep_slow_ms`` tail-keeps the WHOLE buffered trace; a clean fast
    trace drops, counted. Counter-based, no RNG, no clock — bit-identical
    under replay.

    Registry families (declared up front): ``tracing_spans_total`` /
    ``tracing_spans_kept_total`` / ``tracing_spans_sampled_out_total``
    (kept + sampled_out == total, the closeable-accounting invariant) and
    ``tracing_traces_kept_total`` / ``tracing_traces_sampled_out_total``.
    Out-of-scope spans count as kept, so the span accounting covers every
    row the tracer emitted.

    :param sink: the downstream row consumer.
    :param rate: fraction of clean traces kept, in ``(0, 1]``.
    :param keep_slow_ms: tail-keep latency threshold on the terminal
        span's ``duration_ms`` (None disables the latency rule).
    :param registry: where the ``tracing_*`` counters live (None skips).
    :param max_pending: bound on undecided buffered traces; overflow
        force-drops the OLDEST pending trace (counted) — a trace whose
        terminal span never arrives must not grow the buffer forever.
    """

    COUNTERS = (
        "tracing_spans_total",
        "tracing_spans_kept_total",
        "tracing_spans_sampled_out_total",
        "tracing_traces_kept_total",
        "tracing_traces_sampled_out_total",
    )

    def __init__(self, sink: Callable[[dict], None], *, rate: float,
                 keep_slow_ms: Optional[float] = None, registry=None,
                 max_pending: int = 4096):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1], got {rate}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._sink = sink
        self.rate = float(rate)
        self.stride = max(1, int(round(1.0 / rate)))
        self.keep_slow_ms = keep_slow_ms
        self.registry = registry
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()
        self._seq = 0  # per-new-trace counter (the head-sampling basis)
        # trace_id -> keep decision; bounded FIFO so a long run cannot grow
        # it forever (late spans of an evicted trace just re-sample)
        self._decided: "OrderedDict[str, bool]" = OrderedDict()
        self._pending: "OrderedDict[str, List[dict]]" = OrderedDict()
        if registry is not None:
            registry.declare_counters(*self.COUNTERS)

    def _inc(self, name: str, n: float = 1.0) -> None:
        if self.registry is not None and n:
            self.registry.inc(name, n)

    def _write(self, row: dict) -> None:
        self._sink(row)
        self._inc("tracing_spans_kept_total")

    def _decide(self, trace_id: str, keep: bool) -> None:
        self._decided[trace_id] = keep
        while len(self._decided) > 4 * self.max_pending:
            self._decided.popitem(last=False)
        if keep:
            self._inc("tracing_traces_kept_total")
        else:
            self._inc("tracing_traces_sampled_out_total")

    def __call__(self, row: dict) -> None:
        with self._lock:
            name = str(row.get("span") or "")
            self._inc("tracing_spans_total")
            trace_id = row.get("trace_id")
            if not name.startswith(SAMPLED_PREFIXES) or trace_id is None:
                self._write(row)  # operational stream: never sampled
                return
            decided = self._decided.get(trace_id)
            if decided is not None:
                if decided:
                    self._write(row)
                else:
                    self._inc("tracing_spans_sampled_out_total")
                return
            buf = self._pending.get(trace_id)
            if buf is None:
                index = self._seq
                self._seq += 1
                if index % self.stride == 0:
                    self._decide(trace_id, True)  # head-kept: stream through
                    self._write(row)
                    return
                buf = self._pending[trace_id] = []
                while len(self._pending) > self.max_pending:
                    # overflow: force-drop the oldest undecided trace
                    stale_id, stale = self._pending.popitem(last=False)
                    self._decide(stale_id, False)
                    self._inc("tracing_spans_sampled_out_total", len(stale))
                    buf = self._pending.get(trace_id)
                    if buf is None:  # the overflow victim was this trace
                        self._inc("tracing_spans_sampled_out_total")
                        return
            buf.append(row)
            if name not in TERMINAL_SPANS:
                return
            # the trace's fate: tail-keep on a dirty or slow terminal
            duration = row.get("duration_ms")
            keep = row.get("status") in TAIL_KEEP_STATUSES or (
                self.keep_slow_ms is not None
                and isinstance(duration, (int, float))
                and duration >= self.keep_slow_ms
            )
            del self._pending[trace_id]
            self._decide(trace_id, keep)
            if keep:
                for buffered in buf:
                    self._write(buffered)
            else:
                self._inc("tracing_spans_sampled_out_total", len(buf))

    def flush(self) -> int:
        """Write every still-undecided buffered trace (kept — a trace with
        no terminal span at shutdown is an interrupted request, exactly
        what a post-mortem wants on disk); returns spans written."""
        with self._lock:
            written = 0
            while self._pending:
                trace_id, buf = self._pending.popitem(last=False)
                self._decide(trace_id, True)
                for row in buf:
                    self._write(row)
                    written += 1
            return written

    def close(self) -> None:
        """Flush pending traces, then close the wrapped sink (if it has a
        ``close``) — drop-in for the callers that close ``JsonlSpanSink``."""
        self.flush()
        close = getattr(self._sink, "close", None)
        if close is not None:
            close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "rate": self.rate,
                "stride": self.stride,
                "keep_slow_ms": self.keep_slow_ms,
                "pending_traces": len(self._pending),
                "decided_traces": len(self._decided),
            }


def read_events_jsonl(path: str) -> List[dict]:
    """Parse an events.jsonl file, skipping torn trailing lines (the file is
    flushed per span, but a SIGKILL can still truncate the last write).
    When the sink rotated (``JsonlSpanSink(max_bytes=...)``), the rotated
    predecessor ``<path>.1`` is read first so rows come back in write
    order across the pair."""
    rows: List[dict] = []
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        paths = [path]  # surface the caller's FileNotFoundError unchanged
    for part in paths:
        with open(part) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return rows
