"""Process-wide metrics registry: counters, gauges, bounded-reservoir
histograms.

The repo grew four disjoint telemetry islands (trainer ``metrics.jsonl``/TB,
``ServingEngine.stats()``, ``inference.executor_cache_stats``, trainer
``fault_stats``) — none sharing names or an export path. This registry is
the one source of truth they migrate onto: a component increments a counter
under its canonical name exactly once, and every exporter
(:mod:`~perceiver_io_tpu_torch.observability.exporters`), the serve CLI, and the
bench probe read the same numbers.

Design constraints, in order:

- **Cheap on the hot path.** ``inc``/``observe`` are a lock acquire plus a
  dict update — microseconds against millisecond device steps (the slow-tier
  overhead test pins the total at < 2% of a CPU bench step).
- **Thread-safe.** One lock guards every map, so multiple threads can emit
  metrics concurrently (e.g. a front-end thread counting its own events
  while the engine's owner thread drains). NOTE: this makes the *registry*
  safe to share — the ServingEngine queue itself stays synchronous and
  single-owner (``serving/engine.py`` docstring).
- **Deterministic.** Histograms keep a sliding window of the most recent
  observations (a ring buffer, not a random-replacement reservoir), so
  percentiles are a pure function of the observation sequence and chaos
  tests replay bit-identically.
- **Injectable clock.** :meth:`MetricsRegistry.timer` measures on the
  registry's clock, so ``reliability.FakeClock`` drives deterministic
  latency tests with zero sleeps.

Naming convention (Prometheus-style): monotonic counters end in ``_total``,
durations are ``*_ms`` histograms, instantaneous values are bare-named
gauges — e.g. ``serving_requests_completed_total``,
``serving_queue_wait_ms``, ``trainer_steps_per_sec``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional


class Histogram:
    """Bounded-reservoir histogram: lifetime ``count``/``sum``/``max`` plus
    percentiles over a sliding window of the last ``window`` observations.

    The window is a ring buffer — deterministic, O(window) memory — not a
    probabilistic reservoir: serving percentiles should reflect *recent*
    latency anyway, and chaos tests need replayable numbers.
    """

    __slots__ = ("count", "total", "max", "_ring")

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"histogram window must be >= 1, got {window}")
        self.count = 0
        self.total = 0.0
        self.max: Optional[float] = None
        self._ring: deque = deque(maxlen=window)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.max is None or value > self.max:
            self.max = value
        self._ring.append(value)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the sliding window (None if empty)."""
        if not self._ring:
            return None
        ordered = sorted(self._ring)
        idx = min(len(ordered) - 1, int(round(p / 100.0 * (len(ordered) - 1))))
        return ordered[idx]

    def summary(self) -> dict:
        """The export shape every consumer sees: lifetime count/sum/max plus
        window p50/p95/p99."""
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "max": None if self.max is None else round(self.max, 6),
            "p50": _round(self.percentile(50.0)),
            "p95": _round(self.percentile(95.0)),
            "p99": _round(self.percentile(99.0)),
        }


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


class MetricsRegistry:
    """Thread-safe map of counters, gauges, and histograms.

    :param clock: monotonic time source for :meth:`timer`; tests pass a
        :class:`~perceiver_io_tpu_torch.reliability.FakeClock`.
    :param histogram_window: sliding-window size for new histograms.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 histogram_window: int = 2048):
        self._lock = threading.Lock()
        self._clock = clock
        self._histogram_window = histogram_window
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> float:
        """Add ``value`` to counter ``name`` (created at 0); returns the new
        total. Counters are monotonic — use a gauge for values that move both
        ways."""
        if value < 0:
            raise ValueError(f"counter {name} cannot decrease (value={value})")
        with self._lock:
            new = self._counters.get(name, 0.0) + value
            self._counters[name] = new
            return new

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        """One consistent copy of the counters map (single lock hold) —
        cheaper than :meth:`snapshot` for pollers that don't need histogram
        summaries (which sort every window under the lock)."""
        with self._lock:
            return dict(self._counters)

    def declare_counters(self, *names: str) -> None:
        """Pre-register counters at 0 so exports show the full schema before
        the first event (a dashboard key that appears only after the first
        failure is a dashboard nobody trusts)."""
        with self._lock:
            for name in names:
                self._counters.setdefault(name, 0.0)

    # -- gauges -------------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    # -- histograms ---------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram(self._histogram_window)
            hist.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._histograms.get(name)

    def percentile(self, name: str, p: float) -> Optional[float]:
        with self._lock:
            hist = self._histograms.get(name)
            return None if hist is None else hist.percentile(p)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Observe the enclosed region's duration into histogram ``name``,
        in milliseconds, on the registry's (injectable) clock."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(name, (self._clock() - t0) * 1e3)

    # -- export / lifecycle -------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-able view of everything: ``{"counters", "gauges",
        "histograms"}`` — the export shape both the Prometheus dump and the
        JSON snapshot writer render from."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._histograms.items()},
            }

    def reset(self, prefix: str = "") -> None:
        """Zero counters/gauges and drop histograms whose name starts with
        ``prefix`` ('' = everything) — test isolation, and the hook
        ``inference.generate.reset_executor_caches`` uses to rewind the
        executor-cache counters."""
        with self._lock:
            for k in list(self._counters):
                if k.startswith(prefix):
                    self._counters[k] = 0.0
            for k in list(self._gauges):
                if k.startswith(prefix):
                    del self._gauges[k]
            for k in list(self._histograms):
                if k.startswith(prefix):
                    del self._histograms[k]


#: The process-wide default registry. Process-global state (the executor
#: caches in ``inference.generate``/``inference.beam``) counts here; scoped
#: components (one ServingEngine, one Trainer) default to their own registry
#: so two engines never double-count each other's traffic, but accept a
#: shared one for unified export.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
