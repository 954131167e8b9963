"""Device-cost ledger: build / memory / retrace attribution.

Counterpart of ``perceiver_io_tpu/observability/ledger.py``, keeping its
records, retrace attribution and registry families. In eager PyTorch
nothing is compiled per shape: the port's builds are the kernel libraries
``_build.py`` compiles with ``nvcc``, one per ``csrc/*.cu``. Each build
is recorded through :meth:`CompileLedger.record_build` at site
``kernel_build``, with the source as its identity and the 12-hex hash of
the source and the shared headers and the compile flags as components, so
an edited header shows as a retrace attributed to ``hash``; its
``compile_ms`` is the ``nvcc`` wall time. A library loaded from
``build/kernels/`` is no build. Cost and memory analysis are ``None``
(JAX's records allow it: a backend without the analyses reports None).

- **retrace attribution**: when a logically-same build (same site, same
  ``model`` or ``source``) happens again, its named components are diffed
  against the previous build's and the rebuild is counted under every
  component that changed; the first build of an identity is cold.

Registry families fed:

- ``compile_total`` counter and ``compile_ms`` histogram;
- ``retrace_total`` plus per-reason ``retrace_reason_<component>_total``;
- ``executor_resident_bytes`` gauge (recorded temp + output bytes; 0 for
  kernel builds, which report no memory analysis);
- ``hbm_bytes_in_use`` gauge via :meth:`update_device_gauges`: the card's
  ``torch.cuda.memory_allocated()`` (skipped without a card);
- ``kv_cache_resident_bytes`` gauge: the slot engine's KV footprint.

JAX's ``LedgeredExecutor`` (ahead-of-time lowering of a jitted executor)
has no counterpart: nothing here lowers or compiles a program.

Determinism: with an injected clock the records (ordering, sequence
numbers, retrace reasons) are a pure function of the build sequence.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from perceiver_io_tpu_torch.observability.registry import MetricsRegistry


def _sanitize_reason(name: str) -> str:
    """Component name -> metric-name-safe reason token."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


#: the memory-analysis fields of a record
_MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes")


class CompileLedger:
    """Per-build compile/memory/retrace ledger over one metrics registry.

    :param registry: registry the canonical families land on; defaults to
        the process-wide :func:`~perceiver_io_tpu_torch.observability.default_registry`
        (kernel libraries are process-global, so their ledger is too).
    :param clock: monotonic time source —
        ``reliability.FakeClock`` makes records fully deterministic.
    :param keep: bound on retained per-key records (FIFO; the registry
        counters keep counting past it).
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 keep: int = 512):
        if registry is None:
            from perceiver_io_tpu_torch.observability.registry import default_registry

            registry = default_registry()
        self.registry = registry
        self._clock = clock
        self._keep = keep
        self._lock = threading.Lock()
        self._records: List[dict] = []
        #: identity -> components of that identity's most recent build
        self._last: Dict[tuple, Dict[str, str]] = {}
        #: (site, components) -> latest build's temp+output bytes; kept
        #: incrementally so the resident gauge costs O(1) per compile
        #: (independent of the ``keep`` record bound)
        self._resident: Dict[tuple, int] = {}
        #: lifetime totals — unlike ``_records`` these never FIFO out, so
        #: the rollup stays exact past the ``keep`` bound
        self._total_retraces = 0
        self._total_compile_ms = 0.0
        self._reason_totals: Dict[str, int] = {}
        self._seq = 0
        self._on_record: List[Callable[[dict], None]] = []
        registry.declare_counters(
            "compile_total", "retrace_total", "compile_ledger_fallback_total"
        )

    # -- wiring ---------------------------------------------------------------
    def record_build(self, site: str, components: Dict[str, Any], compile_ms: float, *,
                     cost: Optional[Dict[str, Optional[float]]] = None,
                     memory: Optional[Dict[str, Optional[int]]] = None) -> None:
        """Record one finished build.

        :param site: build-site name (``kernel_build`` for an ``nvcc``
            build of one ``csrc/*.cu``).
        :param components: the NAMED components of the build's key; retrace
            attribution diffs these. Values are stringified; ``model`` or
            ``source`` defines the identity a rebuild is compared against.
        :param compile_ms: the build's wall time.
        :param cost: ``{flops, bytes_accessed}``; None reports both None.
        :param memory: ``{argument,output,temp,generated_code}_bytes``;
            None reports all four None.
        """
        comps = {k: str(v) for k, v in components.items()}
        self._record_compiled(
            {"site": site, "components": comps}, compile_ms,
            cost or {"flops": None, "bytes_accessed": None},
            memory or {k: None for k in _MEMORY_KEYS},
        )

    def attach(self, callback: Callable[[dict], None]) -> Callable[[], None]:
        """Register a per-record callback (the serve CLI forwards records as
        ``ledger.compile`` span events into events.jsonl); returns a detach
        function. Callback exceptions are swallowed — the ledger must never
        fail the build it observes."""
        self._on_record.append(callback)

        def detach() -> None:
            try:
                self._on_record.remove(callback)
            except ValueError:
                pass

        return detach

    # -- recording -------------------------------------------------------------
    def _identity(self, site: str, components: Dict[str, str]) -> tuple:
        """A rebuild is "logically the same build" when site + model (or,
        for a kernel build, site + source) match; every other component
        (a hash, the flags, a bucket shape) is a variant axis a retrace is
        attributed to."""
        return (site, components.get("model", components.get("source", "")))

    def _record_compiled(self, entry: dict, compile_ms: float,
                         cost: Dict[str, Optional[float]],
                         memory: Dict[str, Optional[int]]) -> None:
        site, comps = entry["site"], entry["components"]
        identity = self._identity(site, comps)
        with self._lock:
            self._seq += 1
            prev = self._last.get(identity)
            reasons: tuple = ()
            if prev is not None:
                changed = sorted(
                    k for k in (set(prev) | set(comps))
                    if prev.get(k) != comps.get(k)
                )
                reasons = tuple(changed) if changed else ("duplicate_key",)
            self._last[identity] = comps
            record = {
                "seq": self._seq,
                "site": site,
                "components": dict(comps),
                "compile_ms": round(compile_ms, 3),
                "flops": cost["flops"],
                "bytes_accessed": cost["bytes_accessed"],
                **memory,
                "retrace": prev is not None,
                "retrace_reasons": list(reasons),
            }
            self._records.append(record)
            if len(self._records) > self._keep:
                self._records.pop(0)
            self._total_compile_ms += compile_ms
            if reasons:
                self._total_retraces += 1
                for reason in reasons:
                    self._reason_totals[reason] = (
                        self._reason_totals.get(reason, 0) + 1
                    )
            # one entry per distinct (site, components) executor — a
            # rebuild of the same program replaces its bytes rather than
            # accumulating (the ledger can't see cache evictions; evicted
            # executors stay counted until reset)
            self._resident[(site, tuple(sorted(comps.items())))] = (
                (memory["temp_bytes"] or 0) + (memory["output_bytes"] or 0)
            )
            resident = sum(self._resident.values())
        reg = self.registry
        reg.inc("compile_total")
        reg.observe("compile_ms", compile_ms)
        if reasons:
            reg.inc("retrace_total")
            for reason in reasons:
                reg.inc(f"retrace_reason_{_sanitize_reason(reason)}_total")
        reg.set_gauge("executor_resident_bytes", resident)
        for callback in list(self._on_record):
            try:
                callback(record)
            except Exception:
                pass

    # -- device gauges -----------------------------------------------------------
    def update_device_gauges(self) -> Optional[int]:
        """Publish ``hbm_bytes_in_use`` from the card's allocator:
        ``torch.cuda.memory_allocated()`` (the bytes live tensors hold on the
        current card). Returns the value, or None without a card, where the
        gauge is skipped and the analytic ``kv_cache_resident_bytes`` stays."""
        try:
            import torch

            if not torch.cuda.is_available() or not torch.cuda.is_initialized():
                return None
            value = int(torch.cuda.memory_allocated())
        except Exception:
            return None
        self.registry.set_gauge("hbm_bytes_in_use", value)
        return value

    def set_kv_cache_bytes(self, nbytes: int) -> None:
        """Analytic KV-cache footprint gauge (the slot engine publishes its
        persistent slot state's byte size — exact on every backend)."""
        self.registry.set_gauge("kv_cache_resident_bytes", int(nbytes))

    # -- introspection / export ---------------------------------------------------
    def records(self, site: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = [dict(r) for r in self._records]
        if site is not None:
            out = [r for r in out if r["site"] == site]
        return out

    def rollup(self) -> dict:
        """Records-free summary — counts, reasons, compile-time total. This
        is what pollable surfaces (``ServingEngine.stats()``) embed: no
        per-record dict copies on the scrape path. All values are LIFETIME
        totals (matching the registry counters), not views over the
        ``keep``-bounded record list."""
        with self._lock:
            rollup = {
                "compiles": self._seq,
                "retraces": self._total_retraces,
                "retrace_reasons": dict(sorted(self._reason_totals.items())),
                "compile_ms_total": round(self._total_compile_ms, 3),
            }
        rollup["fallbacks"] = int(
            self.registry.counter("compile_ledger_fallback_total")
        )
        return rollup

    def snapshot(self) -> dict:
        """JSON-able ledger view: the lifetime rollup plus the per-key
        compile/memory table every durable consumer (``serve_stats``,
        snapshots, bench records, ``obs report``) embeds. The table is
        bounded by ``keep`` (oldest rows FIFO out); the rollup keeps
        counting past it."""
        return {**self.rollup(), "records": self.records()}

    def reset(self) -> None:
        """Drop records and identity history (test isolation; registry
        counters are reset separately via ``registry.reset``)."""
        with self._lock:
            self._records.clear()
            self._last.clear()
            self._resident.clear()
            self._total_retraces = 0
            self._total_compile_ms = 0.0
            self._reason_totals.clear()
            self._seq = 0
        # the executors the gauge described are gone too
        self.registry.set_gauge("executor_resident_bytes", 0)


#: Process-wide default ledger, mirroring ``default_registry()``: the
#: kernel libraries it observes are process-global.
_DEFAULT: Optional[CompileLedger] = None
_DEFAULT_LOCK = threading.Lock()


def default_ledger() -> CompileLedger:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CompileLedger()
        return _DEFAULT
