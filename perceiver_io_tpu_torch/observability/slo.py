"""SLO telemetry: latency/error targets, multi-window burn-rate
monitoring, and the shared goodput-under-SLO accounting.

Serving quality on TPU pods is judged by latency-percentile SLOs under an
offered-load sweep — p95 time-to-first-token (TTFT) and p95 inter-token
latency (ITL) vs offered load — not by raw tokens/s (PAPERS.md: the
Gemma-on-TPU serving comparison). Both engines record the raw samples
(``serving_ttft_ms`` / ``serving_inter_token_ms`` histograms plus a
``serving.first_token`` event per request trace; docs/observability.md);
this module turns those samples into an *operational* signal:

- :class:`SLOPolicy` — the targets: p95 TTFT, p95 ITL, error rate.
- :class:`SLOMonitor` — a multi-window burn-rate evaluator (the SRE
  fast+slow window pattern): each observation is classified good/bad
  against its target, and per window the **burn rate** is
  ``bad_fraction / error_budget`` (budget = 5% for a p95 target, the
  policy's ``error_rate`` for dispositions). A dimension **breaches**
  when BOTH windows burn above ``breach_burn_rate`` — the fast window
  proves the problem is current, the slow window proves it is sustained,
  so a single blip can neither trip nor instantly clear the alarm. On
  breach the monitor increments ``slo_breach_total``, emits an
  ``slo.breach`` span event, arms the serving
  :class:`~perceiver_io_tpu_torch.observability.ProfilerTrigger` (a breach is
  exactly the moment a capture pays for itself), and — through
  :attr:`SLOMonitor.breached` — tightens
  :class:`~perceiver_io_tpu_torch.serving.FleetRouter` admission
  (``max_pending`` / deadline shedding scale down by ``slo_shed_factor``
  while the burn lasts; docs/serving.md). Recovery is fast-window-driven:
  once fresh samples burn below threshold the dimension recovers
  (``slo.recover`` event, ``slo_recoveries_total``).
- :func:`offered_load` / :func:`goodput_ratio` — the ONE definition of
  the goodput denominator, shared by ``bench.py``'s ``extras.fleet_chaos``
  and ``extras.slo_goodput`` probes and the ``obs report`` SLO section:
  offered load is *everything the callers asked for* (accepted + shed +
  rejected), so an engine that sheds half its traffic cannot report
  goodput 1.0.

Everything runs on an injectable clock and is stdlib-only, so drills
compose with :class:`~perceiver_io_tpu_torch.reliability.FakeClock` like the
rest of the registry and replay bit-identically (tests/test_slo.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

#: the registry histogram names the engines record token latency under —
#: also the names :meth:`SLOMonitor.sink` routes on (engine ``latency_sink``
#: compatibility)
TTFT_METRIC = "serving_ttft_ms"
INTER_TOKEN_METRIC = "serving_inter_token_ms"

#: error budget implied by a p95 latency target: 5% of samples may miss it
_P95_BUDGET = 0.05


# -- shared goodput accounting ----------------------------------------------
def offered_load(counts: Mapping[str, float], prefix: str = "serving") -> int:
    """The goodput DENOMINATOR: every request the callers offered —
    accepted (``*_requests_submitted_total``) plus shed plus rejected.
    ``prefix`` selects the counter family (``serving`` or ``fleet``)."""
    return int(
        counts.get(f"{prefix}_requests_submitted_total", 0)
        + counts.get(f"{prefix}_requests_shed_total", 0)
        + counts.get(f"{prefix}_requests_rejected_total", 0)
    )


def goodput_ratio(counts: Mapping[str, float], prefix: str = "serving") -> float:
    """Completed / offered (:func:`offered_load`) — the one shared
    definition, so the bench probes cannot drift on the denominator."""
    return (
        counts.get(f"{prefix}_requests_completed_total", 0)
        / max(1, offered_load(counts, prefix))
    )


@dataclasses.dataclass
class SLOPolicy:
    """The serving-quality targets a deployment promises. ``None`` disables
    that dimension; at least one target must be set to build a monitor.

    :param ttft_p95_ms: p95 time-to-first-token target (``serving_ttft_ms``).
    :param inter_token_p95_ms: p95 inter-token latency target
        (``serving_inter_token_ms``).
    :param error_rate: max fraction of dispositions that may be non-ok
        (failed + timed_out + shed), e.g. ``0.01`` for 99% success.
    """

    ttft_p95_ms: Optional[float] = None
    inter_token_p95_ms: Optional[float] = None
    error_rate: Optional[float] = None

    def dimensions(self) -> List[Tuple[str, float]]:
        """``(name, error_budget)`` per configured dimension."""
        dims = []
        if self.ttft_p95_ms is not None:
            dims.append(("ttft", _P95_BUDGET))
        if self.inter_token_p95_ms is not None:
            dims.append(("inter_token", _P95_BUDGET))
        if self.error_rate is not None:
            if not 0.0 < self.error_rate < 1.0:
                raise ValueError(
                    f"error_rate must be in (0, 1), got {self.error_rate}"
                )
            dims.append(("error", self.error_rate))
        if not dims:
            raise ValueError(
                "SLOPolicy needs at least one target (ttft_p95_ms / "
                "inter_token_p95_ms / error_rate)"
            )
        return dims


@dataclasses.dataclass
class SLOArgs:
    """The CLI's ``--obs.slo.*`` flag sub-group (docs/observability.md):
    targets plus monitor knobs. All targets default to off — the monitor
    is only built when at least one target is set, matching the rest of
    the ``--obs.*`` group's off-by-default contract."""

    #: p95 time-to-first-token target in ms (None = dimension off)
    ttft_p95_ms: Optional[float] = None
    #: p95 inter-token latency target in ms (None = dimension off)
    inter_token_p95_ms: Optional[float] = None
    #: max non-ok disposition fraction, e.g. 0.01 (None = dimension off)
    error_rate: Optional[float] = None
    #: the two burn windows, seconds
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    #: both windows must burn at or above this to breach
    burn_rate: float = 2.0
    #: fleet admission multiplier while breached (``--serve.replicas > 1``)
    shed_factor: float = 0.5

    @property
    def enabled(self) -> bool:
        return (
            self.ttft_p95_ms is not None
            or self.inter_token_p95_ms is not None
            or self.error_rate is not None
        )

    def policy(self) -> SLOPolicy:
        return SLOPolicy(
            ttft_p95_ms=self.ttft_p95_ms,
            inter_token_p95_ms=self.inter_token_p95_ms,
            error_rate=self.error_rate,
        )


class _Window:
    """One dimension's observation log, evaluated over the trailing fast
    and slow windows with INCREMENTAL accounting: each window keeps its own
    deque of ``(t, bad)`` plus running sample/bad counts, so a poll pays
    only for the entries that aged out since the last one — O(1) amortized
    per observation, not a rescan of the slow window per engine step.
    Deterministic on the injectable clock, no sampling."""

    __slots__ = ("_fast", "_slow", "fast_n", "fast_bad", "slow_n", "slow_bad")

    def __init__(self):
        self._fast: deque = deque()
        self._slow: deque = deque()
        self.fast_n = self.fast_bad = 0
        self.slow_n = self.slow_bad = 0

    def observe(self, t: float, bad: bool) -> None:
        entry = (t, bad)
        self._fast.append(entry)
        self._slow.append(entry)
        self.fast_n += 1
        self.slow_n += 1
        if bad:
            self.fast_bad += 1
            self.slow_bad += 1

    def evict(self, now: float, fast_window_s: float, slow_window_s: float) -> None:
        for events, cutoff, n_attr, bad_attr in (
            (self._fast, now - fast_window_s, "fast_n", "fast_bad"),
            (self._slow, now - slow_window_s, "slow_n", "slow_bad"),
        ):
            while events and events[0][0] < cutoff:
                _, was_bad = events.popleft()
                setattr(self, n_attr, getattr(self, n_attr) - 1)
                if was_bad:
                    setattr(self, bad_attr, getattr(self, bad_attr) - 1)

    def burns(self, budget: float) -> Tuple[float, int, float]:
        """``(fast burn, fast sample count, slow burn)`` from the running
        counts (call :meth:`evict` first)."""
        fast = 0.0 if self.fast_n == 0 else (self.fast_bad / self.fast_n) / budget
        slow = 0.0 if self.slow_n == 0 else (self.slow_bad / self.slow_n) / budget
        return fast, self.fast_n, slow


class SLOMonitor:
    """Multi-window burn-rate evaluator over the policy's dimensions
    (module docstring for the breach semantics).

    :param policy: the targets.
    :param clock: monotonic time source — pass the engine/fleet's
        :class:`~perceiver_io_tpu_torch.reliability.FakeClock` in drills so the
        windows advance deterministically.
    :param registry: where ``slo_burn_rate*`` gauges and
        ``slo_breach_total`` / ``slo_recoveries_total`` counters live
        (usually the same registry the serving histograms are on).
    :param tracer: optional — emits ``slo.breach`` / ``slo.recover`` span
        events.
    :param profiler_trigger: optional
        :class:`~perceiver_io_tpu_torch.observability.ProfilerTrigger`; a breach
        arms it so the next device dispatch is captured.
    :param fast_window_s / slow_window_s: the two burn windows.
    :param breach_burn_rate: both windows must burn at or above this to
        breach (1.0 = burning the budget exactly; 2.0 = at double rate).
    :param min_samples: fewest fast-window samples that can support a
        breach — one bad observation in an idle window is a blip, not an
        outage.
    """

    def __init__(self, policy: SLOPolicy, *,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, tracer=None, profiler_trigger=None,
                 flight_recorder=None,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 breach_burn_rate: float = 2.0, min_samples: int = 5):
        if fast_window_s <= 0 or slow_window_s <= 0:
            raise ValueError("burn windows must be > 0 seconds")
        if fast_window_s > slow_window_s:
            raise ValueError(
                f"fast_window_s={fast_window_s} must not exceed "
                f"slow_window_s={slow_window_s}"
            )
        if breach_burn_rate <= 0:
            raise ValueError(f"breach_burn_rate must be > 0, got {breach_burn_rate}")
        self.policy = policy
        self._dims: Dict[str, float] = dict(policy.dimensions())
        self._clock = clock
        self.registry = registry
        self.tracer = tracer
        self.profiler_trigger = profiler_trigger
        #: optional :class:`~perceiver_io_tpu_torch.observability.FlightRecorder`
        #: — a breach transition dumps an incident bundle (cooldown- and
        #: budget-gated by the recorder), the same "a breach is the moment
        #: a capture pays for itself" stance as the profiler-trigger arm
        self.flight_recorder = flight_recorder
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.breach_burn_rate = float(breach_burn_rate)
        self.min_samples = int(min_samples)
        self._windows: Dict[str, _Window] = {d: _Window() for d in self._dims}
        self._breached: Dict[str, bool] = {d: False for d in self._dims}
        self._burn: Dict[str, Tuple[float, float]] = {
            d: (0.0, 0.0) for d in self._dims
        }
        self._counter_source: Optional[Callable[[], Mapping[str, float]]] = None
        self._counter_prefix = "serving"
        self._counter_seen: Dict[str, float] = {}
        if registry is not None:
            registry.declare_counters("slo_breach_total", "slo_recoveries_total")

    # -- feeds ---------------------------------------------------------------
    def sink(self, name: str, value_ms: float) -> None:
        """Engine ``latency_sink``-compatible feed: routes the two token
        histogram names onto their dimensions; other names are ignored (the
        engine mirrors every token-latency observation here)."""
        if name == TTFT_METRIC:
            self.observe_ttft(value_ms)
        elif name == INTER_TOKEN_METRIC:
            self.observe_inter_token(value_ms)

    def observe_ttft(self, value_ms: float) -> None:
        target = self.policy.ttft_p95_ms
        if target is not None:
            self._windows["ttft"].observe(self._clock(), value_ms > target)

    def observe_inter_token(self, value_ms: float) -> None:
        target = self.policy.inter_token_p95_ms
        if target is not None:
            self._windows["inter_token"].observe(self._clock(), value_ms > target)

    def observe_request(self, ok: bool) -> None:
        """One terminal disposition for the error-rate dimension (bad =
        failed / timed_out / shed)."""
        if "error" in self._windows:
            self._windows["error"].observe(self._clock(), not ok)

    def watch_counters(self, source: Callable[[], Mapping[str, float]],
                       prefix: str = "serving") -> None:
        """Feed the error dimension from a registry's cumulative counters:
        each :meth:`poll` diffs ``{prefix}_requests_{completed,failed,
        timed_out,shed}_total`` against the last poll and records the delta
        as that many dispositions — so a caller that never sees individual
        requests (the serve CLI drain loop, the fleet router) still
        evaluates the error SLO."""
        self._counter_source = source
        self._counter_prefix = prefix
        self._counter_seen = {}

    def _pull_counters(self) -> None:
        if self._counter_source is None or "error" not in self._windows:
            return
        counts = self._counter_source()
        p = self._counter_prefix

        def delta(key: str) -> int:
            now_v = float(counts.get(key, 0.0))
            d = int(now_v - self._counter_seen.get(key, 0.0))
            self._counter_seen[key] = now_v
            return max(0, d)

        # Sheds caused by the breach's OWN admission tightening
        # (fleet_slo_shed_total, double-counted in the ordinary shed
        # counter) are excluded from the error feed: counting them would
        # close a feedback loop — tightening sheds load, the sheds burn the
        # error budget, the burn sustains the breach that tightened — and
        # the breach could never recover while any load persists.
        slo_sheds = delta(f"{p}_slo_shed_total")
        for key, ok, exclude in (
            (f"{p}_requests_completed_total", True, 0),
            (f"{p}_requests_failed_total", False, 0),
            (f"{p}_requests_timed_out_total", False, 0),
            (f"{p}_requests_shed_total", False, slo_sheds),
        ):
            for _ in range(max(0, delta(key) - exclude)):
                self.observe_request(ok)

    # -- evaluation ----------------------------------------------------------
    @property
    def breached(self) -> bool:
        """True while ANY dimension is in breach (as of the last
        :meth:`poll`) — the bit fleet admission tightens on."""
        return any(self._breached.values())

    @property
    def active_breaches(self) -> List[str]:
        return sorted(d for d, b in self._breached.items() if b)

    def poll(self) -> dict:
        """Evaluate every dimension's fast/slow burn, publish gauges, and
        run the breach/recovery transitions. Call it from the serving drive
        loop (the serve CLI per drain pass; the fleet router per step) —
        evaluation is O(window events), far off the per-token path."""
        self._pull_counters()
        now = self._clock()
        worst = 0.0
        out: Dict[str, dict] = {}
        for dim, budget in self._dims.items():
            window = self._windows[dim]
            window.evict(now, self.fast_window_s, self.slow_window_s)
            fast, fast_n, slow = window.burns(budget)
            self._burn[dim] = (fast, slow)
            # the sustained burn: what BOTH windows agree on
            worst = max(worst, min(fast, slow))
            if self.registry is not None:
                self.registry.set_gauge(f"slo_burn_rate_{dim}_fast", round(fast, 4))
                self.registry.set_gauge(f"slo_burn_rate_{dim}_slow", round(slow, 4))
            breaching = (
                fast >= self.breach_burn_rate
                and slow >= self.breach_burn_rate
                and fast_n >= self.min_samples
            )
            if breaching and not self._breached[dim]:
                self._breached[dim] = True
                if self.registry is not None:
                    self.registry.inc("slo_breach_total")
                    self.registry.inc(f"slo_breach_{dim}_total")
                if self.tracer is not None:
                    self.tracer.event(
                        "slo.breach", dimension=dim,
                        burn_fast=round(fast, 4), burn_slow=round(slow, 4),
                    )
                if self.profiler_trigger is not None:
                    self.profiler_trigger.arm()
                if self.flight_recorder is not None:
                    self.flight_recorder.trigger(
                        "slo_breach",
                        f"SLO {dim} breach: burn fast={fast:.2f} "
                        f"slow={slow:.2f} (threshold "
                        f"{self.breach_burn_rate})",
                        dimension=dim, burn_fast=round(fast, 4),
                        burn_slow=round(slow, 4),
                    )
            elif (
                self._breached[dim]
                and fast < self.breach_burn_rate
                and fast_n >= self.min_samples
            ):
                # fast-window recovery: fresh samples prove health NOW; the
                # slow window may stay hot for its whole span, and holding
                # tightened admission that long would turn one incident
                # into a self-inflicted outage. Symmetric with the breach
                # guard, recovery also needs min_samples of EVIDENCE — an
                # empty fast window is a stalled system (no tokens, no
                # dispositions), not a healthy one, and must not read as
                # recovered mid-outage.
                self._breached[dim] = False
                if self.registry is not None:
                    self.registry.inc("slo_recoveries_total")
                if self.tracer is not None:
                    self.tracer.event(
                        "slo.recover", dimension=dim, burn_fast=round(fast, 4),
                    )
            out[dim] = {
                "burn_fast": round(fast, 4), "burn_slow": round(slow, 4),
                "breached": self._breached[dim], "samples_fast": fast_n,
            }
        if self.registry is not None:
            self.registry.set_gauge("slo_burn_rate", round(worst, 4))
        return out

    def stats(self) -> dict:
        """JSON-able snapshot for ``serve_stats`` / bench records."""
        return {
            "policy": dataclasses.asdict(self.policy),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "breach_burn_rate": self.breach_burn_rate,
            "breached": self.breached,
            "active_breaches": self.active_breaches,
            "burn_rates": {
                d: {"fast": round(f, 4), "slow": round(s, 4)}
                for d, (f, s) in sorted(self._burn.items())
            },
            "breaches": (
                int(self.registry.counter("slo_breach_total"))
                if self.registry is not None else None
            ),
        }
