"""Supervised serving fleet: replica health, failover and exactly-once
request recovery. Counterpart of ``perceiver_io_tpu/serving/fleet.py``;
host code only, copied so that the port imports nothing of the JAX package.

A :class:`FleetRouter` owns N engine replicas (either engine, each on the
card unless its factory asks for the CPU by name) behind a common
:class:`Replica` wrapper, dispatches by load, and supervises them:

- **Failure detection.** Every ``Replica.step`` is supervised: a raised
  exception is a **crash** (the replica is rebuilt from its factory, the
  process-restart model: the old engine, its KV pool and device state are
  dropped), a step whose wall time on the injectable clock reaches
  ``step_timeout_s`` is **hung**. The slot engine's step ends in the host
  read of its tokens, so a step's wall time covers the device's work.
  Detection is post hoc and in line: the single-threaded router measures a
  step after it returns. Both are chaos-scriptable at the
  ``fleet.replica_step.<r>`` and ``fleet.dispatch`` sites
  (:mod:`~perceiver_io_tpu_torch.reliability.chaos`).
- **Circuit breaker** per replica: ``closed -> open`` after
  ``breaker_threshold`` consecutive failures, ``open -> half_open`` after
  ``breaker_cooldown_s``, ``half_open -> closed`` on a clean probe step (one
  probe request at a time) and back to ``open`` on a failed one. An open
  replica gets no dispatches and is not stepped.
- **Exactly-once recovery.** A failed replica's in-flight requests are
  re-queued (``fleet_failover_total`` / ``fleet_redispatch_total``) and
  replayed from their prompts on a survivor, with backoff from a
  :class:`~perceiver_io_tpu_torch.reliability.RetryPolicy`. The first copy
  to finish wins; late duplicates are counted
  (``fleet_duplicate_results_total``) and dropped. Greedy decoding keeps
  each slot row independent, so a recovered output equals the no-fault
  run's tokens.
- **Fleet admission**: ``max_pending`` (:class:`QueueFull` past it),
  ``default_deadline_s``, and the engines' ``check_feasible`` at the front
  door; an SLO monitor's breach tightens both by ``slo_shed_factor``.
- **Operations and elasticity**: ``drain()``, ``rolling_restart()``,
  ``add_replica()`` and ``remove_replica()`` (the victim's work replays on
  survivors and its engine is evacuated, every pool page returning tagged
  ``scale_down``), chaos-scriptable at ``fleet.scale_up`` and
  ``fleet.scale_down`` and driven by the
  :class:`~perceiver_io_tpu_torch.serving.autoscaler.FleetAutoscaler`,
  polled once per :meth:`FleetRouter.step`. Replicas are keyed by
  ``replica_id``, never by position.

The router mirrors the engines' request surface (``submit``, ``serve``,
``step``, ``pending``, ``cancel``, ``run_until_idle``, ``drain``,
``warmup``, ``stats``, ``health``), so the serve CLI and the gateway drive
a fleet as they drive one engine. Telemetry: the ``fleet_*`` counters of
:data:`FLEET_COUNTERS` declared up front, ``fleet_replicas_healthy`` and
the other gauges, ``fleet_request_latency_ms``, fleet-scope
``serving_ttft_ms`` / ``serving_inter_token_ms`` mirrored from every
replica, one terminal ``fleet.request`` span per submission, and the
flight recorder's ``replica_failure`` and ``breaker_open`` triggers.

The router, every breaker and every replica engine share one clock (the
factories close over it). Where JAX's ``Replica.restart`` releases a
sharded replica's mesh group first, the port has no serving mesh
(``ROADMAP.md`` A.6).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_tpu_torch.inference.generate import GenerationConfig
from perceiver_io_tpu_torch.observability import MetricsRegistry, Tracer
from perceiver_io_tpu_torch.reliability import QueueFull, RetryPolicy

#: counters declared at construction so exports show the full fleet schema
#: before the first failure (docs/observability.md)
FLEET_COUNTERS = (
    "fleet_requests_submitted_total",
    "fleet_requests_completed_total",
    "fleet_requests_shed_total",
    "fleet_requests_timed_out_total",
    "fleet_requests_failed_total",
    "fleet_requests_rejected_total",
    "fleet_requests_cancelled_total",
    "fleet_dispatch_total",
    "fleet_failover_total",
    "fleet_redispatch_total",
    "fleet_breaker_open_total",
    "fleet_replica_failures_total",
    "fleet_replica_restarts_total",
    "fleet_duplicate_results_total",
    "fleet_slo_shed_total",
    "fleet_scale_up_total",
    "fleet_scale_down_total",
    "fleet_scale_up_failed_total",
)


@dataclasses.dataclass
class FleetRequest:
    """One fleet-level request: the durable identity that survives replica
    failures. ``status`` is ``queued`` (awaiting dispatch, possibly gated by
    redispatch backoff) or ``dispatched`` (an engine copy is in flight)
    until the terminal disposition: ``ok`` / ``timed_out`` / ``failed``.
    ``replica_id`` is the replica whose copy completed it (None until
    then); ``dispatches`` counts dispatch attempts — 1 for an undisturbed
    request, more after failover."""

    request_id: int
    prompt: np.ndarray  # (len,) int32, unpadded
    config: Optional[GenerationConfig]
    submitted_at: float
    deadline_at: Optional[float] = None
    status: str = "queued"  # queued | dispatched | ok | timed_out | failed
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    trace_id: Optional[str] = None
    replica_id: Optional[int] = None
    dispatches: int = 0
    not_before: float = 0.0  # redispatch backoff gate, fleet-clock seconds
    #: replica the last failed attempt ran on — the re-dispatch AVOIDS it
    #: when any other replica is available, so a retry never bounces
    #: straight back onto the executor that just failed it
    last_replica_id: Optional[int] = None
    #: TTFT anchor handed through to the engine at dispatch (the HTTP
    #: gateway passes its socket-accept instant); defaults to the fleet's
    #: own ``submitted_at`` — see ``serving.engine.ServeRequest``
    ttft_anchor_s: Optional[float] = None
    #: per-request incremental token sink, forwarded to the engine copy at
    #: every dispatch (failover replays re-fire indices from 0; greedy
    #: determinism makes the replayed prefix identical, so stream
    #: consumers dedupe by index — docs/serving.md "Streaming")
    on_token: Optional[Callable[[int, int], None]] = None
    #: scheduling tier + tenant label, forwarded to the engine copy at
    #: every dispatch (docs/serving.md "Preemption & priorities"): the
    #: fleet dispatches higher tiers first, and a preemption-enabled slot
    #: engine uses them for victim selection + per-tenant page fairness
    priority: int = 0
    tenant: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.status not in ("queued", "dispatched")


class CircuitBreaker:
    """Per-replica circuit breaker: ``closed → open → half_open → closed``.

    ``record_failure`` opens after ``failure_threshold`` *consecutive*
    failures (or instantly from half-open — a failed probe); ``poll``
    advances ``open → half_open`` once ``cooldown_s`` has elapsed on the
    injectable clock; ``record_success`` resets the failure run and closes
    a half-open breaker. Pure host-side state on an injectable clock, so
    every transition is deterministic under ``reliability.FakeClock``.
    """

    def __init__(self, *, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"  # closed | open | half_open
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.opened_total = 0

    def record_failure(self) -> bool:
        """Count one failure; returns True when THIS call opened the
        breaker (a half-open probe failure re-opens it and counts again)."""
        self.consecutive_failures += 1
        if self.state == "half_open" or (
            self.state == "closed"
            and self.consecutive_failures >= self.failure_threshold
        ):
            self.state = "open"
            self.opened_at = self._clock()
            self.opened_total += 1
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == "half_open":
            self.state = "closed"
            self.opened_at = None

    def poll(self) -> str:
        """Current state, advancing ``open → half_open`` when the cooldown
        has elapsed — the reintegration-probe gate."""
        if (
            self.state == "open"
            and self._clock() - self.opened_at >= self.cooldown_s
        ):
            self.state = "half_open"
        return self.state


class Replica:
    """One supervised engine replica: the engine (rebuilt from ``factory``
    on crash), its circuit breaker, the fleet-request-id → engine-handle
    map, and the chaos-scriptable supervised ``step``.

    Works over either engine — :class:`~..engine.ServingEngine` or
    :class:`~..slots.SlotServingEngine` — through the shared request
    surface and health schema (``serving.engine.HEALTH_KEYS``).
    """

    def __init__(self, factory: Callable[[], object], replica_id: int, *,
                 clock: Callable[[], float] = time.monotonic, chaos=None,
                 breaker: Optional[CircuitBreaker] = None,
                 latency_mirror: Optional[Callable[[str, float], None]] = None):
        self.factory = factory
        self.replica_id = int(replica_id)
        self._clock = clock
        self._chaos = chaos
        #: installed as the engine's ``latency_sink`` (rebuilds included):
        #: every per-token TTFT / inter-token observation the replica's
        #: engine records on its PRIVATE registry is mirrored here too, so
        #: the router gets fleet-scope ``serving_ttft_ms`` /
        #: ``serving_inter_token_ms`` percentiles (and the SLO monitor its
        #: samples) without collapsing the per-replica attribution
        self.latency_mirror = latency_mirror
        self.breaker = breaker if breaker is not None else CircuitBreaker(clock=clock)
        self.engine = factory()
        self._install_latency_mirror()
        #: fleet request id -> engine ServeRequest handle. Entries persist
        #: across a HUNG failover (the slow copy may still complete — the
        #: dedupe path) and are cleared by :meth:`restart` (a crashed
        #: process loses its work).
        self.handles: Dict[int, object] = {}
        self.restarts = 0
        self.draining = False
        self.last_step_wall_s = 0.0

    @property
    def chaos_site(self) -> str:
        return f"fleet.replica_step.{self.replica_id}"

    def step(self) -> int:
        """One supervised engine step. The ``fleet.replica_step.<r>`` chaos
        hook fires first: ``error`` raises (a scripted crash — the router
        catches it), ``hang`` advances the shared injectable clock by
        ``delay_s`` so the step's wall time trips the router's
        ``step_timeout_s`` (resident deadlines burn through the stall too,
        exactly as they would on a real wedged replica)."""
        t0 = self._clock()
        if self._chaos is not None:
            fault = self._chaos.hit(self.chaos_site)
            if fault is not None:
                if fault.kind == "error":
                    raise fault.make_error()
                if fault.kind == "hang":
                    advance = getattr(self._clock, "advance", None)
                    if advance is not None:
                        advance(fault.delay_s)
        disposed = self.engine.step()
        self.last_step_wall_s = self._clock() - t0
        return disposed

    def _install_latency_mirror(self) -> None:
        if self.latency_mirror is not None and hasattr(self.engine, "latency_sink"):
            self.engine.latency_sink = self.latency_mirror

    def restart(self) -> None:
        """Rebuild the engine from the factory — the crashed-process model:
        queued and resident engine work is lost (the router already failed
        it over), and the old engine, its KV pool and device state go with
        it (nothing else holds the engine). The crashed engine stays
        installed until the factory returns, so a spawn failure leaves the
        replica degraded-but-present, never holding ``engine=None``."""
        self.engine = self.factory()
        self._install_latency_mirror()
        self.handles.clear()
        self.restarts += 1

    def collect(self) -> List[Tuple[int, object]]:
        """Pop and return every finished ``(fleet_request_id, handle)``."""
        done = [(fid, h) for fid, h in self.handles.items() if h.done]
        for fid, _ in done:
            del self.handles[fid]
        return done

    def health(self) -> dict:
        """The engine's health snapshot (shared schema,
        ``serving.engine.HEALTH_KEYS``) plus the supervision fields the
        router adds — a strict superset, so anything that can probe an
        engine can probe a replica."""
        out = self.engine.health()
        out.update({
            "replica_id": self.replica_id,
            "breaker": self.breaker.state,
            "consecutive_failures": self.breaker.consecutive_failures,
            "in_flight": len(self.handles),
            "restarts": self.restarts,
            "draining": self.draining,
        })
        return out


class FleetRouter:
    """Load-aware router + supervisor over N engine replicas (module
    docstring for the full design).

    :param engine_factories: one zero-arg engine factory per replica
        (``[make_engine] * n`` for a homogeneous fleet). Factories are
        re-invoked to rebuild crashed replicas, must build engines sharing
        the fleet ``clock``, and should build engines WITHOUT their own
        ``max_queue``/``default_deadline_s`` — admission is fleet-level.
        Each factory builds its engine on the card unless it names the
        CPU; the kernels are built once per process (``_build.py``), so a
        rebuild or a spawn only allocates a new state and pool.
    :param clock: the fleet's (and every breaker's) monotonic time source.
    :param chaos: optional :class:`~perceiver_io_tpu_torch.reliability.ChaosRegistry`
        consulted at ``fleet.dispatch`` / ``fleet.replica_step.<r>``.
    :param registry: metrics registry for the ``fleet_*`` families;
        defaults to a private one.
    :param tracer: optional span tracer — one terminal ``fleet.request``
        span per submission (replica id attached), ``fleet.dispatch`` /
        ``fleet.replica_failed`` / ``fleet.breaker_*`` events.
    :param max_pending: fleet-wide bound on queued + dispatched requests;
        ``submit`` past it sheds with :class:`QueueFull`.
    :param default_deadline_s: fleet-level deadline; the remaining budget
        is handed to the engine at dispatch time, so replicas enforce it
        token-granularly.
    :param step_timeout_s: wall-time deadline on one supervised replica
        step; a slower step marks the replica hung. None disables hang
        detection (the default: a first step that builds the kernels
        would otherwise trip it).
    :param failover: re-dispatch a failed replica's in-flight requests
        (True) or fail them terminally (False — the single-engine
        behavior).
    :param breaker_threshold / breaker_cooldown_s: circuit-breaker knobs,
        applied per replica.
    :param redispatch_policy: backoff between a request's dispatch
        attempts; its ``max_retries`` bounds failovers per request. The
        default retries 3 times immediately; set ``jitter`` + the policy's
        base to spread a redispatch storm (``redispatch_seed`` feeds the
        deterministic rng).
    :param slo_monitor: optional
        :class:`~perceiver_io_tpu_torch.observability.slo.SLOMonitor` — the
        telemetry-driven admission loop (docs/observability.md). The
        router feeds it: every replica's per-token TTFT / inter-token
        observations (via the latency mirror) and the fleet's terminal
        dispositions (via ``watch_counters`` over the fleet registry), and
        polls it once per :meth:`step`. While the monitor reports a
        breach, admission TIGHTENS deterministically: the effective
        ``max_pending`` and default deadline scale by ``slo_shed_factor``,
        so sustained burn sheds load at the front door instead of letting
        the queue push latency further past target. Extra sheds caused by
        the tightened bound are counted ``fleet_slo_shed_total`` (they
        also count in the ordinary shed counter).
    :param slo_shed_factor: the tightening multiplier in ``(0, 1]``.
    """

    def __init__(self, engine_factories: Sequence[Callable[[], object]], *,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 max_pending: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 step_timeout_s: Optional[float] = None,
                 failover: bool = True,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 redispatch_policy: Optional[RetryPolicy] = None,
                 redispatch_seed: int = 0,
                 slo_monitor=None,
                 slo_shed_factor: float = 0.5,
                 flight_recorder=None):
        factories = list(engine_factories)
        if not factories:
            raise ValueError("a fleet needs at least one engine factory")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if step_timeout_s is not None and step_timeout_s <= 0:
            raise ValueError(f"step_timeout_s must be > 0, got {step_timeout_s}")
        self._clock = clock
        self._chaos = chaos
        self.registry = registry if registry is not None else MetricsRegistry(clock=clock)
        self.tracer = tracer
        self.max_pending = max_pending
        self.default_deadline_s = default_deadline_s
        self.step_timeout_s = step_timeout_s
        self.failover = bool(failover)
        self.redispatch_policy = (
            redispatch_policy if redispatch_policy is not None
            else RetryPolicy(max_retries=3, backoff_base_s=0.0)
        )
        if not 0.0 < slo_shed_factor <= 1.0:
            raise ValueError(
                f"slo_shed_factor must be in (0, 1], got {slo_shed_factor}"
            )
        self.slo_monitor = slo_monitor
        self.slo_shed_factor = float(slo_shed_factor)
        #: optional incident
        #: :class:`~perceiver_io_tpu_torch.observability.FlightRecorder`
        #: (docs/observability.md "Flight recorder & incident bundles"):
        #: a replica failure or a breaker opening dumps a bounded bundle
        #: with the victims' trace ids attached — the moments the span
        #: firehose alone cannot reconstruct after sampling
        self.flight_recorder = flight_recorder
        self._rng = random.Random(redispatch_seed)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        #: the factory scale-up spawns from when none is passed explicitly
        #: (a homogeneous fleet's one factory)
        self._default_factory = factories[0]
        #: replicas keyed by replica_id — NEVER by list position: ids are
        #: handed out monotonically and survive removals, so per-replica
        #: bookkeeping (dispatch maps, completion attribution, chaos sites)
        #: stays correct while the autoscaler adds/retires replicas mid-run
        self._replicas: Dict[int, Replica] = {}
        self._next_replica_id = 0
        #: optional :class:`~perceiver_io_tpu_torch.serving.autoscaler.FleetAutoscaler`
        #: polled once per :meth:`step` (the autoscaler's ctor installs it)
        self.autoscaler = None
        for f in factories:
            self._spawn_replica(f)
        if slo_monitor is not None:
            # error-rate dimension: fed from the fleet's own disposition
            # counters, diffed per poll — the router never sees engine
            # tokens, but it IS the one source of terminal fleet states
            slo_monitor.watch_counters(self.registry.counters, prefix="fleet")
        self._queue: List[FleetRequest] = []
        self._dispatched: Dict[int, FleetRequest] = {}
        #: every non-terminal request (queued OR dispatched), by id — the
        #: dedupe lookup: a completed engine copy must find its fleet
        #: request even while it sits re-queued behind a redispatch
        #: backoff gate, or a first-copy-wins completion would be dropped
        #: as a duplicate and replayed for nothing
        self._inflight: Dict[int, FleetRequest] = {}
        self._next_id = 0
        self._accepting = True
        self._last_step_activity = False
        self._completed_by_replica: Dict[int, int] = {
            r.replica_id: 0 for r in self._replicas.values()
        }
        self.registry.declare_counters(*FLEET_COUNTERS)
        self._update_gauges()

    @property
    def replicas(self) -> List[Replica]:
        """Live replicas in ``replica_id`` order (ids are monotonic, so
        this is also spawn order)."""
        return [self._replicas[rid] for rid in sorted(self._replicas)]

    def _spawn_replica(self, factory: Callable[[], object]) -> Replica:
        """Build one replica on the next monotonic id (ids are never
        reused: a chaos script or span keyed ``fleet.replica_step.<r>``
        must stay unambiguous across scale churn)."""
        rid = self._next_replica_id
        self._next_replica_id += 1
        replica = Replica(
            factory, rid, clock=self._clock, chaos=self._chaos,
            breaker=CircuitBreaker(
                failure_threshold=self._breaker_threshold,
                cooldown_s=self._breaker_cooldown_s, clock=self._clock,
            ),
            latency_mirror=self._mirror_token_latency,
        )
        self._replicas[rid] = replica
        return replica

    @property
    def last_step_made_progress(self) -> bool:
        """False when the most recent :meth:`step` found nothing steppable
        (every replica open/idle) — drive loops use it to yield instead of
        hot-spinning on breaker cooldowns (the serve CLI does)."""
        return self._last_step_activity

    def _mirror_token_latency(self, name: str, value_ms: float) -> None:
        """Every replica engine's ``latency_sink``: fleet-scope TTFT / ITL
        histograms on the router registry, plus the SLO monitor's latency
        dimensions (docs/observability.md — engine, replica, and fleet
        scope are three registries observing the same samples)."""
        self.registry.observe(name, value_ms)
        if self.slo_monitor is not None:
            self.slo_monitor.sink(name, value_ms)

    def _effective_admission(self) -> Tuple[Optional[int], Optional[float]]:
        """``(max_pending, default_deadline_s)`` as currently enforced:
        the configured bounds, scaled by ``slo_shed_factor`` while the SLO
        monitor reports a breach — telemetry-driven shedding, deterministic
        because the monitor's windows run on the injectable clock."""
        limit, deadline = self.max_pending, self.default_deadline_s
        if self.slo_monitor is not None and self.slo_monitor.breached:
            if limit is not None:
                limit = max(1, int(limit * self.slo_shed_factor))
            if deadline is not None:
                deadline = deadline * self.slo_shed_factor
        return limit, deadline

    # -- queue front --------------------------------------------------------
    def submit(self, prompt, config: Optional[GenerationConfig] = None,
               *, deadline_s: Optional[float] = None,
               ttft_anchor_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               priority: int = 0, tenant: Optional[str] = None
               ) -> FleetRequest:
        """Enqueue one prompt fleet-wide; returns its durable handle.

        Mirrors the engine contract: ``ValueError`` for prompts no replica
        could ever serve (validated via the engines' shared
        ``check_feasible``, so slot-engine scope limits apply fleet-wide),
        :class:`QueueFull` past ``max_pending`` — both carry a
        ``trace_id`` and a terminal span, like the engines' rejections.
        While the SLO monitor reports a sustained burn, the effective
        ``max_pending`` and default deadline are tightened by
        ``slo_shed_factor`` (:meth:`_effective_admission`).
        ``ttft_anchor_s`` / ``on_token`` / ``priority`` / ``tenant`` are
        handed to the engine copy at every dispatch (:class:`FleetRequest`);
        higher-priority requests dispatch first, and a preemption-enabled
        slot engine uses the tier + tenant for victim selection
        (docs/serving.md "Preemption & priorities").
        """
        if not self._accepting:
            raise RuntimeError("fleet is draining; new submissions rejected")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        try:
            self.replicas[0].engine.check_feasible(prompt, config)
        except ValueError as e:
            self.registry.inc("fleet_requests_rejected_total")
            e.trace_id = self._terminal_event("rejected", error=str(e))
            raise
        max_pending, default_deadline_s = self._effective_admission()
        in_flight = len(self._queue) + len(self._dispatched)
        if max_pending is not None and in_flight >= max_pending:
            # a shed is attributed to the SLO tightening only when the
            # CONFIGURED bound would have admitted it — genuine overload
            # sheds during a breach stay ordinary sheds (and keep feeding
            # the monitor's error dimension, which excludes slo_shed)
            tightened = (
                max_pending != self.max_pending
                and in_flight < self.max_pending
            )
            self.registry.inc("fleet_requests_shed_total")
            if tightened:
                self.registry.inc("fleet_slo_shed_total")
            exc = QueueFull(
                f"fleet has {in_flight} requests in flight, at max_pending="
                f"{max_pending}"
                + (f" (tightened from {self.max_pending} by SLO burn)"
                   if tightened else "")
                + "; request shed — drain with step() or retry after backoff"
            )
            exc.trace_id = self._terminal_event(
                "shed", in_flight=in_flight, slo_tightened=tightened,
            )
            raise exc
        if deadline_s is None:
            deadline_s = default_deadline_s
        now = self._clock()
        req = FleetRequest(
            self._next_id, prompt, config, now,
            deadline_at=None if deadline_s is None else now + deadline_s,
            trace_id=self.tracer.new_trace_id() if self.tracer else None,
            ttft_anchor_s=ttft_anchor_s,
            on_token=on_token,
            priority=int(priority), tenant=tenant,
        )
        self._next_id += 1
        self._queue.append(req)
        self._inflight[req.request_id] = req
        self.registry.inc("fleet_requests_submitted_total")
        return req

    def serve(self, prompts: Sequence, config: Optional[GenerationConfig] = None
              ) -> List[Optional[np.ndarray]]:
        """Submit every prompt, drain, return results in order — the strict
        batch convenience (failed requests re-raise, the engine contract)."""
        reqs = [self.submit(p, config) for p in prompts]
        self.run_until_idle()
        failed = [r for r in reqs if r.status == "failed"]
        if failed:
            raise RuntimeError(
                f"{len(failed)} of {len(reqs)} fleet requests failed; "
                f"first error: {failed[0].error}"
            )
        return [r.result for r in reqs]

    def pending(self) -> bool:
        """True while the FLEET has undispatched or in-flight requests.
        Stale engine copies already decided by dedupe don't count — they
        retire on their own while other work drives steps, or vanish with
        the next restart."""
        return bool(self._queue) or bool(self._dispatched)

    def cancel(self, request_id: int) -> bool:
        """Withdraw one fleet request — the gateway's client-disconnect
        route, lifted to the fleet: a queued request leaves the queue; a
        dispatched request's LIVE engine copy is cancelled on its replica
        (the slot engine frees the slot and returns its pool pages
        immediately), and the fleet request finalizes ``cancelled``
        exactly once (``fleet_requests_cancelled_total``, one terminal
        ``fleet.request`` span). Stale copies on hung replicas retire on
        their own and fall into the ordinary duplicate-dedupe accounting.
        Returns True when the request was found live."""
        req = self._inflight.get(request_id)
        if req is None or req.done:
            return False
        if req.status == "dispatched" and req.replica_id is not None:
            replica = self._replicas.get(req.replica_id)
            if replica is None:
                # the dispatch target was scaled away; its in-flight work
                # was already failed over, so the request is queued — just
                # finalize the withdrawal
                self._finalize(req, "cancelled", replica_id=None)
                return True
            handle = replica.handles.get(req.request_id)
            if handle is not None and handle.done:
                # the engine copy already finished; the next collect sweep
                # finalizes the fleet request with its REAL disposition — a
                # finished generation must not be recast as a cancellation
                # (the single-engine cancel() handles this race the same
                # way: found-but-done returns False)
                return False
            replica.handles.pop(req.request_id, None)
            if handle is not None:
                try:
                    replica.engine.cancel(handle.request_id)
                except Exception:
                    pass  # a wedged replica must not block the withdrawal
        self._finalize(req, "cancelled", replica_id=req.replica_id)
        return True

    def run_until_idle(self) -> int:
        served = 0
        while self.pending():
            before = self._clock()
            n = self.step()
            served += n
            if n == 0 and not self._last_step_activity:
                # nothing was steppable or dispatchable this pass — even
                # dispatched requests can be unreachable when their replica's
                # breaker is open, so in-flight work alone is no progress
                # guarantee
                if self._clock() == before:
                    # Pending work, nothing steppable or dispatchable, and a
                    # frozen clock: only breaker cooldowns / backoff gates
                    # could unblock us, and a frozen clock never elapses
                    # them. Raise instead of spinning forever — a FakeClock
                    # driver must advance the clock (or call step() itself).
                    raise RuntimeError(
                        "fleet stalled: pending work but every replica is "
                        "unavailable and the clock is not advancing — "
                        "advance the FakeClock past the breaker cooldown / "
                        "redispatch backoff, or drive step() manually"
                    )
                # real clock, waiting on a breaker cooldown or a redispatch
                # backoff gate: yield instead of hot-spinning the drain loop
                # at 100% CPU for up to breaker_cooldown_s
                time.sleep(0.005)
        return served

    def drain(self) -> int:
        """Graceful shutdown: stop accepting, run every fleet request to a
        terminal state, then drain each reachable replica engine (stale
        deduped copies finish too, so duplicate accounting closes).
        Idempotent."""
        self._accepting = False
        served = self.run_until_idle()
        for replica in self.replicas:
            if replica.breaker.poll() == "open":
                continue
            replica.engine.drain()
            self._collect(replica)
        return served

    def warmup(self, config: Optional[GenerationConfig] = None) -> int:
        """Warm every replica (each drives its own bucket grid once; the
        kernels are built once per process). Returns the summed
        ``engine.warmup`` counts."""
        return sum(r.engine.warmup(config) for r in self.replicas)

    # -- internals ----------------------------------------------------------
    def _terminal_event(self, status: str, **attrs) -> Optional[str]:
        if self.tracer is None:
            return None
        trace_id = self.tracer.new_trace_id()
        self.tracer.event("fleet.request", trace_id=trace_id, status=status, **attrs)
        return trace_id

    def _update_gauges(self) -> None:
        replicas = self._replicas.values()
        healthy = sum(1 for r in replicas if r.breaker.state == "closed")
        self.registry.set_gauge("fleet_replicas_healthy", healthy)
        self.registry.set_gauge("fleet_replicas", len(self._replicas))
        self.registry.set_gauge(
            "fleet_replicas_draining", sum(1 for r in replicas if r.draining)
        )

    def _finalize(self, req: FleetRequest, status: str, *,
                  result: Optional[np.ndarray] = None,
                  error: Optional[str] = None,
                  replica_id: Optional[int] = None) -> None:
        """The request's ONE terminal disposition — every submission that
        entered the queue passes here exactly once (dedupe guards the
        duplicate-completion paths), emitting the one terminal
        ``fleet.request`` span with the completing replica id attached.
        Removes the request from EVERY tracking structure — a stale copy's
        completion can finalize a request that sits re-queued behind a
        redispatch backoff gate, so the queue must forget it too."""
        self._dispatched.pop(req.request_id, None)
        self._inflight.pop(req.request_id, None)
        if req.status == "queued":
            self._queue = [r for r in self._queue if r.request_id != req.request_id]
        req.status = status
        req.result = result
        req.error = error
        req.replica_id = replica_id
        if status == "ok":
            self.registry.inc("fleet_requests_completed_total")
            if replica_id is not None:
                self._completed_by_replica[replica_id] = (
                    self._completed_by_replica.get(replica_id, 0) + 1
                )
        elif status == "timed_out":
            self.registry.inc("fleet_requests_timed_out_total")
        elif status == "cancelled":
            self.registry.inc("fleet_requests_cancelled_total")
        elif status == "failed":
            self.registry.inc("fleet_requests_failed_total")
        latency_s = self._clock() - req.submitted_at
        self.registry.observe("fleet_request_latency_ms", latency_s * 1e3)
        if self.tracer is not None:
            span = self.tracer.start_span(
                "fleet.request", trace_id=req.trace_id,
                start_s=self.tracer.now() - latency_s,
                request_id=req.request_id, prompt_len=int(req.prompt.size),
                replica=replica_id, dispatches=req.dispatches,
            )
            self.tracer.end_span(
                span, status=status, **({"error": error} if error else {})
            )

    def _expire_overdue(self) -> int:
        """Fleet-level deadline shedding for undispatched requests (the
        engines enforce deadlines for dispatched copies from the remaining
        budget handed over at dispatch)."""
        now = self._clock()
        live: List[FleetRequest] = []
        expired = 0
        for req in self._queue:
            if req.deadline_at is not None and now >= req.deadline_at:
                self._finalize(
                    req, "timed_out",
                    error=f"deadline exceeded after "
                          f"{now - req.submitted_at:.3f}s in the fleet queue",
                )
                expired += 1
            else:
                live.append(req)
        self._queue = live
        return expired

    def _charge_breaker(self, replica: Replica) -> bool:
        """Count one replica failure; returns True when it OPENED the
        breaker — the caller must then fail over the replica's in-flight
        work (:meth:`_failover_inflight`), because an open replica is no
        longer stepped and would strand its dispatched requests."""
        self.registry.inc("fleet_replica_failures_total")
        opened = replica.breaker.record_failure()
        if opened:
            self.registry.inc("fleet_breaker_open_total")
            if self.tracer is not None:
                self.tracer.event(
                    "fleet.breaker_open", replica=replica.replica_id,
                    consecutive_failures=replica.breaker.consecutive_failures,
                )
            if self.flight_recorder is not None:
                self.flight_recorder.trigger(
                    "breaker_open",
                    f"replica {replica.replica_id} breaker opened after "
                    f"{replica.breaker.consecutive_failures} consecutive "
                    "failures",
                    trace_ids=self._inflight_trace_ids(replica),
                    replica=replica.replica_id,
                )
        self._update_gauges()
        return opened

    def _inflight_trace_ids(self, replica: Replica) -> List[str]:
        """Trace ids of the fleet requests whose live dispatch sits on
        ``replica`` — the join evidence an incident bundle carries."""
        return [
            self._dispatched[fid].trace_id
            for fid in replica.handles
            if fid in self._dispatched
            and self._dispatched[fid].trace_id is not None
        ]

    def _requeue(self, req: FleetRequest, error: str, *,
                 avoid_replica_id: Optional[int] = None,
                 voluntary: bool = False) -> int:
        """Failover path: return the request to the fleet queue for
        re-dispatch (replayed from its prompt), or fail it terminally when
        its dispatch budget (``1 + redispatch_policy.max_retries``) is
        spent. ``avoid_replica_id`` records where the failed attempt ran so
        the next dispatch prefers anywhere else. ``voluntary`` marks a
        retirement requeue (scale-down): the withdrawn dispatch did not
        fail, so it is REFUNDED — no budget charge, no terminal
        budget-exhaustion, no backoff delay — a replica retiring must not
        be able to drop a request whose genuine failovers already spent
        the budget. Returns 1 when this call disposed of the request."""
        self._dispatched.pop(req.request_id, None)
        req.status = "queued"
        req.replica_id = None
        if avoid_replica_id is not None:
            req.last_replica_id = avoid_replica_id
        if voluntary:
            req.dispatches = max(0, req.dispatches - 1)
            self.registry.inc("fleet_redispatch_total")
            req.not_before = self._clock()
            self._queue.append(req)
            return 0
        if req.dispatches >= 1 + self.redispatch_policy.max_retries:
            self._finalize(
                req, "failed",
                error=f"failover budget exhausted after {req.dispatches} "
                      f"dispatch attempts; last error: {error}",
            )
            return 1
        self.registry.inc("fleet_redispatch_total")
        req.not_before = self._clock() + self.redispatch_policy.delay_s(
            req.dispatches - 1, rng=self._rng
        )
        # append only; _dispatch_pending sorts once per pass (FIFO by id),
        # so a failure with many victims doesn't pay one sort per victim
        self._queue.append(req)
        return 0

    def _pick_replica(self, req: FleetRequest,
                      loads: Dict[Replica, int]) -> Optional[Replica]:
        """Least-loaded dispatchable replica (ties → lowest id) from the
        pass's pre-scanned ``loads`` map. Open breakers and draining
        replicas are excluded; a half-open replica is eligible only for a
        single probe request at a time; a replica still holding a STALE
        copy of this request (hung, failed over, not yet retired) is
        excluded — re-dispatching there would overwrite the stale handle
        and leave an untracked duplicate running (the stale copy's own
        completion can still win via the dedupe sweep). The replica the
        request LAST FAILED on is only chosen when nothing else is
        available, so a retry doesn't bounce straight back onto a poisoned
        executor. Breaker state and handle sets are re-read live (they
        change as the pass dispatches and charges faults); only the engine
        health scan is cached."""
        best = None
        best_load = None
        last_resort = None
        last_resort_load = None
        for replica, load in loads.items():
            if replica.draining:
                continue
            if req.request_id in replica.handles:
                continue
            state = replica.breaker.poll()
            if state == "open":
                continue
            if state == "half_open" and replica.handles:
                continue
            if replica.replica_id == req.last_replica_id:
                if last_resort_load is None or load < last_resort_load:
                    last_resort, last_resort_load = replica, load
                continue
            if best_load is None or load < best_load:
                best, best_load = replica, load
        return best if best is not None else last_resort

    def _dispatch_pending(self) -> int:
        """Place queued requests on replicas, oldest first. Returns the
        number of requests terminally disposed of while trying (expired
        before dispatch, or out of failover budget).

        One ``engine.health()`` scan per replica per PASS (not per queued
        request): this runs on the per-token ``step()`` path, and with the
        queue at ``max_pending`` an O(queue x replicas) health scan would
        dominate the host work. Loads are maintained locally as the pass
        places requests."""
        if not self._queue:
            return 0
        disposed = 0
        now = self._clock()
        # the ONE sort site: requeues since the last pass appended without
        # sorting; dispatch order is priority tier first (higher tiers
        # reach an engine — and its preemption machinery — sooner), FIFO
        # by original submission id within a tier
        self._queue.sort(key=lambda r: (-r.priority, r.request_id))
        pending = self._queue
        self._queue = []
        loads: Dict[Replica, int] = {}
        for replica in self.replicas:
            h = replica.engine.health()
            if h["ready"]:
                loads[replica] = (
                    int(h["queue_depth"])
                    + int(h.get("slots_active") or 0)
                    + (1 if h.get("admitting") else 0)
                )
        for req in pending:
            if req.not_before > now:
                self._queue.append(req)
                continue
            replica = self._pick_replica(req, loads)
            if replica is None:
                self._queue.append(req)
                continue
            fault = self._chaos.hit("fleet.dispatch") if self._chaos else None
            if fault is not None and fault.kind == "error":
                # a failed dispatch RPC: charges the chosen replica's
                # breaker, the request retries under backoff; if the charge
                # OPENED the breaker, the replica's other in-flight work
                # must fail over too (open replicas are not stepped)
                req.dispatches += 1
                opened = self._charge_breaker(replica)
                disposed += self._requeue(
                    req, str(fault.make_error()),
                    avoid_replica_id=replica.replica_id,
                )
                if opened:
                    disposed += self._failover_inflight(
                        replica, "breaker_open",
                        f"opened by dispatch fault: {fault.make_error()}",
                    )
                continue
            remaining = None
            if req.deadline_at is not None:
                remaining = req.deadline_at - now
                if remaining <= 0:
                    self._finalize(
                        req, "timed_out",
                        error="deadline expired before dispatch",
                    )
                    disposed += 1
                    continue
            try:
                # ttft_anchor_s: TTFT is user-facing — measured from the
                # FLEET front door (or further back, at the gateway's
                # socket accept), so fleet queue wait (and failover
                # replays) stay inside the number the SLO judges
                handle = replica.engine.submit(
                    req.prompt, req.config, deadline_s=remaining,
                    ttft_anchor_s=(
                        req.submitted_at if req.ttft_anchor_s is None
                        else req.ttft_anchor_s
                    ),
                    on_token=req.on_token,
                    priority=req.priority, tenant=req.tenant,
                )
            except QueueFull:
                self._queue.append(req)  # engine backpressure: wait, not a fault
                continue
            except ValueError as e:
                # only reachable with heterogeneous replicas (fleet-level
                # check_feasible ran against replica 0)
                self._finalize(req, "failed", error=f"{type(e).__name__}: {e}")
                disposed += 1
                continue
            except Exception as e:
                req.dispatches += 1
                opened = self._charge_breaker(replica)
                disposed += self._requeue(
                    req, f"{type(e).__name__}: {e}",
                    avoid_replica_id=replica.replica_id,
                )
                if opened:
                    disposed += self._failover_inflight(
                        replica, "breaker_open",
                        f"opened by dispatch fault: {type(e).__name__}: {e}",
                    )
                continue
            req.dispatches += 1
            req.status = "dispatched"
            req.replica_id = replica.replica_id
            replica.handles[req.request_id] = handle
            self._dispatched[req.request_id] = req
            loads[replica] += 1
            self.registry.inc("fleet_dispatch_total")
            if self.tracer is not None:
                self.tracer.event(
                    "fleet.dispatch", trace_id=req.trace_id,
                    replica=replica.replica_id, attempt=req.dispatches,
                )
        return disposed

    def _failover_inflight(self, replica: Replica, reason: str,
                           error: str) -> int:
        """Fail over (or, with failover disabled, terminally fail) every
        request whose LIVE dispatch sits on ``replica`` — called whenever
        the replica becomes unreachable: a step failure, or its breaker
        opening from the dispatch-fault path (an open replica is not
        stepped, so leaving requests on it would strand them for the whole
        cooldown). Returns terminal dispositions caused here."""
        victims = sorted(
            (
                self._dispatched[fid]
                for fid in list(replica.handles)
                if fid in self._dispatched
                and self._dispatched[fid].replica_id == replica.replica_id
            ),
            key=lambda r: r.request_id,
        )
        disposed = 0
        if victims:
            if self.failover:
                self.registry.inc("fleet_failover_total")
                for req in victims:
                    disposed += self._requeue(
                        req, f"replica {replica.replica_id} {reason}: {error}",
                        avoid_replica_id=replica.replica_id,
                    )
            else:
                for req in victims:
                    self._finalize(
                        req, "failed",
                        error=f"replica {replica.replica_id} {reason} "
                              f"(failover disabled): {error}",
                    )
                    disposed += 1
        return disposed

    def _on_replica_failure(self, replica: Replica, reason: str,
                            error: str) -> int:
        """Replica-level step failure: charge the breaker, fail over (or
        fail) its in-flight requests, rebuild a crashed replica. Returns
        terminal dispositions caused here."""
        if self.flight_recorder is not None:
            # capture BEFORE the failover sweep mutates the dispatch maps:
            # the bundle's trace ids name the victims as they were
            self.flight_recorder.trigger(
                "replica_failure",
                f"replica {replica.replica_id} {reason}: {error}",
                trace_ids=self._inflight_trace_ids(replica),
                replica=replica.replica_id, failure_reason=reason,
                in_flight=len(replica.handles),
            )
        self._charge_breaker(replica)
        if self.tracer is not None:
            self.tracer.event(
                "fleet.replica_failed", replica=replica.replica_id,
                reason=reason, error=error, in_flight=len(replica.handles),
            )
        disposed = self._failover_inflight(replica, reason, error)
        if reason == "crash":
            # the crashed-process model: rebuild now so reintegration
            # probes a live engine; its handles (and any stale copies) die
            # with it
            replica.restart()
            self.registry.inc("fleet_replica_restarts_total")
            if self.tracer is not None:
                self.tracer.event(
                    "fleet.replica_restarted", replica=replica.replica_id,
                    reason=reason,
                )
        self._update_gauges()
        return disposed

    def _collect(self, replica: Replica) -> int:
        """Sweep the replica's finished engine handles into fleet terminal
        states, with exactly-once dedupe by fleet request id: the first
        completed copy wins; a late duplicate (the request already done, or
        no longer tracked) is counted and dropped. A stale copy's non-ok
        outcome never decides a request that has a live dispatch
        elsewhere."""
        disposed = 0
        for fid, handle in replica.collect():
            # look up in the full in-flight map, not just the dispatched
            # one: a hung replica's completed copy must still win for a
            # request waiting re-queued behind its redispatch backoff
            req = self._inflight.get(fid)
            if req is None or req.done:
                self.registry.inc("fleet_duplicate_results_total")
                continue
            if handle.status == "ok":
                self._finalize(
                    req, "ok", result=handle.result,
                    replica_id=replica.replica_id,
                )
                disposed += 1
            elif req.replica_id != replica.replica_id:
                # stale non-ok copy (the request is queued for re-dispatch
                # or live on another replica): the live dispatch decides
                continue
            elif handle.status == "timed_out":
                self._finalize(
                    req, "timed_out", error=handle.error,
                    replica_id=replica.replica_id,
                )
                disposed += 1
            else:  # engine-level failure (poisoned executor, request fault)
                if self.failover:
                    # charge the replica: a poisoned executor failing every
                    # request must open its breaker instead of silently
                    # burning each request's failover budget. A genuinely
                    # bad REQUEST charges one failure per replica it visits,
                    # which the replica's next clean pass resets — only a
                    # replica failing repeatedly accumulates to threshold.
                    opened = self._charge_breaker(replica)
                    disposed += self._requeue(
                        req,
                        f"engine fault on replica {replica.replica_id}: "
                        f"{handle.error}",
                        avoid_replica_id=replica.replica_id,
                    )
                    if opened:
                        disposed += self._failover_inflight(
                            replica, "breaker_open",
                            f"opened by engine fault: {handle.error}",
                        )
                else:
                    self._finalize(
                        req, "failed", error=handle.error,
                        replica_id=replica.replica_id,
                    )
                    disposed += 1
        return disposed

    # -- the supervised scheduler -------------------------------------------
    def step(self) -> int:
        """One fleet scheduling pass: expire overdue queued requests,
        dispatch what can be placed, then give every reachable replica one
        supervised engine step and sweep its completions. Returns the
        number of fleet requests terminally disposed of; drive drain loops
        off :meth:`pending` (a mid-generation pass legitimately disposes of
        nothing)."""
        if self.slo_monitor is not None:
            # one burn evaluation per scheduling pass: breach/recovery
            # transitions (and the admission tightening they gate) happen
            # here, on the shared clock, never mid-submit
            self.slo_monitor.poll()
        if self.autoscaler is not None:
            # the elasticity control loop runs HERE, before the pass
            # snapshots the replica set: a scale-up serves this very pass,
            # a scale-down's failed-over work re-dispatches below
            self.autoscaler.poll()
        disposed = self._expire_overdue()
        disposed += self._dispatch_pending()
        stepped_any = False
        # snapshot: an autoscaler poll (above) may have added/removed
        # replicas, and the next poll can again — never iterate the live map
        for replica in self.replicas:
            state = replica.breaker.poll()
            if state == "open":
                continue
            if not (replica.engine.pending() or replica.handles):
                continue
            was_half_open = state == "half_open"
            stepped_any = True
            try:
                replica.step()
            except Exception as e:
                disposed += self._on_replica_failure(
                    replica, "crash", f"{type(e).__name__}: {e}"
                )
                continue
            if (
                self.step_timeout_s is not None
                and replica.last_step_wall_s >= self.step_timeout_s
            ):
                disposed += self._on_replica_failure(
                    replica, "hung",
                    f"step wall time {replica.last_step_wall_s:.3f}s >= "
                    f"step_timeout_s={self.step_timeout_s}",
                )
                continue
            # collect BEFORE judging the pass: an engine-level fault swept
            # up here charges the breaker, and that charge must not be
            # erased by crediting the same pass as a success
            fails_before = replica.breaker.consecutive_failures
            opens_before = replica.breaker.opened_total
            disposed += self._collect(replica)
            if (
                replica.breaker.consecutive_failures == fails_before
                and replica.breaker.opened_total == opens_before
            ):
                replica.breaker.record_success()
                if was_half_open:
                    self._update_gauges()
                    if self.tracer is not None:
                        self.tracer.event(
                            "fleet.breaker_close", replica=replica.replica_id
                        )
        self._last_step_activity = stepped_any
        self._update_gauges()
        return disposed

    # -- elasticity ---------------------------------------------------------
    def add_replica(self, factory: Optional[Callable[[], object]] = None
                    ) -> Replica:
        """Scale up by one replica, spawned from ``factory`` (default: the
        fleet's first constructor factory — the homogeneous case). The
        kernels are built once per process, so a new replica only
        allocates its state and pool before its first dispatch.

        The ``fleet.scale_up`` chaos site fires first (execution-count
        keyed): an ``error`` fault models a SPAWN FAILURE — the factory's
        process never comes up — counted ``fleet_scale_up_failed_total``
        and re-raised for the caller (the autoscaler absorbs it and holds
        its cooldown, so a broken image cannot spin the control loop)."""
        if self._chaos is not None:
            fault = self._chaos.hit("fleet.scale_up")
            if fault is not None and fault.kind == "error":
                self.registry.inc("fleet_scale_up_failed_total")
                if self.tracer is not None:
                    self.tracer.event(
                        "autoscaler.spawn_failed",
                        error=str(fault.make_error()),
                        replicas=len(self._replicas),
                    )
                raise fault.make_error()
        replica = self._spawn_replica(
            factory if factory is not None else self._default_factory
        )
        self._completed_by_replica.setdefault(replica.replica_id, 0)
        self.registry.inc("fleet_scale_up_total")
        self._update_gauges()
        return replica

    def scale_down_victim(self) -> Optional[Replica]:
        """The replica :meth:`remove_replica` should retire next: the
        LEAST-LOADED eligible one (ties → highest id, so the founding
        replicas persist). Excluded: draining replicas, the last healthy
        replica (never drop below min-healthy — ``healthz`` must stay
        ready), and any replica whose breaker is not closed while it still
        holds engine handles — its in-flight work was re-queued at
        failover, and the stale copies must be left to retire through the
        duplicate-dedupe sweep, not evacuated into accounting limbo.
        Returns None when nothing is eligible."""
        replicas = list(self._replicas.values())
        healthy = [
            r for r in replicas if r.breaker.state == "closed" and not r.draining
        ]
        best = None
        best_key = None
        for replica in replicas:
            if replica.draining:
                continue
            if replica.breaker.state != "closed" and replica.handles:
                continue
            if replica in healthy and len(healthy) <= 1:
                continue  # the last healthy replica keeps the fleet ready
            load = len(replica.handles)
            try:
                h = replica.engine.health()
                load += int(h["queue_depth"]) + int(h.get("slots_active") or 0)
            except Exception:
                pass  # a wedged engine is still a fine victim
            key = (load, -replica.replica_id)
            if best_key is None or key < best_key:
                best, best_key = replica, key
        return best

    def remove_replica(self, replica_id: int) -> Replica:
        """Scale down by one replica with ZERO dropped in-flight requests
        — the rolling_restart() discipline applied to retirement:

        1. the replica stops receiving dispatches (``draining``),
        2. its live in-flight requests fail over through the exactly-once
           replay path — survivors replay them from their prompts,
           token-identical under greedy decoding,
        3. its engine is **evacuated**: every stale engine-side copy is
           withdrawn and every KV pool page (mapped + reserved) returns to
           the pool tagged ``cause="scale_down"`` — the zero-leak
           accounting the acceptance drill pins,
        4. the replica leaves the fleet; its id is never reused.

        The ``fleet.scale_down`` chaos site fires after the failover
        (execution-count keyed): an ``error`` fault models the replica
        CRASHING MID-DRAIN — the evacuation never runs (a dead process
        frees its memory by dying), the failure is charged, and the
        removal completes; the failed-over work is already safe.

        Returns the removed :class:`Replica` (its engine still inspectable
        — tests read the pool's ``frees_by_cause``). Refuses to remove the
        last healthy non-draining replica (``healthz`` stays ready
        throughout, never below min-healthy)."""
        replica = self._replicas.get(replica_id)
        if replica is None:
            raise KeyError(f"no replica {replica_id} in the fleet")
        others_healthy = sum(
            1 for r in self._replicas.values()
            if r.replica_id != replica_id
            and r.breaker.state == "closed" and not r.draining
        )
        if others_healthy == 0 and replica.breaker.state == "closed":
            raise ValueError(
                f"removing replica {replica_id} would leave no healthy "
                "replica — the fleet must stay ready through a scale-down "
                "(scale_down_victim() never picks this one)"
            )
        replica.draining = True
        # always replay — even with failover=False: scale-down is a
        # voluntary retirement, not a failure, so its in-flight work moves
        # to survivors through the same exactly-once requeue path
        victims = sorted(
            (
                self._dispatched[fid]
                for fid in list(replica.handles)
                if fid in self._dispatched
                and self._dispatched[fid].replica_id == replica.replica_id
            ),
            key=lambda r: r.request_id,
        )
        if victims:
            self.registry.inc("fleet_failover_total")
            for req in victims:
                self._requeue(
                    req, f"replica {replica_id} retiring (fleet scale-down)",
                    avoid_replica_id=replica_id, voluntary=True,
                )
        crashed = None
        if self._chaos is not None:
            crashed = self._chaos.hit("fleet.scale_down")
            if crashed is not None and crashed.kind != "error":
                crashed = None
        if crashed is not None:
            # crash mid-drain: the process died before a clean evacuation;
            # its in-flight work is already re-queued above, so the drill
            # only costs the failure accounting
            self.registry.inc("fleet_replica_failures_total")
            if self.tracer is not None:
                self.tracer.event(
                    "fleet.replica_failed", replica=replica_id,
                    reason="scale_down_crash",
                    error=str(crashed.make_error()), in_flight=0,
                )
        else:
            evacuate = getattr(replica.engine, "evacuate", None)
            if evacuate is not None:
                evacuate(cause="scale_down")
        replica.handles.clear()
        del self._replicas[replica_id]
        self.registry.inc("fleet_scale_down_total")
        self._update_gauges()
        return replica

    # -- operations ---------------------------------------------------------
    def rolling_restart(self) -> int:
        """Zero-downtime maintenance: one replica at a time — stop
        dispatching to it, finish its in-flight work (the rest of the fleet
        keeps serving, new submissions included), rebuild it from its
        factory, reintegrate. An open (already failed) replica is rebuilt
        immediately. Returns the number of replicas restarted."""
        restarted = 0
        for replica in self.replicas:
            replica.draining = True
            restarts_before = replica.restarts
            try:
                while (
                    (replica.engine.pending() or replica.handles)
                    and replica.breaker.poll() != "open"
                ):
                    self.step()
                if replica.restarts == restarts_before:
                    # a crash during the drain loop already rebuilt it (and
                    # counted the restart) — don't discard the fresh engine
                    replica.restart()
                    self.registry.inc("fleet_replica_restarts_total")
                    if self.tracer is not None:
                        self.tracer.event(
                            "fleet.replica_restarted",
                            replica=replica.replica_id,
                            reason="rolling_restart",
                        )
                restarted += 1
            finally:
                replica.draining = False
        self._update_gauges()
        return restarted

    # -- observability ------------------------------------------------------
    def _prefix_cache_rollup(self) -> Optional[dict]:
        """Summed per-replica prefix-cache hit accounting, or None when no
        replica shares prefixes (docs/serving.md "Prefix sharing")."""
        regs: dict = {}
        for r in self.replicas:
            if getattr(r.engine, "_prefix_index", None) is not None:
                regs[id(r.engine.registry)] = r.engine.registry
        if not regs:
            return None
        hits = sum(int(reg.counter("kv_prefix_hits_total")) for reg in regs.values())
        misses = sum(
            int(reg.counter("kv_prefix_misses_total")) for reg in regs.values()
        )
        return {
            "hits": hits,
            "misses": misses,
            "hit_ratio": round(hits / max(1, hits + misses), 4),
        }

    def stats(self) -> dict:
        """Fleet counters (canonical ``fleet_*`` names AND the short
        convenience keys), per-replica completion attribution, and each
        replica's own ``stats()`` — the serve CLI's ``serve_stats`` record
        for a fleet run."""
        counts = self.registry.counters()

        def c(name: str) -> int:
            return int(counts.get(name, 0))

        reg = self.registry
        out = {name: c(name) for name in FLEET_COUNTERS}
        out.update({
            "engine": "fleet",
            "replicas": len(self._replicas),
            "failover": self.failover,
            "submitted": c("fleet_requests_submitted_total"),
            "completed": c("fleet_requests_completed_total"),
            "shed": c("fleet_requests_shed_total"),
            "timed_out": c("fleet_requests_timed_out_total"),
            "failed": c("fleet_requests_failed_total"),
            "rejected": c("fleet_requests_rejected_total"),
            "cancelled": c("fleet_requests_cancelled_total"),
            "queued": len(self._queue),
            "dispatched": len(self._dispatched),
            "dispatches": c("fleet_dispatch_total"),
            "failovers": c("fleet_failover_total"),
            "redispatches": c("fleet_redispatch_total"),
            "breaker_opens": c("fleet_breaker_open_total"),
            "replica_failures": c("fleet_replica_failures_total"),
            "replica_restarts": c("fleet_replica_restarts_total"),
            "duplicate_results_ignored": c("fleet_duplicate_results_total"),
            "replicas_healthy": sum(
                1 for r in self._replicas.values() if r.breaker.state == "closed"
            ),
            "scale_ups": c("fleet_scale_up_total"),
            "scale_downs": c("fleet_scale_down_total"),
            "scale_up_failures": c("fleet_scale_up_failed_total"),
            "autoscaler": (
                None if self.autoscaler is None else self.autoscaler.stats()
            ),
            "completed_by_replica": {
                str(k): v for k, v in sorted(self._completed_by_replica.items())
            },
            "request_latency_ms": {
                "p50": reg.percentile("fleet_request_latency_ms", 50.0),
                "p95": reg.percentile("fleet_request_latency_ms", 95.0),
            },
            # fleet-scope token latencies, mirrored from every replica's
            # engine (docs/observability.md)
            "ttft_ms": {
                "p50": reg.percentile("serving_ttft_ms", 50.0),
                "p95": reg.percentile("serving_ttft_ms", 95.0),
            },
            "inter_token_ms": {
                "p50": reg.percentile("serving_inter_token_ms", 50.0),
                "p95": reg.percentile("serving_inter_token_ms", 95.0),
            },
            "slo": None if self.slo_monitor is None else self.slo_monitor.stats(),
            "slo_sheds": c("fleet_slo_shed_total"),
            # fleet-wide prefix-sharing rollup (docs/serving.md "Prefix
            # sharing"): replicas keep INDEPENDENT caches — a failover
            # replay re-prefills on the survivor and re-hits whatever that
            # replica's own index holds — so the fleet view is the sum of
            # per-replica hit accounting (deduped by registry: replicas
            # sharing one registry already aggregate), not a shared cache's
            "prefix_cache": self._prefix_cache_rollup(),
            "per_replica": [
                {
                    "replica_id": r.replica_id,
                    "breaker": r.breaker.state,
                    "restarts": r.restarts,
                    "in_flight": len(r.handles),
                    "engine": r.engine.stats(),
                }
                for r in self.replicas
            ],
        })
        # fleet-wide per-tenant rollup (docs/observability.md "Scheduler
        # timeline & post-mortems"): replicas attribute independently —
        # pool pages, generated tokens, and preemption victims per tenant
        # — so the fleet view is the field-wise sum, the same shape each
        # replica's engine stats() reports
        tenants: dict = {}
        for rep in out["per_replica"]:
            for key, fields in (rep["engine"].get("tenants") or {}).items():
                agg = tenants.setdefault(key, {})
                for field, value in fields.items():
                    agg[field] = agg.get(field, 0) + value
        if tenants:
            out["tenants"] = {k: tenants[k] for k in sorted(tenants)}
        return out

    def health(self) -> dict:
        """Fleet readiness under the shared health schema
        (``serving.engine.HEALTH_KEYS``) plus per-replica snapshots —
        ``ready`` means a submission would be accepted right now AND at
        least one replica's breaker is closed to run it.

        ``replicas`` / ``replicas_healthy`` / ``draining`` are COUNTS (the
        ``/healthz`` payload a load balancer or autoscaler dashboard reads
        — docs/serving.md "Elasticity"); the per-replica snapshots live
        under ``replica_detail``. ``ready`` is pinned to stay true across
        a rolling restart and an autoscale transition: survivors keep
        serving while one replica drains."""
        now = self._clock()
        depth = len(self._queue) + len(self._dispatched)
        reg = self.registry
        replicas = list(self._replicas.values())
        healthy = sum(1 for r in replicas if r.breaker.state == "closed")
        # admission as currently ENFORCED — under SLO tightening, "ready"
        # flips false at the reduced bound, so a well-behaved front end
        # backs off before tripping the shed counter
        max_pending, _ = self._effective_admission()
        return {
            "ready": self._accepting and healthy > 0
            and (max_pending is None or depth < max_pending),
            "accepting": self._accepting,
            "queue_depth": depth,
            "max_queue": self.max_pending,
            "oldest_wait_ms": round(
                max((now - r.submitted_at) for r in self._queue) * 1e3, 3
            ) if self._queue else 0.0,
            "completed": int(reg.counter("fleet_requests_completed_total")),
            "shed": int(reg.counter("fleet_requests_shed_total")),
            "timed_out": int(reg.counter("fleet_requests_timed_out_total")),
            "failed": int(reg.counter("fleet_requests_failed_total")),
            "cancelled": int(reg.counter("fleet_requests_cancelled_total")),
            "replicas": len(replicas),
            "replicas_healthy": healthy,
            "draining": sum(1 for r in replicas if r.draining),
            "replica_detail": [r.health() for r in self.replicas],
        }
