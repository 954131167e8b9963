"""SLO-driven fleet elasticity: the burn-rate autoscaler closed loop.
Counterpart of ``perceiver_io_tpu/serving/autoscaler.py`` (host code,
copied).

A :class:`FleetAutoscaler` reads the SLO monitor's breach signal and the
fleet's queue depth against its healthy slot capacity, and drives the
:class:`~perceiver_io_tpu_torch.serving.fleet.FleetRouter`'s replica count
between ``min_replicas`` and ``max_replicas`` through an ordered
degradation ladder (:data:`LADDER`):

1. ``tighten_admission``: the router scales its effective ``max_pending``
   and deadline by ``slo_shed_factor`` while the monitor reports a breach.
2. ``scale_up``: the breach (or queue depth past ``queue_high`` x capacity,
   or healthy replicas below ``min_replicas``) holds for ``up_evidence``
   polls and the up-cooldown has elapsed: a replica is spawned through the
   engine factory, optionally resized to ``scale_up_slots`` through the
   slot engine's ``resize_slots`` before it takes traffic.
3. ``shed``: at ``max_replicas`` and still breached.
4. ``recover`` then ``scale_down``: the queue stays below ``queue_low`` x
   capacity for ``down_evidence`` polls and ``down_cooldown_s`` has elapsed
   since the last scale action either way: the least-loaded replica is
   retired through :meth:`FleetRouter.remove_replica` (its work replays on
   survivors, its pool pages return tagged ``scale_down``).

Per-direction cooldowns and evidence streaks are the hysteresis. Everything
runs on the fleet's injectable clock and is chaos-scriptable at
``fleet.scale_up`` (a spawn failure: counted, the cooldown held) and
``fleet.scale_down`` (a crash mid-drain). Telemetry: the
``autoscaler_evaluations_total`` / ``autoscaler_holds_total`` counters, the
``autoscaler_ladder_rung`` / ``autoscaler_breach_streak`` /
``autoscaler_healthy_streak`` gauges, one ``autoscaler.scale_up`` /
``autoscaler.scale_down`` / ``autoscaler.spawn_failed`` /
``autoscaler.rung`` event per transition, and the flight recorder's
``autoscaler_escalation`` and ``spawn_failed`` triggers.

Constructing the autoscaler installs it as ``fleet.autoscaler``;
:meth:`FleetRouter.step` polls it once per pass, after the SLO monitor and
before the pass snapshots the replica set. The serve CLI builds it from
``--serve.autoscale.*``.
"""
from __future__ import annotations

from typing import Callable, Optional

#: the ordered degradation ladder; ``autoscaler_ladder_rung`` publishes the
#: current index (0 = steady, nothing degraded)
LADDER = ("steady", "tighten_admission", "scale_up", "shed", "recover")

AUTOSCALER_COUNTERS = (
    "autoscaler_evaluations_total",
    "autoscaler_holds_total",
)


class FleetAutoscaler:
    """Closed-loop replica-count controller over one
    :class:`~perceiver_io_tpu_torch.serving.FleetRouter` (module docstring for
    the ladder semantics).

    :param fleet: the router to control. The ctor installs itself as
        ``fleet.autoscaler``; :meth:`FleetRouter.step` then polls it once
        per scheduling pass.
    :param max_replicas: upper replica bound (rung 3 engages at it).
    :param min_replicas: lower bound — scale-down never goes below it, and
        healthy capacity below it (breaker-open replicas count as
        UNHEALTHY capacity) is itself a scale-up trigger.
    :param factory: engine factory for spawned replicas; default = the
        fleet's own first factory.
    :param up_cooldown_s / down_cooldown_s: per-direction hysteresis.
        The down cooldown gates on the last scale action in EITHER
        direction, so a scale-up is never immediately unwound.
    :param up_evidence / down_evidence: consecutive polls of fresh
        evidence required before acting in that direction.
    :param queue_high / queue_low: queue-depth watermarks as multiples of
        total healthy slot capacity — depth above ``queue_high`` ×
        capacity is pressure (scale-up trigger even without an SLO
        monitor), depth must fall below ``queue_low`` × capacity to count
        as healthy evidence for scale-down.
    :param scale_up_slots: optional slot count for replicas spawned on the
        scale-up path — applied through the slot engine's
        ``resize_slots`` rebuild BEFORE the replica takes traffic (it is
        empty, so the rebuild is free of semantics).
    :param clock / registry / tracer: default to the fleet's own.
    """

    def __init__(self, fleet, *, max_replicas: int, min_replicas: int = 1,
                 factory: Optional[Callable[[], object]] = None,
                 up_cooldown_s: float = 15.0, down_cooldown_s: float = 60.0,
                 up_evidence: int = 2, down_evidence: int = 5,
                 queue_high: float = 1.0, queue_low: float = 0.25,
                 scale_up_slots: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None, tracer=None, flight_recorder=None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})"
            )
        if up_evidence < 1 or down_evidence < 1:
            raise ValueError("evidence thresholds must be >= 1 polls")
        if up_cooldown_s < 0 or down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0 seconds")
        if not 0.0 <= queue_low <= queue_high:
            raise ValueError(
                f"need 0 <= queue_low ({queue_low}) <= queue_high "
                f"({queue_high})"
            )
        if scale_up_slots is not None and scale_up_slots < 1:
            raise ValueError(f"scale_up_slots must be >= 1, got {scale_up_slots}")
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.factory = factory
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.up_evidence = int(up_evidence)
        self.down_evidence = int(down_evidence)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.scale_up_slots = scale_up_slots
        self._clock = clock if clock is not None else fleet._clock
        self.registry = registry if registry is not None else fleet.registry
        self.tracer = tracer if tracer is not None else fleet.tracer
        #: optional incident
        #: :class:`~perceiver_io_tpu_torch.observability.FlightRecorder` — a
        #: ladder walk UP to scale_up/shed or a spawn failure dumps a
        #: bundle (docs/observability.md "Flight recorder & incident
        #: bundles"); defaults to the fleet's own when it has one
        self.flight_recorder = (
            flight_recorder if flight_recorder is not None
            else getattr(fleet, "flight_recorder", None)
        )
        self.registry.declare_counters(*AUTOSCALER_COUNTERS)
        self.rung = "steady"
        self._breach_streak = 0
        self._healthy_streak = 0
        # a fresh controller may act as soon as its evidence accumulates —
        # seed both cooldowns as already elapsed
        horizon = max(self.up_cooldown_s, self.down_cooldown_s)
        self._last_up_at = self._clock() - horizon
        self._last_down_at = self._clock() - horizon
        self.scale_ups = 0
        self.scale_downs = 0
        self.spawn_failures = 0
        #: post-mortem records of the last few scale-down victims (replica
        #: id, replayed in-flight count, final KV pool stats incl.
        #: ``frees_by_cause``) — the zero-leak evidence the acceptance
        #: drill and ``extras.elasticity`` read after the engine is gone
        self.retired: list = []
        self._publish_gauges()
        fleet.autoscaler = self

    # -- signal --------------------------------------------------------------
    def _capacity(self) -> int:
        """Total HEALTHY slot capacity: slots (1 for the bucket engine)
        summed over replicas that are closed-breaker and not draining — a
        breaker-open replica is unhealthy capacity, which is exactly why it
        can trigger a scale-up."""
        total = 0
        for r in self.fleet.replicas:
            if r.breaker.state != "closed" or r.draining:
                continue
            total += int(getattr(r.engine, "slots", 1))
        return total

    def _depth(self) -> int:
        return len(self.fleet._queue) + len(self.fleet._dispatched)

    # -- the control loop ----------------------------------------------------
    def poll(self) -> Optional[str]:
        """One control-loop evaluation (the fleet calls it per
        :meth:`~perceiver_io_tpu_torch.serving.FleetRouter.step`). Returns the
        action taken — ``"scale_up"`` / ``"scale_down"`` /
        ``"spawn_failed"`` — or None."""
        self.registry.inc("autoscaler_evaluations_total")
        now = self._clock()
        fleet = self.fleet
        replicas = fleet.replicas
        healthy = sum(
            1 for r in replicas
            if r.breaker.state == "closed" and not r.draining
        )
        capacity = self._capacity()
        depth = self._depth()
        monitor = fleet.slo_monitor
        breached = monitor is not None and monitor.breached
        pressure = capacity == 0 or depth > self.queue_high * capacity
        relaxed = capacity > 0 and depth <= self.queue_low * capacity
        want_up = breached or pressure or healthy < self.min_replicas
        # fresh-evidence streaks (the hysteresis): one contrary poll resets
        # the other direction; the band between the watermarks resets BOTH
        if want_up:
            self._breach_streak += 1
            self._healthy_streak = 0
        elif relaxed:
            self._healthy_streak += 1
            self._breach_streak = 0
        else:
            self._breach_streak = 0
            self._healthy_streak = 0

        action = None
        if self._breach_streak >= self.up_evidence:
            if len(replicas) >= self.max_replicas:
                pass  # rung 3: capacity exhausted — shedding is the response
            elif now - self._last_up_at < self.up_cooldown_s:
                self.registry.inc("autoscaler_holds_total")
            else:
                action = self._scale_up(
                    "slo_breach" if breached
                    else ("unhealthy_capacity" if healthy < self.min_replicas
                          else "queue_pressure"),
                    depth=depth, capacity=capacity,
                )
        elif (
            self._healthy_streak >= self.down_evidence
            and len(replicas) > self.min_replicas
        ):
            if now - max(self._last_up_at, self._last_down_at) \
                    < self.down_cooldown_s:
                self.registry.inc("autoscaler_holds_total")
            else:
                action = self._scale_down(depth=depth, capacity=capacity)

        self._set_rung(self._compute_rung(breached, pressure, action))
        self._publish_gauges()
        return action

    def _scale_up(self, reason: str, *, depth: int, capacity: int
                  ) -> Optional[str]:
        fleet = self.fleet
        before = len(fleet.replicas)
        now = self._clock()
        try:
            replica = fleet.add_replica(self.factory)
        except Exception:
            # spawn failure (the fleet.scale_up chaos drill, or a genuinely
            # broken factory): already counted fleet_scale_up_failed_total
            # and evented by add_replica — hold the cooldown so a broken
            # image cannot spin the control loop, and retry after it
            self.spawn_failures += 1
            self._last_up_at = now
            self._breach_streak = 0
            if self.flight_recorder is not None:
                # the fleet needed capacity and could not get it — the
                # bundle preserves what the control loop saw at that moment
                self.flight_recorder.trigger(
                    "spawn_failed",
                    f"replica spawn failed while scaling up ({reason}; "
                    f"queue depth {depth}, capacity {capacity})",
                    reason=reason, queue_depth=depth, capacity=capacity,
                    replicas=before,
                )
            return "spawn_failed"
        if self.scale_up_slots is not None:
            resize = getattr(replica.engine, "resize_slots", None)
            if resize is not None and \
                    getattr(replica.engine, "slots", None) != self.scale_up_slots:
                # the replica is fresh and empty, so the rebuild is free of
                # semantics; it has not taken a dispatch yet
                resize(self.scale_up_slots)
        self._last_up_at = now
        self._breach_streak = 0
        self.scale_ups += 1
        if self.tracer is not None:
            self.tracer.event(
                "autoscaler.scale_up", reason=reason,
                replica=replica.replica_id,
                replicas_before=before, replicas_after=before + 1,
                queue_depth=depth, capacity=capacity,
                slots=int(getattr(replica.engine, "slots", 1)),
            )
        return "scale_up"

    def _scale_down(self, *, depth: int, capacity: int) -> Optional[str]:
        fleet = self.fleet
        victim = fleet.scale_down_victim()
        if victim is None:
            # nothing eligible (e.g. every survivor-candidate is the last
            # healthy one, or open breakers still hold re-queued work) —
            # fresh evidence must accumulate again before the next attempt
            self.registry.inc("autoscaler_holds_total")
            self._healthy_streak = 0
            return None
        before = len(fleet.replicas)
        in_flight = len(victim.handles)
        removed = fleet.remove_replica(victim.replica_id)
        pool = getattr(removed.engine, "_pool", None)
        self.retired.append({
            "replica_id": removed.replica_id,
            "in_flight_replayed": in_flight,
            "pool": None if pool is None else pool.stats(),
        })
        if len(self.retired) > 8:
            self.retired.pop(0)
        self._last_down_at = self._clock()
        self._healthy_streak = 0
        self.scale_downs += 1
        if self.tracer is not None:
            self.tracer.event(
                "autoscaler.scale_down", replica=victim.replica_id,
                replicas_before=before, replicas_after=before - 1,
                in_flight_replayed=in_flight,
                queue_depth=depth, capacity=capacity,
            )
        return "scale_down"

    # -- the ladder ----------------------------------------------------------
    def _compute_rung(self, breached: bool, pressure: bool,
                      action: Optional[str]) -> str:
        n = len(self.fleet.replicas)
        if breached or pressure:
            if action == "scale_up":
                return "scale_up"
            if n >= self.max_replicas:
                return "shed"
            # rung 1 carries the load while scale-up evidence/cooldown
            # accumulates (the router's SLO tightening is already active)
            return "tighten_admission"
        in_down_cooldown = (
            self._clock() - max(self._last_up_at, self._last_down_at)
            < self.down_cooldown_s
        )
        if n > self.min_replicas and (
            action == "scale_down" or self._healthy_streak > 0
            or in_down_cooldown
        ):
            return "recover"
        return "steady"

    def _set_rung(self, rung: str) -> None:
        if rung != self.rung:
            if self.tracer is not None:
                self.tracer.event(
                    "autoscaler.rung", rung=rung, previous=self.rung,
                    index=LADDER.index(rung),
                )
            if (
                self.flight_recorder is not None
                and rung in ("scale_up", "shed")
                and LADDER.index(rung) > LADDER.index(self.rung)
            ):
                # the ladder walked UP past admission tightening: capacity
                # is being added (or is exhausted) — incident-worthy; the
                # recorder's per-kind cooldown keeps a long incident to
                # one bundle
                self.flight_recorder.trigger(
                    "autoscaler_escalation",
                    f"degradation ladder escalated {self.rung} -> {rung}",
                    rung=rung, previous=self.rung,
                    replicas=len(self.fleet.replicas),
                )
            self.rung = rung

    def _publish_gauges(self) -> None:
        self.registry.set_gauge("autoscaler_ladder_rung", LADDER.index(self.rung))
        self.registry.set_gauge("autoscaler_breach_streak", self._breach_streak)
        self.registry.set_gauge("autoscaler_healthy_streak", self._healthy_streak)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """JSON-able snapshot for ``serve_stats`` / bench records."""
        now = self._clock()
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "replicas": len(self.fleet.replicas),
            "rung": self.rung,
            "rung_index": LADDER.index(self.rung),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "spawn_failures": self.spawn_failures,
            "breach_streak": self._breach_streak,
            "healthy_streak": self._healthy_streak,
            "evaluations": int(
                self.registry.counter("autoscaler_evaluations_total")
            ),
            "holds": int(self.registry.counter("autoscaler_holds_total")),
            "up_cooldown_remaining_s": round(
                max(0.0, self.up_cooldown_s - (now - self._last_up_at)), 6
            ),
            "down_cooldown_remaining_s": round(
                max(0.0, self.down_cooldown_s
                    - (now - max(self._last_up_at, self._last_down_at))), 6
            ),
        }
