"""Deterministic chaos harness: fault injection at explicit hook sites. A
copy of ``perceiver_io_tpu/reliability/chaos.py`` (a module without JAX).

Every fault is registered up front against a named **site** and a key, and
fires when the site's hook is consulted with a matching key: no randomness,
no wall clock and no monkeypatching, so a chaos drill replays bit for bit.
The registry keeps every site of the JAX package (its helpers and keys are
the same); the port consults these:

==========================  =============================================
site                        keying
==========================  =============================================
``trainer.step``            execution count (1-based): the Nth optimizer
                            step this trainer ran, NOT the step index, so
                            a fault does not fire again when rollback
                            replays the same step numbers
``data.record``             execution count (1-based): the Nth record
                            pulled from a chaos-wrapped source
                            (:meth:`ChaosRegistry.wrap_source`)
``serving.request``         explicit key: the ``request_id`` the engine
                            assigned (0-based submission order); both
                            engines, as the request is packed or admitted
``serving.batch``           execution count (1-based): the Nth micro-batch
                            the bucket engine dispatched, or the Nth
                            decode step the slot engine ran; ``error``
                            fails that batch's requests, or every resident
``kv.exhaust``              execution count (1-based): the Nth decode step
                            the slot engine ran with preemption enabled.
                            ``error`` forces the first resident's page
                            mapping down the ``PoolExhausted`` path that
                            step (:meth:`ChaosRegistry.exhaust_kv`)
==========================  =============================================

The fleet's and the gateway's sites (``fleet.*``, ``gateway.disconnect.*``)
come with outer serving (``ROADMAP.md`` A.5). Fault kinds: ``"error"`` (the
site raises an exception), ``"nan"`` (the trainer replaces the step loss
with NaN), ``"hang"`` (a clock advance by ``delay_s``; meaningful only with
a :class:`FakeClock`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """The default exception a chaos ``error`` fault raises at its site."""


class FakeClock:
    """A monotonic clock the chaos harness (or a test) advances explicitly.

    Drop-in for the engine's ``clock=time.monotonic`` parameter: calling the
    instance returns the current time; ``advance`` moves it forward. Hang
    faults use ``advance`` when present, so deadline expiry is deterministic
    instead of sleep-based.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("FakeClock only moves forward")
        self._t += float(seconds)


@dataclasses.dataclass
class Fault:
    """One registered fault: fires when ``site`` is hit with a key in
    ``[at, at + count)``. ``count > 1`` models K *consecutive* bad events
    (the trainer's rollback trigger)."""

    site: str
    kind: str  # "error" | "nan" | "hang"
    at: int
    count: int = 1
    delay_s: float = 0.0
    message: str = ""
    exc_factory: Optional[Callable[[], BaseException]] = None
    fired: int = 0

    def matches(self, key: int) -> bool:
        return self.at <= key < self.at + self.count

    def make_error(self) -> BaseException:
        if self.exc_factory is not None:
            return self.exc_factory()
        return InjectedFault(
            self.message
            or f"injected {self.kind} fault at {self.site}[{self.at}]"
        )


class ChaosRegistry:
    """Registry of pre-declared faults consulted at explicit hook sites.

    Hooks call :meth:`hit`; registered faults matching the site/key fire (and
    are recorded in :attr:`log`). Components take an optional ``chaos``
    parameter and skip the hook entirely when it is None, so production paths
    pay nothing.
    """

    def __init__(self):
        self._faults: List[Fault] = []
        self._counters: Dict[str, int] = {}
        #: every fired fault as ``(site, key, kind)``, in firing order
        self.log: List[Tuple[str, int, str]] = []

    # -- registration ------------------------------------------------------
    def add(self, site: str, kind: str, at: int, *, count: int = 1,
            delay_s: float = 0.0, message: str = "",
            exc_factory: Optional[Callable[[], BaseException]] = None) -> Fault:
        if kind not in ("error", "nan", "hang"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if count < 1:
            raise ValueError("count must be >= 1")
        fault = Fault(site, kind, int(at), count=int(count), delay_s=delay_s,
                      message=message, exc_factory=exc_factory)
        self._faults.append(fault)
        return fault

    def nan_loss_at_step(self, step: int, *, count: int = 1) -> Fault:
        """NaN train loss on the trainer's ``step``-th executed step (and the
        ``count - 1`` following ones) — the divergence-policy drill."""
        return self.add("trainer.step", "nan", step, count=count)

    def loader_error_on_record(self, record: int, *, count: int = 1,
                               exc_factory=None) -> Fault:
        """Transient exception on the ``record``-th record pulled from a
        :meth:`wrap_source`-wrapped stream."""
        return self.add("data.record", "error", record, count=count,
                        exc_factory=exc_factory)

    def fail_request(self, request_id: int, *, message: str = "") -> Fault:
        """Fail one serving request at pack time (its micro-batch peers are
        unaffected — the error-isolation drill)."""
        return self.add("serving.request", "error", request_id, message=message)

    def hang_request(self, request_id: int, *, delay_s: float) -> Fault:
        """Stall one serving request's slot for ``delay_s`` engine-clock
        seconds (needs a :class:`FakeClock`); with a deadline shorter than
        the stall, the request surfaces as ``timed_out``."""
        return self.add("serving.request", "hang", request_id, delay_s=delay_s)

    def fail_batch(self, batch_index: int, *, exc_factory=None) -> Fault:
        """Fail the engine's ``batch_index``-th micro-batch dispatch (1-based)
        — the executor-failure drill; every packed request in it is marked
        ``failed`` and the rest of the queue still drains."""
        return self.add("serving.batch", "error", batch_index,
                        exc_factory=exc_factory)

    def crash_replica(self, replica_id: int, at_step: int, *, count: int = 1,
                      exc_factory=None) -> Fault:
        """Crash fleet replica ``replica_id`` on its ``at_step``-th supervised
        step (1-based, and the ``count - 1`` following ones) — the scripted
        mid-decode replica-kill drill (docs/serving.md): the router restarts
        the replica and fails over its in-flight requests."""
        return self.add(f"fleet.replica_step.{replica_id}", "error", at_step,
                        count=count, exc_factory=exc_factory)

    def hang_replica(self, replica_id: int, at_step: int, *,
                     delay_s: float) -> Fault:
        """Stall fleet replica ``replica_id``'s ``at_step``-th step for
        ``delay_s`` clock seconds (needs the shared :class:`FakeClock`); a
        stall past the router's ``step_timeout_s`` is detected as a hung
        replica — its slow copy may still finish later, which is exactly the
        duplicate-completion case the router's request-id dedupe absorbs."""
        return self.add(f"fleet.replica_step.{replica_id}", "hang", at_step,
                        delay_s=delay_s)

    def disconnect_stream(self, stream_id: int, *, after_tokens: int) -> Fault:
        """Abandon gateway stream ``stream_id`` mid-generation: the gateway
        consults ``gateway.disconnect.<stream_id>`` once per token about to
        go on the wire (1-based), so the fault fires just before the
        ``after_tokens``-th token is written — the client "vanishes", the
        connection is torn down, and the gateway cancels the engine request
        (slot retired + pool pages returned; docs/serving.md "Streaming")."""
        if after_tokens < 1:
            raise ValueError(f"after_tokens must be >= 1, got {after_tokens}")
        return self.add(f"gateway.disconnect.{stream_id}", "error", after_tokens)

    def fail_scale_up(self, attempt: int, *, count: int = 1,
                      exc_factory=None) -> Fault:
        """Fail the fleet's ``attempt``-th replica spawn (1-based) — the
        scale-up chaos drill (docs/serving.md "Elasticity"): the factory's
        process never comes up, ``fleet_scale_up_failed_total`` counts it,
        and the autoscaler holds its cooldown before retrying."""
        return self.add("fleet.scale_up", "error", attempt, count=count,
                        exc_factory=exc_factory)

    def crash_scale_down(self, attempt: int, *, count: int = 1,
                         exc_factory=None) -> Fault:
        """Crash the victim of the fleet's ``attempt``-th scale-down
        (1-based) MID-DRAIN — after its in-flight work failed over, before
        the clean evacuation: the removal completes anyway and no accepted
        request is lost (the drill's pin)."""
        return self.add("fleet.scale_down", "error", attempt, count=count,
                        exc_factory=exc_factory)

    def exhaust_kv(self, step: int, *, count: int = 1) -> Fault:
        """Script KV-pool pressure: the slot engine (with preemption
        enabled) consults ``kv.exhaust`` once per decode step (1-based)
        and an ``error`` fault forces the first resident's page mapping
        down the :class:`PoolExhausted` path that step — a deterministic
        preemption storm with no need to actually fill the pool
        (docs/serving.md "Preemption & priorities"; the zero-leak drill
        in ``tests/test_kv_preemption.py``)."""
        return self.add("kv.exhaust", "error", step, count=count)

    def fail_dispatch(self, attempt: int, *, count: int = 1) -> Fault:
        """Fail the router's ``attempt``-th dispatch attempt (1-based,
        fleet-wide) — the request is re-dispatched under the router's backoff
        policy and the fault charges the chosen replica's circuit breaker."""
        return self.add("fleet.dispatch", "error", attempt, count=count)

    # -- hook side ---------------------------------------------------------
    def hit(self, site: str, key: Optional[int] = None) -> Optional[Fault]:
        """Consult the registry at ``site``. With ``key=None`` the site's
        execution counter advances and serves as the key (1-based). Returns
        the firing fault, or None."""
        if key is None:
            key = self._counters.get(site, 0) + 1
            self._counters[site] = key
        for fault in self._faults:
            if fault.site == site and fault.matches(int(key)):
                fault.fired += 1
                self.log.append((site, int(key), fault.kind))
                return fault
        return None

    def fired_count(self, site: Optional[str] = None) -> int:
        """How many faults fired (optionally at one site) — test bookkeeping."""
        return sum(1 for s, _, _ in self.log if site is None or s == site)

    # -- source wrapper ----------------------------------------------------
    def wrap_source(self, source_fn: Callable[[], Iterable],
                    site: str = "data.record") -> Callable[[], Iterator]:
        """Wrap a zero-arg source factory so every pulled record consults
        ``site`` first; an ``error`` fault raises there. Because the site
        counter keeps advancing across re-invocations, a fault at record N
        fires exactly once even when a retry wrapper re-opens the source —
        the transient-fault model."""

        def wrapped() -> Iterator:
            for item in source_fn():
                fault = self.hit(site)
                if fault is not None and fault.kind == "error":
                    raise fault.make_error()
                yield item

        return wrapped
