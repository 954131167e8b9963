"""Synthetic-user load generator: offered-load drills against the serving
stack, deterministic end to end.

The SLO layer (``observability/slo.py``, docs/observability.md) judges
serving by latency percentiles *vs offered load* — which needs a load
source with controlled arrival statistics, not "submit everything then
drain". This module is that source: a :class:`LoadGenerator` drives any
object exposing the shared request surface (``submit`` / ``step`` /
``pending`` — both engines and the :class:`~perceiver_io_tpu_torch.serving.FleetRouter`)
with synthetic users.

Two loop disciplines (both standard in serving evaluation — PAPERS.md's
Gemma-on-TPU comparison sweeps offered load open-loop):

- **Open loop** — arrivals come from an arrival process regardless of
  completions, so a saturated engine builds queue instead of silently
  back-pressuring the generator (the failure mode closed-loop-only
  benchmarks hide). Processes: ``poisson`` (exponential inter-arrivals at
  ``rate_rps``), ``bursty`` (bursts of ``burst_size`` back to back, burst
  starts Poisson at ``rate_rps / burst_size``), ``ramp`` (rate ramps
  linearly from ``rate_rps`` to ``ramp_to_rps`` across the run),
  ``uniform`` (fixed spacing — the deterministic baseline), and ``spike``
  (Poisson at ``rate_rps`` with a ``spike_factor``× rate step over the
  window ``[spike_start_s, spike_start_s + spike_duration_s)`` — the
  flash-crowd workload the fleet-elasticity drill and the
  ``extras.elasticity`` bench offer; docs/serving.md "Elasticity").
- **Closed loop** — ``users`` synthetic users each keep one request in
  flight: submit, await completion, think
  (``workload.think_time_s``), resubmit. Offered load self-limits to
  completion rate — the drill for per-user latency under steady
  concurrency.

Determinism: every random draw (arrival gaps, prompt lengths, prompt
tokens, ``max_new_tokens``, think times) comes from ONE injected
``numpy`` generator, and all timing runs on the injectable clock. Under a
:class:`~perceiver_io_tpu_torch.reliability.FakeClock` the generator *advances*
the clock itself — ``step_cost_s`` per engine step, and straight to the
next arrival when idle — so a whole offered-load drill replays
bit-identically with zero sleeps (tests/test_slo.py pins this). With a
real clock it sleeps instead, and the measured latencies are real.

The report (:meth:`LoadGenerator.run`) carries the shared
goodput-under-SLO accounting — computed through
:func:`~perceiver_io_tpu_torch.observability.slo.offered_load` /
:func:`~perceiver_io_tpu_torch.observability.slo.goodput_ratio`, the SAME
helpers the bench probes and ``obs report`` use: offered = accepted +
shed + rejected, so saturation shows up as goodput < 1, never as a
shrunk denominator.

**HTTP client mode** (docs/serving.md "Streaming"): point the generator
at a :class:`GatewayHttpClient` instead of an engine and the whole drill
runs over real sockets — POST ``/v1/generate`` per request, streamed
tokens read off the wire, shed/reject mapped back from 503/400 — so the
``extras.slo_goodput`` sweep measures goodput-under-SLO through the full
network path (socket-anchored TTFT included) with ONE flag flipped. The
client reports ``bytes_on_wire`` (response bytes received), which
:meth:`LoadGenerator.run` surfaces beside offered/completed. HTTP mode
requires a real clock: sockets cannot be driven by a
:class:`~perceiver_io_tpu_torch.reliability.FakeClock`.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

ARRIVALS = ("poisson", "bursty", "ramp", "uniform", "spike")
MODES = ("open", "closed")


@dataclasses.dataclass
class WorkloadSpec:
    """Per-request shape distributions, all sampled from the generator's
    injected rng. Ranges are inclusive ``(lo, hi)``.

    **Shared prefixes** (docs/serving.md "Prefix sharing"): with
    ``shared_prefix_pool > 0`` every prompt is ``prefix + fresh tail`` —
    the prefix drawn from a pool of ``shared_prefix_pool`` fixed "system
    prompts" (materialized once from the SAME injected rng, so the whole
    workload stays deterministic) sampled by popularity rank from a Zipf
    law with exponent ``shared_prefix_zipf``, the production skew the
    prefix cache exists for. ``prompt_len`` then sizes the per-request
    TAIL, not the whole prompt."""

    prompt_len: Tuple[int, int] = (4, 12)
    max_new_tokens: Tuple[int, int] = (4, 8)
    #: token-id draw range (lo inclusive, hi exclusive); keep below the
    #: model's vocab and off the pad id
    vocab: Tuple[int, int] = (1, 64)
    #: closed-loop think time between a completion and the user's next
    #: submission, seconds
    think_time_s: Tuple[float, float] = (0.0, 0.0)
    #: number of distinct shared prefixes (0 = every prompt fully random)
    shared_prefix_pool: int = 0
    #: token length range of each shared prefix (sampled per prefix, once)
    shared_prefix_len: Tuple[int, int] = (8, 8)
    #: Zipf popularity exponent (> 1; larger = hotter head)
    shared_prefix_zipf: float = 1.5
    #: lazily-materialized prefix pool (drawn from the run's rng on first
    #: use — not part of the spec's identity)
    _prefixes: Optional[list] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _prefix(self, rng: np.random.Generator) -> np.ndarray:
        if self._prefixes is None:
            if self.shared_prefix_zipf <= 1.0:
                raise ValueError(
                    f"shared_prefix_zipf must be > 1, got {self.shared_prefix_zipf}"
                )
            lo, hi = self.shared_prefix_len
            self._prefixes = [
                rng.integers(
                    self.vocab[0], self.vocab[1],
                    size=int(rng.integers(lo, hi + 1)), dtype=np.int32,
                )
                for _ in range(self.shared_prefix_pool)
            ]
        # unbounded Zipf rank folded onto the pool: rank 1 (the hottest
        # system prompt) keeps its Zipf mass, the tail wraps — skew is
        # preserved and every prefix stays reachable
        rank = (int(rng.zipf(self.shared_prefix_zipf)) - 1) % self.shared_prefix_pool
        return self._prefixes[rank]

    def sample_prompt(self, rng: np.random.Generator) -> np.ndarray:
        lo, hi = self.prompt_len
        n = int(rng.integers(lo, hi + 1))
        tail = rng.integers(self.vocab[0], self.vocab[1], size=n, dtype=np.int32)
        if self.shared_prefix_pool > 0:
            return np.concatenate([self._prefix(rng), tail])
        return tail

    def sample_max_new(self, rng: np.random.Generator) -> int:
        lo, hi = self.max_new_tokens
        return int(rng.integers(lo, hi + 1))

    def sample_think(self, rng: np.random.Generator) -> float:
        lo, hi = self.think_time_s
        return lo if hi <= lo else float(rng.uniform(lo, hi))


class HttpStreamHandle:
    """One in-flight HTTP stream: the client-side mirror of a
    ``ServeRequest`` handle — ``status`` / ``done`` / ``result`` — fed by a
    background reader thread consuming the gateway's SSE / JSON-lines
    response. ``result`` holds the streamed token ids (unpadded)."""

    def __init__(self, request_index: int):
        self.request_index = request_index
        self.tokens: List[int] = []
        self.status = "queued"
        self.error: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.bytes_received = 0
        self.result: Optional[np.ndarray] = None
        self.first_token_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status not in ("queued",)


class GatewayHttpClient:
    """Engine-surface adapter over a :class:`~perceiver_io_tpu_torch.serving.gateway.StreamingGateway`
    address: ``submit`` POSTs ``/v1/generate`` and returns an
    :class:`HttpStreamHandle` whose tokens stream in on a reader thread;
    ``step``/``pending`` satisfy the :class:`LoadGenerator` drive loop (the
    SERVER drives the engine — the client's ``step`` just yields).

    Admission mapping mirrors the in-process surface so the generator's
    offered/shed/rejected accounting is transport-independent: HTTP 503
    (bounded-queue backpressure) raises
    :class:`~perceiver_io_tpu_torch.reliability.QueueFull`, HTTP 400 (infeasible
    prompt) raises ``ValueError`` — both at submit time, read from the
    response head before the body streams.

    :param host / port: the gateway's bound address.
    :param mode: wire framing requested per stream (``jsonl`` parses
        cheapest; ``sse`` exercises the event framing).
    :param clock: time source for ``first_token_at`` stamps (client-side
        TTFT; the authoritative socket-anchored number lives on the
        server's ``serving_ttft_ms``).
    :param timeout_s: socket timeout per connection.
    """

    def __init__(self, host: str, port: int, *, mode: str = "jsonl",
                 clock: Callable[[], float] = time.monotonic,
                 timeout_s: float = 60.0):
        if mode not in ("sse", "jsonl"):
            raise ValueError(f"mode must be 'sse' or 'jsonl', got {mode!r}")
        self.host = host
        self.port = int(port)
        self.mode = mode
        self._clock = clock
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        #: handles not yet terminal — pruned on every pending() poll so the
        #: per-millisecond drive loop never rescans the whole run's history
        self._live_handles: List[HttpStreamHandle] = []
        self._next_index = 0
        #: total response-body bytes read off the wire — the
        #: bytes-on-wire number :meth:`LoadGenerator.run` reports
        self.bytes_received = 0

    def submit(self, prompt, config=None, *, deadline_s: Optional[float] = None,
               **_ignored) -> HttpStreamHandle:
        from perceiver_io_tpu_torch.reliability import QueueFull

        body: dict = {"prompt_ids": np.asarray(prompt, np.int32).reshape(-1).tolist(),
                      "stream": self.mode}
        if config is not None:
            body["max_new_tokens"] = int(config.max_new_tokens)
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )
        try:
            conn.request(
                "POST", "/v1/generate", body=json.dumps(body),
                headers={"Content-Type": "application/json"},
            )
            # the gateway answers the head as soon as admission decides, so
            # shed/reject surface synchronously — the loadgen accounting
            # point
            resp = conn.getresponse()
        except OSError as e:
            # a transient connect failure / socket timeout is ONE failed
            # request, not the end of the whole offered-load run: return a
            # terminal handle so the generator's accounting absorbs it
            conn.close()
            handle = HttpStreamHandle(self._next_index)
            self._next_index += 1
            handle.status = "failed"
            handle.error = f"{type(e).__name__}: {e}"
            return handle
        if resp.status == 503:
            detail = resp.read().decode(errors="replace")
            conn.close()
            raise QueueFull(f"gateway backpressure (503): {detail.strip()}")
        if resp.status != 200:
            detail = resp.read().decode(errors="replace")
            conn.close()
            raise ValueError(
                f"gateway rejected the request ({resp.status}): {detail.strip()}"
            )
        handle = HttpStreamHandle(self._next_index)
        self._next_index += 1
        self._live_handles.append(handle)
        threading.Thread(
            target=self._read_stream, args=(conn, resp, handle), daemon=True
        ).start()
        return handle

    def _read_stream(self, conn, resp, handle: HttpStreamHandle) -> None:
        try:
            while True:
                line = resp.readline()
                if not line:
                    # EOF without a terminal record: the server went away
                    if not handle.done:
                        handle.status = "failed"
                        handle.error = "stream ended without a terminal record"
                    break
                with self._lock:
                    self.bytes_received += len(line)
                    handle.bytes_received += len(line)
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b"data:"):  # SSE framing
                    line = line[5:].strip()
                record = json.loads(line)
                if record.get("done"):
                    handle.trace_id = record.get("trace_id")
                    handle.error = record.get("error")
                    handle.result = np.asarray(handle.tokens, np.int32)
                    handle.status = record.get("status", "failed")
                    break
                if handle.first_token_at is None:
                    handle.first_token_at = self._clock()
                handle.tokens.append(int(record["token"]))
        except Exception as e:
            if not handle.done:
                handle.status = "failed"
                handle.error = f"{type(e).__name__}: {e}"
        finally:
            conn.close()

    def step(self) -> int:
        """The server drives the engine; the client's step just yields so
        the drive loop doesn't spin."""
        time.sleep(0.001)
        return 0

    def pending(self) -> bool:
        # reader threads flip handle.status; a racy read only delays one
        # polling pass, never deadlocks the drive loop. Terminal handles
        # are pruned here so the poll stays O(in-flight), not O(run).
        self._live_handles = [h for h in self._live_handles if not h.done]
        return bool(self._live_handles)

    def health(self) -> dict:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            return json.loads(resp.read().decode())
        finally:
            conn.close()


class TTFTProbe:
    """Engine-surface proxy recording CLIENT-SIDE per-request TTFT through
    the ``on_token`` sink: ``submit`` stamps the clock, the first index-0
    token stamps it again (a fleet failover replay re-fires index 0 — the
    FIRST observation wins, matching the wire dedupe). Point a
    :class:`LoadGenerator` at ``TTFTProbe(fleet, clock)`` and every
    accepted request gains a ``{"index", "ttft_ms", "handle"}`` row in
    :attr:`records`, submit-ordered — the per-request goodput-under-SLO
    join for FLEET drills, where the engines' ``serving.first_token``
    events carry per-replica trace ids that never match the fleet
    handle's (single-engine drills can keep joining on the tracer).
    ``index`` is the request's position in the OFFERED sequence (shed /
    rejected offers advance it without leaving a record), so two runs of
    the same workload pair their common requests by ``index`` even when
    they shed differently. Everything else proxies, so the generator's
    accounting is unchanged."""

    def __init__(self, engine, clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self._clock = clock
        self.offered = 0
        self.records: List[dict] = []

    def submit(self, prompt, config=None, **kwargs):
        idx = self.offered
        self.offered += 1
        rec = {"index": idx, "ttft_ms": None, "handle": None}
        t0 = self._clock()
        user_sink = kwargs.pop("on_token", None)

        def on_token(index: int, token: int) -> None:
            if index == 0 and rec["ttft_ms"] is None:
                rec["ttft_ms"] = (self._clock() - t0) * 1e3
            if user_sink is not None:
                user_sink(index, token)

        handle = self.engine.submit(prompt, config, on_token=on_token, **kwargs)
        rec["handle"] = handle
        self.records.append(rec)
        return handle

    def step(self) -> int:
        return self.engine.step()

    def pending(self) -> bool:
        return self.engine.pending()

    def health(self) -> dict:
        return self.engine.health()

    def good_under(self, ttft_target_ms: float) -> int:
        """Requests that completed AND whose own first token met the
        target — the shared per-request goodput numerator."""
        return sum(
            1 for r in self.records
            if r["handle"] is not None and r["handle"].status == "ok"
            and r["ttft_ms"] is not None and r["ttft_ms"] <= ttft_target_ms
        )


class LoadGenerator:
    """Drive an engine/fleet with a synthetic workload (module docstring).

    :param engine: anything with the shared request surface — ``submit`` /
        ``step`` / ``pending`` (both engines, the fleet router).
    :param workload: the per-request shape distributions.
    :param mode: ``"open"`` or ``"closed"``.
    :param arrival: open-loop arrival process (:data:`ARRIVALS`).
    :param rate_rps: open-loop offered rate (requests/second); for
        ``ramp`` the starting rate.
    :param ramp_to_rps: ``ramp``'s final rate, reached at the last arrival.
    :param burst_size: ``bursty``'s requests per burst.
    :param spike_factor: ``spike``'s rate multiplier inside the window
        (offered rate = ``spike_factor * rate_rps`` there, ``rate_rps``
        outside).
    :param spike_start_s / spike_duration_s: the spike window, in seconds
        from the first arrival draw.
    :param users: closed-loop concurrent synthetic users.
    :param max_requests: total requests to offer, then drain and stop.
    :param config: optional :class:`GenerationConfig` template; each
        request gets ``dataclasses.replace(config,
        max_new_tokens=sampled)``. None submits with the engine default
        config (no per-request max_new variation).
    :param deadline_s: per-request deadline forwarded to ``submit``.
    :param rng: ``numpy`` Generator or int seed — the run's ONE source of
        randomness.
    :param clock: the engine's clock (share it!). A clock with
        ``advance`` (FakeClock) is driven by the generator; a real clock
        is slept against.
    :param step_cost_s: simulated wall cost of one ``engine.step()`` under
        a FakeClock (ignored for real clocks). This is what makes offered
        rate meaningful in a frozen-clock drill — and the knob a test
        turns up to inject a deterministic latency fault.
    """

    def __init__(self, engine, *, workload: Optional[WorkloadSpec] = None,
                 mode: str = "open", arrival: str = "poisson",
                 rate_rps: float = 10.0, ramp_to_rps: Optional[float] = None,
                 burst_size: int = 4, spike_factor: float = 4.0,
                 spike_start_s: float = 0.0,
                 spike_duration_s: Optional[float] = None,
                 users: int = 4, max_requests: int = 32,
                 config=None, deadline_s: Optional[float] = None,
                 rng=0, clock: Callable[[], float] = time.monotonic,
                 step_cost_s: float = 0.001):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if arrival not in ARRIVALS:
            raise ValueError(
                f"arrival must be one of {ARRIVALS}, got {arrival!r}"
            )
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if max_requests < 1:
            raise ValueError(f"max_requests must be >= 1, got {max_requests}")
        if users < 1:
            raise ValueError(f"users must be >= 1, got {users}")
        if burst_size < 1:
            raise ValueError(f"burst_size must be >= 1, got {burst_size}")
        if arrival == "ramp" and (ramp_to_rps is None or ramp_to_rps <= 0):
            raise ValueError(
                f"arrival='ramp' needs ramp_to_rps > 0, got {ramp_to_rps}"
            )
        if arrival == "spike":
            if spike_factor <= 0:
                raise ValueError(
                    f"arrival='spike' needs spike_factor > 0, got {spike_factor}"
                )
            if spike_duration_s is None or spike_duration_s <= 0:
                raise ValueError(
                    f"arrival='spike' needs spike_duration_s > 0, "
                    f"got {spike_duration_s}"
                )
            if spike_start_s < 0:
                raise ValueError(
                    f"spike_start_s must be >= 0, got {spike_start_s}"
                )
        if step_cost_s <= 0:
            # under a FakeClock the step cost is the only thing that moves
            # time while the engine works; zero would spin the open loop
            # forever inside one arrival gap
            raise ValueError(f"step_cost_s must be > 0, got {step_cost_s}")
        self.engine = engine
        self.workload = workload if workload is not None else WorkloadSpec()
        self.mode = mode
        self.arrival = arrival
        self.rate_rps = float(rate_rps)
        self.ramp_to_rps = None if ramp_to_rps is None else float(ramp_to_rps)
        self.burst_size = int(burst_size)
        self.spike_factor = float(spike_factor)
        self.spike_start_s = float(spike_start_s)
        self.spike_duration_s = (
            None if spike_duration_s is None else float(spike_duration_s)
        )
        self.users = int(users)
        self.max_requests = int(max_requests)
        self.config = config
        self.deadline_s = deadline_s
        self.rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        self._clock = clock
        self.step_cost_s = float(step_cost_s)
        self.handles: List[object] = []
        self.offered = 0
        self.shed = 0
        self.rejected = 0

    # -- time ----------------------------------------------------------------
    def _tick(self) -> None:
        """One engine step, charged ``step_cost_s`` on a FakeClock."""
        self.engine.step()
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(self.step_cost_s)

    def _wait_until(self, t: float) -> None:
        """Idle until ``t``: jump a FakeClock straight there; nap a real
        one (short naps — a real engine may retire work meanwhile)."""
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            if t > self._clock():
                advance(t - self._clock())
        else:
            now = self._clock()
            if t > now:
                time.sleep(min(t - now, 0.005))

    # -- arrivals ------------------------------------------------------------
    def _gaps(self) -> List[float]:
        """The full open-loop inter-arrival schedule, drawn up front so the
        offered pattern is independent of service times (the open-loop
        contract)."""
        n = self.max_requests
        rng = self.rng
        if self.arrival == "uniform":
            return [1.0 / self.rate_rps] * n
        if self.arrival == "poisson":
            return [float(g) for g in rng.exponential(1.0 / self.rate_rps, size=n)]
        if self.arrival == "bursty":
            gaps = []
            burst_gap = self.burst_size / self.rate_rps
            for i in range(n):
                if i % self.burst_size == 0:
                    gaps.append(float(rng.exponential(burst_gap)))
                else:
                    gaps.append(0.0)
            return gaps
        if self.arrival == "spike":
            # flash crowd: baseline Poisson with a K-step over the window.
            # The schedule is simulated arrival-time-forward so the rate a
            # gap is drawn at depends on WHEN the previous arrival landed —
            # the step is a property of the offered timeline, not of an
            # arrival index
            gaps = []
            t = 0.0
            spike_end = self.spike_start_s + self.spike_duration_s
            for _ in range(n):
                in_spike = self.spike_start_s <= t < spike_end
                rate = self.rate_rps * (self.spike_factor if in_spike else 1.0)
                gap = float(rng.exponential(1.0 / rate))
                # a baseline gap that would leap the whole window still
                # offers the spike: clip the draw to the window start so
                # the crowd actually arrives (the window is the event, the
                # gap is just the sampler)
                if not in_spike and t < self.spike_start_s \
                        and t + gap > self.spike_start_s:
                    gap = self.spike_start_s - t
                    gap = max(gap, 1e-9)
                gaps.append(gap)
                t += gap
            return gaps
        # ramp: rate interpolates rate_rps -> ramp_to_rps across arrivals
        gaps = []
        for i in range(n):
            frac = i / max(1, n - 1)
            rate = self.rate_rps + frac * (self.ramp_to_rps - self.rate_rps)
            gaps.append(float(rng.exponential(1.0 / rate)))
        return gaps

    # -- submission ----------------------------------------------------------
    def _submit_one(self) -> Optional[object]:
        from perceiver_io_tpu_torch.reliability import QueueFull

        prompt = self.workload.sample_prompt(self.rng)
        cfg = self.config
        if cfg is not None:
            cfg = dataclasses.replace(
                cfg, max_new_tokens=self.workload.sample_max_new(self.rng)
            )
        self.offered += 1
        try:
            handle = self.engine.submit(prompt, cfg, deadline_s=self.deadline_s)
        except QueueFull:
            self.shed += 1
            return None
        except ValueError:
            self.rejected += 1
            return None
        self.handles.append(handle)
        return handle

    # -- the drills ----------------------------------------------------------
    def _run_open(self) -> None:
        gaps = self._gaps()
        next_at = self._clock()
        for gap in gaps:
            next_at += gap
            # serve residents while waiting out the arrival gap; an idle
            # engine skips straight to the arrival (open loop never slows
            # its offered schedule to match service rate)
            while self._clock() < next_at:
                if self.engine.pending():
                    self._tick()
                else:
                    self._wait_until(next_at)
            self._submit_one()
        while self.engine.pending():
            self._tick()

    def _run_closed(self) -> None:
        # per-user state: (handle or None, next submit time)
        users: List[list] = [[None, self._clock()] for _ in range(self.users)]
        while True:
            now = self._clock()
            for user in users:
                handle, next_at = user
                if handle is not None and handle.done:
                    user[0] = None
                    user[1] = now + self.workload.sample_think(self.rng)
                    handle, next_at = user
                if handle is None and self.offered < self.max_requests and now >= next_at:
                    user[0] = self._submit_one()
            if self.offered >= self.max_requests and not self.engine.pending():
                if all(u[0] is None or u[0].done for u in users):
                    return
            if self.engine.pending():
                self._tick()
            else:
                soonest = min(
                    (u[1] for u in users if u[0] is None), default=None
                )
                if soonest is None or self.offered >= self.max_requests:
                    return
                self._wait_until(max(soonest, now))

    def run(self) -> dict:
        """Offer the whole workload, drain, and return the report:
        generator-side offered/shed/rejected accounting, terminal
        disposition counts from the request handles, wall span on the
        run's clock, and the achieved rates. ``handles`` stays on the
        instance for per-request inspection."""
        from perceiver_io_tpu_torch.observability.slo import goodput_ratio, offered_load

        t0 = self._clock()
        if self.mode == "open":
            self._run_open()
        else:
            self._run_closed()
        span_s = max(self._clock() - t0, 1e-9)
        by_status: dict = {}
        for h in self.handles:
            by_status[h.status] = by_status.get(h.status, 0) + 1
        completed = by_status.get("ok", 0)
        # the shared goodput definition (observability/slo.py): the
        # generator's own accounting rendered as the counter mapping the
        # helpers read, so in-process, fleet, and over-socket drills all
        # share ONE denominator (shed and rejected stay in it)
        counts = {
            "serving_requests_submitted_total": len(self.handles),
            "serving_requests_shed_total": self.shed,
            "serving_requests_rejected_total": self.rejected,
            "serving_requests_completed_total": completed,
        }
        return {
            "mode": self.mode,
            "arrival": self.arrival if self.mode == "open" else None,
            "offered": offered_load(counts),
            "accepted": len(self.handles),
            "shed": self.shed,
            "rejected": self.rejected,
            "completed": completed,
            "timed_out": by_status.get("timed_out", 0),
            "failed": by_status.get("failed", 0),
            "cancelled": by_status.get("cancelled", 0),
            "by_status": dict(sorted(by_status.items())),
            "span_s": round(span_s, 6),
            "offered_rps": round(self.offered / span_s, 4),
            "completed_rps": round(completed / span_s, 4),
            "goodput_ratio": round(goodput_ratio(counts), 4),
            # over-socket drills (GatewayHttpClient) report response bytes
            # read off the wire; None for in-process engines
            "bytes_on_wire": (
                int(self.engine.bytes_received)
                if hasattr(self.engine, "bytes_received") else None
            ),
        }
