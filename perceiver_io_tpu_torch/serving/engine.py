"""Shape-bucketed serving engine: continuous micro-batching over
:func:`~perceiver_io_tpu_torch.inference.generate.generate`.

Counterpart of ``perceiver_io_tpu/serving/engine.py``'s ``ServingEngine``:

- every prompt is left-padded up to a static ``(batch_size, prompt_len)``
  cell of a :class:`~.buckets.BucketTable`;
- queued requests with the same config are packed FIFO into the next
  micro-batch; unfilled rows are dummy rows whose outputs are dropped;
- the queue is bounded (``max_queue`` -> :class:`QueueFull`), requests carry
  deadlines on an injectable clock, a failing micro-batch fails only its own
  requests, ``drain()`` is the graceful shutdown and ``health()`` the
  readiness snapshot.

Greedy generation is left-pad invariant, so the bucketed output is
token-identical to per-request calls as long as ``config.num_latents`` is at
most the shortest served prompt. Sampled configs draw from the engine's
``torch.Generator``: each micro-batch's ``generate`` call draws its steps'
noise at the bucket's padded batch shape, in turn (JAX splits one key per
micro-batch).

Telemetry, as in JAX: every counter lives on a
:class:`~perceiver_io_tpu_torch.observability.MetricsRegistry` under its
canonical name (``stats()`` reads it back beside the short keys of
:data:`STAT_ALIASES`), with queue-wait, batch-assembly, device-execute and
token-latency histograms; an optional
:class:`~perceiver_io_tpu_torch.observability.Tracer` threads one trace per
request, ending in exactly one terminal ``serving.request`` span; an
optional ``chaos`` registry is consulted at ``serving.request`` (per
request) and ``serving.batch`` (per micro-batch); an optional
:class:`~perceiver_io_tpu_torch.observability.ProfilerTrigger` captures the
next dispatch under ``torch.profiler`` after a p95 regression; and the
``timeline``, ``flight_recorder`` and ``latency_sink`` attributes attach the
scheduler step timeline, the incident recorder and an SLO monitor's feed.
Each is skipped when unset. The raw latency samples also stay on the engine
(:attr:`ServingEngine.samples`).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference import decode_strategy as decode_strategy_mod
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.samplers import default_generator
from perceiver_io_tpu_torch.observability import MetricsRegistry, Tracer, default_ledger
from perceiver_io_tpu_torch.reliability import QueueFull
from perceiver_io_tpu_torch.serving.buckets import BucketTable

#: keys every ``health()`` of the serving layer exposes at least
HEALTH_KEYS = frozenset({
    "ready", "accepting", "queue_depth", "max_queue", "oldest_wait_ms",
    "completed", "shed", "timed_out", "failed", "cancelled",
})

#: canonical counter names -> the short ``stats()`` keys beside them
STAT_ALIASES = {
    "serving_requests_submitted_total": "requests",
    "serving_requests_completed_total": "completed",
    "serving_requests_shed_total": "shed",
    "serving_requests_timed_out_total": "timed_out",
    "serving_requests_failed_total": "failed",
    "serving_requests_rejected_total": "rejected",
    "serving_requests_cancelled_total": "cancelled",
    "serving_batches_total": "batches",
    "serving_tokens_generated_total": "tokens_generated",
}
_EXTRA_COUNTERS = (
    "serving_prompt_tokens_real_total",
    "serving_prompt_tokens_padded_total",
    "serving_decode_rows_total",
    "serving_decode_rows_padded_total",
)
#: the engine's raw sample lists -> the registry histogram each feeds
SAMPLE_HISTOGRAMS = {
    "queue_wait_ms": "serving_queue_wait_ms",
    "ttft_ms": "serving_ttft_ms",
    "inter_token_ms": "serving_inter_token_ms",
    "device_execute_ms": "serving_device_execute_ms",
    "request_latency_ms": "serving_request_latency_ms",
}

#: shared no-op capture context for unarmed dispatches
_NULL_CAPTURE = contextlib.nullcontext()


class _SafeCapture:
    """A profiler capture that cannot fail the dispatch it observes: enter
    and exit errors (a profiler already running, an unwritable directory)
    degrade to no capture instead of failing the requests in flight."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        try:
            return self._ctx.__enter__()
        except Exception:
            self._ctx = None
            return None

    def __exit__(self, *exc):
        if self._ctx is None:
            return False
        try:
            return self._ctx.__exit__(*exc)
        except Exception:
            return False  # never replace the dispatch's own exception


def _round_ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)


@dataclass
class ServeRequest:
    """One queued prompt and, after its micro-batch ran, its outcome:
    ``status`` is ``queued`` until it becomes ``ok`` (``result`` holds the
    generated row), ``timed_out``, ``cancelled`` or ``failed`` (``error``)."""

    request_id: int
    prompt: np.ndarray  # (len,) int32, unpadded
    config: GenerationConfig
    submitted_at: float
    deadline_at: Optional[float] = None  # absolute, engine-clock seconds
    started_at: Optional[float] = None
    result: Optional[np.ndarray] = None  # (max_new_tokens,) ids, pad after EOS
    status: str = "queued"
    error: Optional[str] = None
    #: the request's trace id (None without a tracer): the join key between
    #: the serve CLI's lines and ``events.jsonl``
    trace_id: Optional[str] = None
    #: TTFT anchor on the engine clock; None is ``submitted_at``
    ttft_anchor_s: Optional[float] = None
    #: scheduling tier, higher is more important: the slot engine admits
    #: higher tiers first and, under preemption, preempts only lower tiers
    #: to admit one; the bucket engine stores it and ignores it
    priority: int = 0
    #: tenant label for the slot engine's fairness among equal tiers (the
    #: tenant holding the most pool pages yields first); None is untagged
    tenant: Optional[str] = None
    #: times the slot engine preempted this request and requeued it
    preemptions: int = 0
    #: incremental token sink, called ``on_token(index, token_id)`` as each
    #: token materialises: per token on the slot engine (a speculative
    #: burst calls it once per token, in order; a recomputed victim's replay
    #: restarts at 0), once per token at batch completion on the bucket
    #: engine. A raising sink is counted, never fails the request.
    on_token: Optional[Callable[[int, int], None]] = None

    @property
    def ttft_from_s(self) -> float:
        return self.submitted_at if self.ttft_anchor_s is None else self.ttft_anchor_s

    @property
    def done(self) -> bool:
        return self.status != "queued"


class ServingEngine:
    """Request queue and scheduler over bucketed :func:`generate` calls.

    :param model: an ``AutoregressiveSequenceModel`` on ``device``.
    :param config: default :class:`GenerationConfig` (per-request override via
        ``submit(..., config=...)``; only identical configs share a batch).
    :param table: bucket grid; defaults to powers of two up to the context.
    :param max_queue: bounded queue depth; ``submit`` past it raises
        :class:`QueueFull`. None = unbounded.
    :param default_deadline_s: deadline for requests submitted without one.
    :param clock: monotonic time source (tests inject a fake one).
    :param decode_strategy: forwarded to every ``generate`` call: ``"auto"``,
        ``"cached"``, ``"recompute"`` or None (the env var, else ``"auto"``;
        :mod:`~perceiver_io_tpu_torch.inference.decode_strategy`).
    :param generator: the sampled configs' draws, a ``torch.Generator`` on
        ``device``; None is one seeded 0 (JAX's ``rng=None`` is ``PRNGKey(0)``).
    :param chaos: optional :class:`~perceiver_io_tpu_torch.reliability.ChaosRegistry`,
        consulted at ``serving.request`` and ``serving.batch``; None skips it.
    :param registry: the metrics registry the counters and histograms live
        on; None is a private one (two engines must not double-count).
    :param tracer: optional span tracer: one trace per request, one terminal
        ``serving.request`` span per submission, one ``serving.batch`` span
        per micro-batch.
    :param profiler_trigger: optional
        :class:`~perceiver_io_tpu_torch.observability.ProfilerTrigger`, fed
        each micro-batch's execute ms (the slot engine: each decode step's);
        once armed, the next dispatch runs under ``torch.profiler``.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 table: Optional[BucketTable] = None, *, max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 decode_strategy: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, chaos=None,
                 registry: Optional[MetricsRegistry] = None, tracer: Optional[Tracer] = None,
                 profiler_trigger=None, device: DeviceLike = "cuda"):
        if decode_strategy is not None and decode_strategy not in decode_strategy_mod.MODES:
            raise ValueError(
                f"decode_strategy must be one of {decode_strategy_mod.MODES}, got {decode_strategy!r}"
            )
        self.device = resolve_device(device)
        self.decode_strategy = decode_strategy
        self.generator = generator if generator is not None else default_generator(self.device)
        self.model = model
        self.config = config or GenerationConfig()
        self.table = table or BucketTable.for_model(model)
        too_long = [L for L in self.table.prompt_lens if L > model.max_seq_len]
        if too_long:
            raise ValueError(
                f"prompt buckets {too_long} exceed the model context length {model.max_seq_len}"
            )
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self._clock = clock
        self._chaos = chaos
        self._queue: List[ServeRequest] = []
        self._next_id = 0
        self._accepting = True
        self.registry = registry if registry is not None else MetricsRegistry(clock=clock)
        self.registry.declare_counters(*STAT_ALIASES, *_EXTRA_COUNTERS)
        self.tracer = tracer
        self.profiler_trigger = profiler_trigger
        #: optional ``(name, value_ms)`` mirror of the TTFT and inter-token
        #: observations (an SLOMonitor's ``sink``)
        self.latency_sink: Optional[Callable[[str, float], None]] = None
        #: optional FlightRecorder (the slot engine's incident seams)
        self.flight_recorder = None
        #: optional StepTimeline: one record per ``step()`` pass
        self.timeline = None
        self._tl_draft: Optional[dict] = None  # the pass's events
        self._tl_marks: Optional[dict] = None  # the pass's phase marks
        #: raw latency samples in ms (:data:`SAMPLE_HISTOGRAMS`), whole
        #: lifetime; the registry's histograms keep a window of them
        self.samples: Dict[str, List[float]] = {k: [] for k in SAMPLE_HISTOGRAMS}
        self._sample_names: Dict[str, str] = dict(SAMPLE_HISTOGRAMS)

    @property
    def counters(self) -> Dict[str, int]:
        """The registry's counters, as ints (one consistent read)."""
        return {k: int(v) for k, v in self.registry.counters().items()}

    def _inc(self, name: str, by: int = 1) -> int:
        return int(self.registry.inc(name, by))

    def _sample(self, key: str, value_ms: float) -> None:
        """One latency sample: the engine's list and its registry histogram."""
        self.samples[key].append(value_ms)
        self.registry.observe(self._sample_names[key], value_ms)

    def _observe_token_latency(self, key: str, value_ms: float) -> None:
        """One TTFT or inter-token sample, mirrored to ``latency_sink``."""
        self._sample(key, value_ms)
        if self.latency_sink is not None:
            self.latency_sink(self._sample_names[key], value_ms)

    # -- scheduler timeline seams -------------------------------------------
    def _tl_event(self, kind: str, **fields) -> None:
        """One timeline event of the pass in flight (or of the next pass,
        for a call between steps such as ``cancel()``)."""
        if self.timeline is None:
            return
        if self._tl_draft is None:
            self._tl_draft = {}
        self._tl_draft.setdefault(kind, []).append(fields)

    def _tl_mark(self, key: str, value) -> None:
        if self._tl_marks is not None:
            self._tl_marks[key] = value

    def _tl_mark_clock(self, key: str) -> None:
        """A phase mark that reads the clock only while a pass is recorded,
        so an engine without a timeline reads it no more often."""
        if self._tl_marks is not None:
            self._tl_marks[key] = self._clock()

    def _run_pass(self, pass_fn):
        """Run one scheduler pass, appending its timeline record on every
        exit path."""
        if self.timeline is None:
            return pass_fn()
        t0 = self._clock()
        self._tl_marks = {}
        try:
            return pass_fn()
        finally:
            self._tl_record(t0, self._clock())

    def _tl_record(self, t0: float, t1: float) -> None:
        """The bucket engine's per-pass record; the slot engine has its own."""
        draft, self._tl_draft = self._tl_draft, None
        marks, self._tl_marks = self._tl_marks or {}, None
        phases = {"total": round((t1 - t0) * 1e3, 3)}
        for key in ("assemble_ms", "execute_ms"):
            if key in marks:
                phases[key[: -len("_ms")]] = round(marks[key], 3)
        rec = {
            "engine": "bucket",
            "t_start_s": round(t0, 6),
            "t_end_s": round(t1, 6),
            "queue_depth": len(self._queue),
            "phases_ms": phases,
        }
        rec.update(draft or {})
        self.timeline.append(rec)

    def _device_capture(self, *, step=None):
        """The context of one device dispatch: a profiler capture when the
        trigger armed on an earlier observation, else a shared no-op.
        ``step`` may be a zero-argument callable, read only when a capture
        runs."""
        trigger = self.profiler_trigger
        if trigger is None or not trigger.armed:
            return _NULL_CAPTURE
        try:
            return _SafeCapture(trigger.capture(step=step() if callable(step) else step))
        except Exception:
            return _NULL_CAPTURE

    # -- queue front --------------------------------------------------------
    def submit(self, prompt, config: Optional[GenerationConfig] = None, *,
               deadline_s: Optional[float] = None, ttft_anchor_s: Optional[float] = None,
               priority: int = 0, tenant: Optional[str] = None,
               on_token: Optional[Callable[[int, int], None]] = None) -> ServeRequest:
        """Enqueue one prompt (1-D token ids); returns its request handle.
        Raises ``ValueError`` for an infeasible prompt and :class:`QueueFull`
        when the queue is at ``max_queue``. ``priority`` (higher is more
        important) and ``tenant`` tag the request for the slot engine's
        admission order and victim policy; this engine stores them.
        ``on_token`` is the request's token sink (:attr:`ServeRequest.on_token`).
        ``ttft_anchor_s`` backdates the TTFT measurement to an earlier instant
        on the engine clock. A shed or rejected submission still ends in a
        terminal span; the raised exception carries its ``trace_id``."""
        if not self._accepting:
            raise RuntimeError("engine is draining; new submissions rejected")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = config or self.config
        try:
            self.check_feasible(prompt, cfg)
        except ValueError as e:
            self._inc("serving_requests_rejected_total")
            e.trace_id = self._terminal_event("rejected", error=str(e))
            raise
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._inc("serving_requests_shed_total")
            exc = QueueFull(
                f"queue depth {len(self._queue)} is at max_queue={self.max_queue}; "
                "request shed — drain with step() or retry after backoff"
            )
            exc.trace_id = self._terminal_event("shed", queue_depth=len(self._queue))
            raise exc
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = self._clock()
        req = ServeRequest(
            self._next_id, prompt, cfg, now,
            deadline_at=None if deadline_s is None else now + deadline_s,
            trace_id=self.tracer.new_trace_id() if self.tracer else None,
            ttft_anchor_s=ttft_anchor_s, priority=int(priority), tenant=tenant,
            on_token=on_token,
        )
        self._next_id += 1
        self._queue.append(req)
        self._inc("serving_requests_submitted_total")
        return req

    def check_feasible(self, prompt, config: Optional[GenerationConfig] = None) -> GenerationConfig:
        """Raise the ``ValueError`` ``submit`` would raise for an infeasible
        prompt (empty, longer than the largest bucket, or no bucket within
        the prefix capacity); returns the resolved config."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = config or self.config
        if prompt.size == 0:
            raise ValueError("cannot serve an empty prompt")
        if prompt.size > self.table.prompt_lens[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest bucket "
                f"{self.table.prompt_lens[-1]}; extend the bucket table or truncate the prompt"
            )
        self._pick_prompt_bucket(int(prompt.size), cfg)
        return cfg

    def _terminal_event(self, status: str, **attrs) -> Optional[str]:
        """The terminal ``serving.request`` span of a submission that never
        entered the queue (shed or rejected); returns its trace id."""
        if self.tracer is None:
            return None
        trace_id = self.tracer.new_trace_id()
        self.tracer.event("serving.request", trace_id=trace_id, status=status, **attrs)
        return trace_id

    def serve(self, prompts: Sequence, config: Optional[GenerationConfig] = None, *,
              generator: Optional[torch.Generator] = None) -> List[Optional[np.ndarray]]:
        """Submit every prompt, drain the queue, return results in order. A
        ``failed`` request re-raises here; a ``timed_out`` one gives None.
        ``generator``, when given, replaces the engine's (JAX's ``rng=``)."""
        if generator is not None:
            self.generator = generator
        reqs = [self.submit(p, config) for p in prompts]
        self.run_until_idle()
        failed = [r for r in reqs if r.status == "failed"]
        if failed:
            raise RuntimeError(
                f"{len(failed)} of {len(reqs)} served requests failed; "
                f"first error: {failed[0].error}"
            )
        return [r.result for r in reqs]

    def pending(self) -> bool:
        """True while a call to :meth:`step` has work to do: the queue depth
        here; the slot engine adds its resident slots. Drive drain loops off
        this, not off ``step()``'s return value."""
        return bool(self._queue)

    def run_until_idle(self) -> int:
        """Drain the whole queue; returns the number of requests disposed of."""
        served = 0
        while True:
            n = self.step()
            if n == 0:
                return served
            served += n

    def drain(self) -> int:
        """Graceful shutdown: stop accepting, finish every queued request."""
        self._accepting = False
        return self.run_until_idle()

    def cancel(self, request_id: int) -> bool:
        """Withdraw a queued request (it finishes ``cancelled``). A request in
        a running micro-batch cannot be interrupted. Returns True when found."""
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]
                if self.tracer is not None:
                    self.tracer.event("serving.cancelled", trace_id=req.trace_id,
                                      stage="queued", tokens_emitted=0)
                self._finish(req, "cancelled")
                return True
        return False

    # -- scheduler ----------------------------------------------------------
    def _emit_token(self, req: ServeRequest, index: int, token: int) -> None:
        """Deliver one token to the request's sink; a raising sink is
        isolated and counted."""
        try:
            req.on_token(index, token)
        except Exception:
            self._inc("serving_token_sink_errors_total")

    def _finish(self, req: ServeRequest, status: str, *, error: Optional[str] = None) -> None:
        req.status = status
        req.error = error
        self._tl_event("finished", request_id=req.request_id, status=status,
                       tenant=req.tenant, priority=req.priority)
        name = {"ok": "completed", "timed_out": "timed_out",
                "cancelled": "cancelled", "failed": "failed"}[status]
        self._inc(f"serving_requests_{name}_total")
        latency_s = self._clock() - req.submitted_at
        self._sample("request_latency_ms", latency_s * 1e3)
        if self.tracer is not None:
            # the request's one terminal span, submit to disposition, backdated
            # in the tracer's own clock domain
            span = self.tracer.start_span(
                "serving.request", trace_id=req.trace_id,
                start_s=self.tracer.now() - latency_s,
                request_id=req.request_id, prompt_len=int(req.prompt.size),
            )
            self.tracer.end_span(span, status=status, **({"error": error} if error else {}))

    def _apply_request_chaos(self, req: ServeRequest) -> bool:
        """The per-request chaos hook (``serving.request``): True when the
        fault disposed of the request (an error fails it; a hang advances an
        injectable clock and times it out past its deadline)."""
        if self._chaos is None:
            return False
        fault = self._chaos.hit("serving.request", req.request_id)
        if fault is None:
            return False
        if fault.kind == "error":
            self._finish(req, "failed", error=str(fault.make_error()))
            return True
        if fault.kind == "hang":
            advance = getattr(self._clock, "advance", None)
            if advance is not None:
                advance(fault.delay_s)
            if req.deadline_at is not None and self._clock() >= req.deadline_at:
                self._finish(req, "timed_out", error=f"hung for {fault.delay_s}s past its deadline")
                return True
        return False

    def _expire_overdue(self) -> int:
        now = self._clock()
        live, expired = [], 0
        for req in self._queue:
            if req.deadline_at is not None and now >= req.deadline_at:
                self._finish(
                    req, "timed_out",
                    error=f"deadline exceeded after {now - req.submitted_at:.3f}s in queue",
                )
                expired += 1
            else:
                live.append(req)
        self._queue = live
        return expired

    def _pick_prompt_bucket(self, length: int, cfg: GenerationConfig) -> int:
        """Smallest prompt bucket that fits ``length`` and the model's prefix
        capacity under ``cfg``."""
        max_prefix = self.model.max_prefix_len
        for cap in self.table.prompt_lens:
            if cap < length or cap - min(cap, cfg.num_latents) > max_prefix:
                continue
            return cap
        raise ValueError(
            f"no feasible prompt bucket for length {length} with "
            f"num_latents={cfg.num_latents}: buckets {self.table.prompt_lens} "
            f"must satisfy len <= {self.model.max_seq_len} and "
            f"len - num_latents <= max_prefix_len={max_prefix}"
        )

    def step(self) -> int:
        """Run ONE micro-batch: the queue head and the following requests with
        its config, packed FIFO into a bucket. Returns the number of requests
        disposed of (0 = queue empty). A chaos fault at ``serving.request``
        disposes of its request alone; a failing micro-batch (a real or a
        ``serving.batch`` fault) fails its own requests, the queue survives."""
        return self._run_pass(self._step_pass)

    def _step_pass(self) -> int:
        disposed = self._expire_overdue()
        if not self._queue:
            return disposed
        cfg = self._queue[0].config
        picked: List[ServeRequest] = []
        rest: List[ServeRequest] = []
        for req in self._queue:
            if len(picked) >= self.table.batch_sizes[-1] or req.config != cfg:
                rest.append(req)
                continue
            if self._apply_request_chaos(req):
                disposed += 1
                continue
            picked.append(req)
        self._queue = rest
        if not picked:
            return disposed

        b = self.table.batch_bucket(len(picked))
        length = self._pick_prompt_bucket(max(r.prompt.size for r in picked), cfg)
        assemble_t0 = self._clock()
        ids = np.full((b, length), cfg.pad_token_id, np.int32)
        # Filler rows claim zero pads (a full-width prompt of pad ids), so they
        # never disable the cached prefix-growth phase for the real rows.
        pad_count = np.zeros((b,), np.int32)
        now = self._clock()
        for i, req in enumerate(picked):
            ids[i, length - req.prompt.size:] = req.prompt
            pad_count[i] = length - req.prompt.size
            req.started_at = now
            self._sample("queue_wait_ms", (now - req.submitted_at) * 1e3)
        batch_index = self._inc("serving_batches_total")
        assemble_ms = (self._clock() - assemble_t0) * 1e3
        self.registry.observe("serving_batch_assembly_ms", assemble_ms)
        self._tl_mark("assemble_ms", assemble_ms)
        if self.timeline is not None:
            for req in picked:
                self._tl_event("admitted", request_id=req.request_id, tenant=req.tenant,
                               priority=req.priority, bucket=[b, length])
        batch_span = None
        if self.tracer is not None:
            batch_span = self.tracer.start_span(
                "serving.batch", batch_index=batch_index, size=len(picked),
                bucket=[b, length], assemble_ms=round(assemble_ms, 3),
                trace_ids=[r.trace_id for r in picked],
            )

        t0 = self._clock()
        try:
            fault = self._chaos.hit("serving.batch") if self._chaos else None
            if fault is not None and fault.kind == "error":
                raise fault.make_error()
            with self._device_capture(step=batch_index):
                out = generate(
                    self.model, ids, cfg, generator=self.generator, prompt_pad_count=pad_count,
                    decode_strategy=self.decode_strategy, device=self.device,
                ).cpu().numpy()
        except Exception as e:  # the micro-batch fails, the queue survives
            self._sample("device_execute_ms", (self._clock() - t0) * 1e3)
            if batch_span is not None:
                self.tracer.end_span(batch_span, status="failed", error=f"{type(e).__name__}: {e}")
            for req in picked:
                self._finish(req, "failed", error=f"{type(e).__name__}: {e}")
            return disposed + len(picked)
        # .cpu() waited for the device, so this is device time plus dispatch
        execute_ms = (self._clock() - t0) * 1e3
        self._sample("device_execute_ms", execute_ms)
        self._tl_mark("execute_ms", execute_ms)
        if self.profiler_trigger is not None:
            self.profiler_trigger.observe(execute_ms)
        if batch_span is not None:
            self.tracer.end_span(batch_span, execute_ms=round(execute_ms, 3))
        done_at = self._clock()
        itl_ms = execute_ms / max(1, cfg.max_new_tokens)
        for i, req in enumerate(picked):
            req.result = out[i]
            if req.on_token is not None:
                # the row up to and including its first EOS (pads after it
                # are filler, not generated tokens)
                toks = out[i].tolist()
                if cfg.eos_token_id is not None and cfg.eos_token_id in toks:
                    toks = toks[:toks.index(cfg.eos_token_id) + 1]
                for idx, t in enumerate(toks):
                    self._emit_token(req, idx, int(t))
            ttft_ms = (done_at - req.ttft_from_s) * 1e3
            self._observe_token_latency("ttft_ms", ttft_ms)
            self._observe_token_latency("inter_token_ms", itl_ms)
            if self.timeline is not None:
                self._tl_event("tokens", request_id=req.request_id, first=True,
                               ttft_ms=round(ttft_ms, 3), itl_ms=round(itl_ms, 3),
                               batch_granular=True)
            if self.tracer is not None:
                self.tracer.event("serving.first_token", trace_id=req.trace_id,
                                  ttft_ms=round(ttft_ms, 3), inter_token_ms=round(itl_ms, 3),
                                  batch_granular=True)
            self._finish(req, "ok")
        self._inc("serving_tokens_generated_total", len(picked) * cfg.max_new_tokens)
        self._inc("serving_prompt_tokens_real_total", sum(int(r.prompt.size) for r in picked))
        self._inc("serving_prompt_tokens_padded_total", b * length)
        self._inc("serving_decode_rows_total", b * cfg.max_new_tokens)
        self._inc("serving_decode_rows_padded_total", (b - len(picked)) * cfg.max_new_tokens)
        return disposed + len(picked)

    def warmup(self, config: Optional[GenerationConfig] = None) -> int:
        """Drive every feasible bucket cell once before traffic, with zero
        left pads and with maximal left pads (the two phase plans a cell can
        map to); returns the number of ``generate`` calls. In PyTorch nothing
        is compiled per shape, so this builds the kernels and warms the
        allocator and the matmul libraries. With ``decode_strategy="auto"``
        the boundary autotuner measures first (once per shape and platform),
        so every call runs the plan traffic will use."""
        cfg = config or self.config
        if self.decode_strategy == "auto":
            decode_strategy_mod.autotune_boundary(self.model)
        calls = 0
        for b, length in self.table.grid():
            nominal_prefix = length - min(length, cfg.num_latents)
            if nominal_prefix > self.model.max_prefix_len:
                continue
            pads = {0} | ({length - 1} if length - 1 > nominal_prefix else set())
            for pad in pads:
                ids = np.full((b, length), cfg.pad_token_id, np.int32)
                generate(self.model, ids, cfg, prompt_pad_count=np.full((b,), pad),
                         decode_strategy=self.decode_strategy, device=self.device)
                calls += 1
        return calls

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """Counters since construction, read back from the registry under
        their canonical names and the short keys of :data:`STAT_ALIASES`,
        with latency percentiles (nearest rank over the registry's window),
        the padding efficiency and the build ledger's rollup."""
        reg = self.registry
        counts = reg.counters()  # one consistent read
        out = {alias: int(counts.get(name, 0)) for name, alias in STAT_ALIASES.items()}
        out.update({name: int(v) for name, v in counts.items()})

        def pct(name: str) -> dict:
            return {"p50": _round_ms(reg.percentile(name, 50.0)),
                    "p95": _round_ms(reg.percentile(name, 95.0))}

        real = counts.get("serving_prompt_tokens_real_total", 0)
        padded = counts.get("serving_prompt_tokens_padded_total", 0)
        out.update({
            "queued": len(self._queue),
            "compile_ledger": default_ledger().rollup(),
            **{key: pct(name) for key, name in SAMPLE_HISTOGRAMS.items()},
            "prompt_padding_efficiency": round(real / max(1, padded), 4),
            "bucket_grid": {
                "prompt_lens": list(self.table.prompt_lens),
                "batch_sizes": list(self.table.batch_sizes),
            },
        })
        if self.timeline is not None:
            out["timeline"] = self.timeline.summary()
        return out

    def health(self) -> dict:
        """Readiness snapshot: ``ready`` means a submission is accepted now."""
        now = self._clock()
        depth = len(self._queue)
        reg = self.registry
        return {
            "ready": self._accepting and (self.max_queue is None or depth < self.max_queue),
            "accepting": self._accepting,
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "oldest_wait_ms": round(max(now - r.submitted_at for r in self._queue) * 1e3, 3)
            if self._queue else 0.0,
            "completed": int(reg.counter("serving_requests_completed_total")),
            "shed": int(reg.counter("serving_requests_shed_total")),
            "timed_out": int(reg.counter("serving_requests_timed_out_total")),
            "failed": int(reg.counter("serving_requests_failed_total")),
            "cancelled": int(reg.counter("serving_requests_cancelled_total")),
        }
