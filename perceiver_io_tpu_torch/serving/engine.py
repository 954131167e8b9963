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

Chaos hooks, span tracing, the metrics registry export and the profiler
trigger belong to the telemetry layer and are not ported yet; counters and
latency samples live on the engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference import decode_strategy as decode_strategy_mod
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.samplers import default_generator
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
    "serving_token_sink_errors_total",
)


def _percentile(samples: List[float], q: float) -> Optional[float]:
    return None if not samples else round(float(np.percentile(samples, q)), 3)


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
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 table: Optional[BucketTable] = None, *, max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 decode_strategy: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = "cuda"):
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
        self._queue: List[ServeRequest] = []
        self._next_id = 0
        self._accepting = True
        self.counters: Dict[str, int] = dict.fromkeys((*STAT_ALIASES, *_EXTRA_COUNTERS), 0)
        #: latency samples in ms: queue wait, TTFT, amortised inter-token,
        #: per-batch device execute, request latency
        self.samples: Dict[str, List[float]] = {
            k: [] for k in ("queue_wait_ms", "ttft_ms", "inter_token_ms",
                            "device_execute_ms", "request_latency_ms")
        }

    def _inc(self, name: str, by: int = 1) -> int:
        self.counters[name] += by
        return self.counters[name]

    # -- queue front --------------------------------------------------------
    def submit(self, prompt, config: Optional[GenerationConfig] = None, *,
               deadline_s: Optional[float] = None, priority: int = 0,
               tenant: Optional[str] = None,
               on_token: Optional[Callable[[int, int], None]] = None) -> ServeRequest:
        """Enqueue one prompt (1-D token ids); returns its request handle.
        Raises ``ValueError`` for an infeasible prompt and :class:`QueueFull`
        when the queue is at ``max_queue``. ``priority`` (higher is more
        important) and ``tenant`` tag the request for the slot engine's
        admission order and victim policy; this engine stores them.
        ``on_token`` is the request's token sink (:attr:`ServeRequest.on_token`)."""
        if not self._accepting:
            raise RuntimeError("engine is draining; new submissions rejected")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = config or self.config
        try:
            self.check_feasible(prompt, cfg)
        except ValueError:
            self._inc("serving_requests_rejected_total")
            raise
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._inc("serving_requests_shed_total")
            raise QueueFull(
                f"queue depth {len(self._queue)} is at max_queue={self.max_queue}; "
                "request shed — drain with step() or retry after backoff"
            )
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = self._clock()
        req = ServeRequest(
            self._next_id, prompt, cfg, now,
            deadline_at=None if deadline_s is None else now + deadline_s,
            priority=int(priority), tenant=tenant, on_token=on_token,
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
        name = {"ok": "completed", "timed_out": "timed_out",
                "cancelled": "cancelled", "failed": "failed"}[status]
        self._inc(f"serving_requests_{name}_total")
        self.samples["request_latency_ms"].append((self._clock() - req.submitted_at) * 1e3)

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
        disposed of (0 = queue empty)."""
        disposed = self._expire_overdue()
        if not self._queue:
            return disposed
        cfg = self._queue[0].config
        picked: List[ServeRequest] = []
        rest: List[ServeRequest] = []
        for req in self._queue:
            if len(picked) >= self.table.batch_sizes[-1] or req.config != cfg:
                rest.append(req)
            else:
                picked.append(req)
        self._queue = rest

        b = self.table.batch_bucket(len(picked))
        length = self._pick_prompt_bucket(max(r.prompt.size for r in picked), cfg)
        ids = np.full((b, length), cfg.pad_token_id, np.int32)
        # Filler rows claim zero pads (a full-width prompt of pad ids), so they
        # never disable the cached prefix-growth phase for the real rows.
        pad_count = np.zeros((b,), np.int32)
        now = self._clock()
        for i, req in enumerate(picked):
            ids[i, length - req.prompt.size:] = req.prompt
            pad_count[i] = length - req.prompt.size
            req.started_at = now
            self.samples["queue_wait_ms"].append((now - req.submitted_at) * 1e3)
        self._inc("serving_batches_total")

        t0 = self._clock()
        try:
            out = generate(
                self.model, ids, cfg, generator=self.generator, prompt_pad_count=pad_count,
                decode_strategy=self.decode_strategy, device=self.device,
            ).cpu().numpy()
        except Exception as e:  # the micro-batch fails, the queue survives
            for req in picked:
                self._finish(req, "failed", error=f"{type(e).__name__}: {e}")
            return disposed + len(picked)
        # .cpu() waited for the device, so this is device time plus dispatch
        execute_ms = (self._clock() - t0) * 1e3
        self.samples["device_execute_ms"].append(execute_ms)
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
            self.samples["ttft_ms"].append((done_at - req.submitted_at) * 1e3)
            self.samples["inter_token_ms"].append(itl_ms)
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
        """Counters since construction, under canonical names and short keys,
        with latency percentiles and the padding efficiency."""
        c = self.counters
        out = {alias: c[name] for name, alias in STAT_ALIASES.items()}
        out.update(c)
        out.update({
            "queued": len(self._queue),
            **{key: {"p50": _percentile(v, 50.0), "p95": _percentile(v, 95.0)}
               for key, v in self.samples.items()},
            "prompt_padding_efficiency": round(
                c["serving_prompt_tokens_real_total"]
                / max(1, c["serving_prompt_tokens_padded_total"]), 4),
            "bucket_grid": {
                "prompt_lens": list(self.table.prompt_lens),
                "batch_sizes": list(self.table.batch_sizes),
            },
        })
        return out

    def health(self) -> dict:
        """Readiness snapshot: ``ready`` means a submission is accepted now."""
        now = self._clock()
        depth = len(self._queue)
        c = self.counters
        return {
            "ready": self._accepting and (self.max_queue is None or depth < self.max_queue),
            "accepting": self._accepting,
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "oldest_wait_ms": round(max(now - r.submitted_at for r in self._queue) * 1e3, 3)
            if self._queue else 0.0,
            "completed": c["serving_requests_completed_total"],
            "shed": c["serving_requests_shed_total"],
            "timed_out": c["serving_requests_timed_out_total"],
            "failed": c["serving_requests_failed_total"],
            "cancelled": c["serving_requests_cancelled_total"],
        }
