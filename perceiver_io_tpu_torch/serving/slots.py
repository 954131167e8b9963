"""Token-granular continuous batching: the persistent-slot decode engine.

Counterpart of ``perceiver_io_tpu/serving/slots.py``'s ``SlotServingEngine``,
for its first sub-slice. The bucket engine (:mod:`.engine`) runs whole
``generate()`` calls per micro-batch; this engine keeps a fixed-shape
resident decode state of ``S`` slots and schedules **per token**:

- **prefill**, one request at a time: the prompt is right-aligned into the
  full window, :func:`~..inference.generate._decode_prefill` runs at batch 1,
  and its caches and row state are written into a free slot;
- **decode**: one fixed-shape step advances all ``S`` slots by one token,
  with per-row ``length``/``m`` vectors
  (:func:`~..inference.generate._slot_decode_step`). Idle slots run too,
  with saturated counters; their outputs are dropped. While any resident
  row has filled its latent segment (``m == max_latents``) the step also
  runs the boundary-migration step (``decode_strategy`` "cached") or the
  windowed recompute ("recompute") and selects per row. Where JAX computes
  both steps on every row and selects with ``where``, the port's steps write
  their caches in place and take ``write_ok``, so each row's writes come
  from the step that owns it (dense: masked scatters; paged: the other
  step's writes go to the null block);
- :meth:`SlotServingEngine.step`: expire deadlines, refill free slots FIFO
  from the queue (under the paged layouts behind the pool gate, reserving
  each request's worst case), one decode step, then retire rows on EOS,
  ``max_new_tokens`` or deadline, releasing their pages.

KV layouts (``kv_layout``): ``"dense"`` keeps per-slot ``(h, N, d)`` cross
caches; ``"paged"`` and ``"paged_int8"`` keep one flat pool addressed
through per-slot block tables (:mod:`.kv_pool`); on the card the paged
attends run the ragged paged-attention kernel (K4), on the CPU the gather
reference. The latent-stack caches stay dense in every layout.

Greedy output is token-identical to per-request ``generate()`` within two
scope restrictions, enforced at ``submit``:

- ``prompt_len + max_new_tokens <= max_seq_len``: the sliding-window phase
  has no slot form; such requests go to the bucket engine;
- ``prompt_len >= min(bucket_len, num_latents)``: left pads must never
  occupy latent slots (the boundary cache's precondition).

Not ported yet (they raise ``NotImplementedError``, see ``ROADMAP.md`` A):
chunked prefill, prefix sharing, preemption and swap, speculation, the
serving mesh, the ``kv_layout="auto"`` autotuner, and sampling. There is no
tracer, chaos registry or timeline.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike
from perceiver_io_tpu_torch.inference.generate import (
    GenerationConfig,
    _boundary_cached,
    _decode_forward,
    _decode_prefill,
    _decode_step_boundary,
    _decode_step_boundary_paged,
    _on_device,
    _slot_decode_step,
    _slot_decode_step_paged,
)
from perceiver_io_tpu_torch.inference.samplers import apply_min_new_tokens, sample_logits
from perceiver_io_tpu_torch.ops import paged_attention as paged_ops
from perceiver_io_tpu_torch.serving.engine import ServeRequest, ServingEngine
from perceiver_io_tpu_torch.serving.kv_pool import KVPagePool

KV_LAYOUTS = ("dense", "paged", "paged_int8")
PAGED_KV_LAYOUTS = ("paged", "paged_int8")

_SLOT_COUNTERS = (
    "serving_decode_steps_total",
    "serving_decode_boundary_steps_total",
    "serving_prefills_total",
    "kv_pool_block_allocs_total",
    "kv_pool_block_frees_total",
    "kv_pool_admit_waits_total",
    "kv_ragged_kernel_steps_total",
)


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md A, 'Next' (the slot engine's later sub-slices)"
    )


@dataclasses.dataclass
class _Slot:
    """Host record of one resident request: emitted tokens and the mirrored
    latent count the scheduler needs without reading the device."""

    req: ServeRequest
    slot: int
    max_new: int
    m: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    last_token_at: float = 0.0


def _blank_state(model, slots: int, pad_token_id: int, device: torch.device,
                 pool_tokens: Optional[int] = None, quantized: bool = False) -> dict:
    """Zeroed persistent decode state of ``slots`` rows. ``pool_tokens``
    selects the paged layout (one flat ``(pool_tokens, h, d)`` pool instead of
    per-slot ``(h, N, d)`` cross caches); ``quantized`` stores it int8 with
    fp32 scales, whose zeros dequantize to exactly 0."""
    n, num_latents = model.max_seq_len, model.max_latents
    mha = model.perceiver_ar.cross_attention.cross_attn.attention
    h = mha.num_heads
    d = mha.num_qk_channels // h
    layers = len(model.perceiver_ar.self_attention.layers)

    def zeros(*shape, dtype=model.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def counter(fill: int = 0):
        return torch.full((slots,), fill, dtype=torch.long, device=device)

    state = {
        "window": torch.full((slots, n), pad_token_id, dtype=torch.long, device=device),
        "pad": counter(n),
        "length": counter(),
        "m": counter(),
        "steps": counter(),
        "logits": zeros(slots, model.config.vocab_size),
        "stack_k": [zeros(slots, h, num_latents, d) for _ in range(layers)],
        "stack_v": [zeros(slots, h, num_latents, d) for _ in range(layers)],
    }
    if pool_tokens is None:
        state["cross_k"] = zeros(slots, h, n, d)
        state["cross_v"] = zeros(slots, h, n, d)
    else:
        pool_dtype = torch.int8 if quantized else model.dtype
        state["pool_k"] = zeros(pool_tokens, h, d, dtype=pool_dtype)
        state["pool_v"] = zeros(pool_tokens, h, d, dtype=pool_dtype)
        if quantized:
            state["scale_k"] = zeros(pool_tokens, h, 1, dtype=torch.float32)
            state["scale_v"] = zeros(pool_tokens, h, 1, dtype=torch.float32)
    return state


def _insert_row(state: dict, slot: int, *, window, pad, logits, cache, length, m: int,
                table_row=None, block_size: Optional[int] = None) -> None:
    """Write one prefilled row (batch-1 caches and row state) into slot
    ``slot`` of the state, **in place**. Under the paged layouts the row's
    dense cross k/v scatter into the pool through the slot's block table:
    mapped positions land on its blocks, the rest on the null block."""
    if table_row is None:
        state["cross_k"][slot] = cache["cross_k"][0]
        state["cross_v"][slot] = cache["cross_v"][0]
    else:
        n = cache["cross_k"].shape[2]
        flat = paged_ops.flat_position_indices(table_row, block_size, n)
        paged_ops.scatter_kv(state["pool_k"], state.get("scale_k"), flat,
                             cache["cross_k"][0].transpose(0, 1))
        paged_ops.scatter_kv(state["pool_v"], state.get("scale_v"), flat,
                             cache["cross_v"][0].transpose(0, 1))
    for dst, src in zip(state["stack_k"] + state["stack_v"], cache["stack_k"] + cache["stack_v"]):
        dst[slot] = src[0]
    state["window"][slot] = window[0]
    state["pad"][slot] = pad[0]
    state["length"][slot] = length[0]
    state["m"][slot] = m
    state["steps"][slot] = 0
    state["logits"][slot] = logits[0]


class SlotServingEngine(ServingEngine):
    """Token-granular scheduler over the persistent-slot decode state. Shares
    the bucket engine's request surface (``submit`` / ``serve`` / ``step`` /
    ``run_until_idle`` / ``drain`` / ``cancel`` / ``stats`` / ``health``,
    bounded queue, deadlines), but ``step()`` advances ONE TOKEN across all
    slots, admitting and retiring in flight.

    :param slots: number of persistent decode slots ``S``. The bucket
        table's ``batch_sizes`` are ignored; ``prompt_lens`` are the prefill
        buckets.
    :param kv_layout: ``"dense"`` (default), ``"paged"`` or ``"paged_int8"``.
    :param kv_block_size: token positions per pool block (paged layouts;
        default ``min(16, max_seq_len)``).
    :param kv_blocks: usable pool capacity in blocks (the null block is
        extra); default: dense capacity, ``slots * ceil(max_seq_len /
        kv_block_size)``. Below that, requests whose worst case does not fit
        now wait at the queue head (``kv_pool_admit_waits_total``) and
        requests that can never fit are rejected at submit.
    :param decode_strategy: the boundary phase's step: ``"cached"`` (also
        ``"auto"`` and None) or ``"recompute"``.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None, table=None, *,
                 slots: int = 8, kv_layout: str = "dense", kv_block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None, decode_strategy: Optional[str] = None,
                 prefill_chunk: Optional[int] = None, prefix_cache: Optional[str] = None,
                 preemption: Optional[str] = None, speculation: Optional[str] = None,
                 mesh=None, device: DeviceLike = "cuda", **kwargs):
        if prefill_chunk is not None:
            raise _deferred("prefill_chunk (chunked prefill)")
        if prefix_cache not in (None, "off"):
            raise _deferred(f"prefix_cache={prefix_cache!r} (prefix sharing)")
        if preemption not in (None, "off"):
            raise _deferred(f"preemption={preemption!r} (preemption and swap)")
        if speculation not in (None, "off"):
            raise _deferred(f"speculation={speculation!r} (speculative decoding)")
        if mesh is not None:
            raise _deferred("mesh (sharded serving)")
        if kv_layout == "auto":
            raise _deferred("kv_layout='auto' (the KV-layout autotuner)")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
        super().__init__(model, config, table, decode_strategy=decode_strategy, device=device,
                         **kwargs)
        if self.config.sampling.do_sample:
            raise _deferred("sampling (do_sample=True)")
        if not _on_device(model, self.device):
            raise ValueError(f"model lies on {model.device}, the engine was asked for {self.device}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if kv_block_size is not None and kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
        if kv_blocks is not None and kv_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
        if kv_layout == "dense" and (kv_block_size is not None or kv_blocks is not None):
            raise ValueError(
                "kv_block_size/kv_blocks size the paged pool, but kv_layout is 'dense': pass "
                "kv_layout='paged' or 'paged_int8' (sizing the pool is choosing the paged layout)"
            )
        n = model.max_seq_len
        self.slots = int(slots)
        self.kv_layout = kv_layout
        self.kv_block_size = int(min(kv_block_size or min(16, n), n))
        self.kv_blocks = int(kv_blocks or self.slots * -(-n // self.kv_block_size))
        self.boundary_mode = "cached" if _boundary_cached(decode_strategy) else "recompute"
        self.counters.update(dict.fromkeys(_SLOT_COUNTERS, 0))
        self.samples.update(decode_step_ms=[], prefill_ms=[])
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._kv_waiting_id: Optional[int] = None
        if kv_layout in PAGED_KV_LAYOUTS:
            self._pool: Optional[KVPagePool] = KVPagePool(self.kv_blocks, self.kv_block_size,
                                                          self.slots, n)
            self._push_table()
        else:
            self._pool = None
            self._table_dev = None
        self._state = self._new_state()

    # -- state and pool -----------------------------------------------------
    def _new_state(self) -> dict:
        pool_tokens = None if self._pool is None else (self.kv_blocks + 1) * self.kv_block_size
        return _blank_state(self.model, self.slots, self.config.pad_token_id, self.device,
                            pool_tokens=pool_tokens, quantized=self.kv_layout == "paged_int8")

    def _push_table(self) -> None:
        """Copy the allocator's block table to the device (after it changed)."""
        self._table_dev = torch.from_numpy(self._pool.table().copy()).to(self.device)

    def _kv_release(self, slot: int, cause: str = "retire") -> None:
        if self._pool is not None:
            had_pages = self._pool.mapped_blocks(slot) > 0
            self._pool.release(slot, cause=cause)
            if had_pages:
                self._push_table()

    # -- feasibility --------------------------------------------------------
    def _pick_prompt_bucket(self, length: int, cfg: GenerationConfig) -> int:
        """Bucket choice plus the slot engine's scope checks (module docstring)."""
        if dataclasses.replace(cfg, max_new_tokens=self.config.max_new_tokens) != self.config:
            raise ValueError(
                "slot engine requests must share the engine GenerationConfig (only "
                "max_new_tokens may differ per request): one decode step serves every slot"
            )
        if cfg.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {cfg.max_new_tokens}")
        cap = super()._pick_prompt_bucket(length, cfg)
        if length + cfg.max_new_tokens > self.model.max_seq_len:
            raise ValueError(
                f"prompt length {length} + max_new_tokens {cfg.max_new_tokens} overruns the "
                f"context {self.model.max_seq_len}: the sliding-window phase has no slot form "
                "— use the bucket engine for this request"
            )
        if length < min(cap, cfg.num_latents):
            raise ValueError(
                f"prompt length {length} is shorter than the {min(cap, cfg.num_latents)} latent "
                f"positions its prompt bucket ({cap}) assigns under num_latents="
                f"{cfg.num_latents}: left pads would occupy latent slots — use the bucket "
                "engine, or configure num_latents at or below the shortest served prompt"
            )
        return cap

    def check_feasible(self, prompt, config: Optional[GenerationConfig] = None) -> GenerationConfig:
        """Base feasibility plus pool capacity: a request whose worst case
        ``prompt + max_new_tokens`` can never fit the pool is rejected here;
        one that fits the pool but not its free space now waits in the queue."""
        cfg = super().check_feasible(prompt, config)
        if self._pool is not None:
            tokens = int(np.asarray(prompt).size) + cfg.max_new_tokens
            need = self._pool.blocks_needed(tokens)
            if need > self._pool.num_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks ({tokens} positions at block size "
                    f"{self._pool.block_size}) but the pool holds {self._pool.num_blocks} "
                    "blocks: it can never be admitted — raise kv_blocks or use the dense layout"
                )
        return cfg

    # -- slot lifecycle -----------------------------------------------------
    def _active(self) -> List[_Slot]:
        return [s for s in self._slots if s is not None]

    def pending(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit(self, req: ServeRequest, slot: int) -> None:
        cfg = req.config
        prompt_len = int(req.prompt.size)
        bucket_len = self._pick_prompt_bucket(prompt_len, cfg)
        m0 = min(bucket_len, cfg.num_latents)
        n = self.model.max_seq_len
        window = torch.full((1, n), cfg.pad_token_id, dtype=torch.long)
        window[0, n - prompt_len:] = torch.from_numpy(req.prompt.astype(np.int64))
        window = window.to(self.device)
        pad = torch.full((1,), n - prompt_len, dtype=torch.long, device=self.device)
        t0 = self._clock()
        req.started_at = t0
        self.samples["queue_wait_ms"].append((t0 - req.submitted_at) * 1e3)
        table_row = None
        if self._pool is not None:
            # the gate checked capacity: reserve the worst case and map the
            # prompt's pages; decode steps map the rest as positions fill
            self._pool.reserve(slot, prompt_len + cfg.max_new_tokens)
            self._pool.ensure(slot, prompt_len)
            self._push_table()
            table_row = self._table_dev[slot]
        with torch.no_grad():
            logits, cache, length, _ = _decode_prefill(self.model, window, pad, m0)
            _insert_row(self._state, slot, window=window, pad=pad, logits=logits, cache=cache,
                        length=length, m=m0, table_row=table_row, block_size=self.kv_block_size)
        self._state["length"][slot].item()  # host sync: the prefill's time ends here
        self.samples["prefill_ms"].append((self._clock() - t0) * 1e3)
        self._inc("serving_prefills_total")
        self._inc("serving_prompt_tokens_real_total", prompt_len)
        self._inc("serving_prompt_tokens_padded_total", bucket_len)
        self._slots[slot] = _Slot(req=req, slot=slot, max_new=cfg.max_new_tokens, m=m0)

    def _retire(self, entry: _Slot, status: str, *, error: Optional[str] = None) -> None:
        if status == "ok":
            out = np.full((entry.max_new,), entry.req.config.pad_token_id, np.int32)
            out[:len(entry.emitted)] = entry.emitted
            entry.req.result = out
        self._finish(entry.req, status, error=error)
        self._slots[entry.slot] = None
        cause = {"cancelled": "cancelled", "failed": "failover"}.get(status, "retire")
        self._kv_release(entry.slot, cause=cause)

    def _fail_resident(self, error: str) -> int:
        """A step failed: every resident request fails, the queue survives,
        and the device state is rebuilt blank."""
        failed = 0
        for entry in self._active():
            self._retire(entry, "failed", error=error)
            failed += 1
        if self._pool is not None:
            self._pool.release_all()  # a half-done admission's pages too
            self._push_table()
        self._state = self._new_state()
        return failed

    def cancel(self, request_id: int) -> bool:
        """Withdraw a request: a resident one retires ``cancelled`` at once
        (its slot and pool pages are free before the next ``step()``), a
        queued one leaves the queue. Returns True when found."""
        for entry in self._active():
            if entry.req.request_id == request_id:
                self._retire(entry, "cancelled")
                return True
        return super().cancel(request_id)

    # -- the token-level scheduler ------------------------------------------
    def _decode(self, boundary: bool) -> torch.Tensor:
        """One fixed-shape token step over all slots: choose each row's token
        from the resident logits, append it, advance every cache by one
        token. ``boundary`` adds the prefix-growth step for rows with
        ``m == max_latents``. :return: ``(S,)`` chosen tokens."""
        st = self._state
        model = self.model
        n, num_latents = model.max_seq_len, model.max_latents
        cfg = self.config
        min_new = cfg.min_new_tokens if cfg.eos_token_id is not None else 0
        logits = apply_min_new_tokens(st["logits"].float(), st["steps"][:, None], min_new,
                                      cfg.eos_token_id or 0)
        pad_positions = torch.arange(n, device=self.device)[None, :] < st["pad"][:, None]
        token = sample_logits(logits, cfg.sampling, st["window"], pad_positions)
        window = torch.cat([st["window"][:, 1:], token[:, None]], dim=1)
        pad = (st["pad"] - 1).clamp(min=0)
        length, m = st["length"], st["m"]
        is_b = m >= num_latents
        cached_b = boundary and self.boundary_mode == "cached"
        # each row's writes come from the step that owns it
        write_ok = ~is_b if cached_b else None
        if self._pool is None:
            logits_a = _slot_decode_step(model, token, st, length, m, write_ok)
            if cached_b:
                logits_b = _decode_step_boundary(model, window, pad, st["cross_k"], st["cross_v"],
                                                 length, write_ok=is_b)[0]
        else:
            scales = {"scale_k": st.get("scale_k"), "scale_v": st.get("scale_v")}
            logits_a = _slot_decode_step_paged(
                model, token, st["pool_k"], st["pool_v"], self._table_dev, st, length, m,
                self.kv_block_size, write_ok, **scales,
            )
            if cached_b:
                logits_b = _decode_step_boundary_paged(
                    model, window, pad, st["pool_k"], st["pool_v"], self._table_dev, length,
                    self.kv_block_size, is_b, **scales,
                )
        if boundary and not cached_b:
            # recompute: the windowed forward; boundary rows' cross caches go
            # stale, which is safe (a row never leaves the boundary phase)
            logits_b = _decode_forward(model, window, pad, num_latents)
        new_logits = torch.where(is_b[:, None], logits_b, logits_a) if boundary else logits_a
        st.update(
            window=window, pad=pad, length=(length + 1).clamp(max=n),  # idle slots saturate
            m=(m + 1).clamp(max=num_latents), steps=st["steps"] + 1,
            logits=new_logits.to(st["logits"].dtype),
        )
        return token

    def step(self) -> int:
        """Advance serving by ONE TOKEN: expire deadlines (queued and
        resident), refill free slots FIFO from the queue, run one decode step
        over all slots, retire rows that finished (EOS / ``max_new_tokens``).
        Returns the number of requests disposed of; ``pending()`` says
        whether work remains (a mid-generation step disposes of 0)."""
        disposed = self._expire_overdue()
        now = self._clock()
        for entry in self._active():
            req = entry.req
            if req.deadline_at is not None and now >= req.deadline_at:
                self._retire(entry, "timed_out", error=(
                    f"deadline exceeded after {len(entry.emitted)} of {entry.max_new} tokens"))
                disposed += 1
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                break
            head = self._queue[0]
            if self._pool is not None:
                # FIFO pool gate: the head waits until retirements free its
                # worst case (check_feasible rejected what can never fit);
                # one wait counted per waiting request, not per poll
                need = self._pool.blocks_needed(int(head.prompt.size) + head.config.max_new_tokens)
                if not self._pool.can_reserve(need):
                    if self._kv_waiting_id != head.request_id:
                        self._kv_waiting_id = head.request_id
                        self._inc("kv_pool_admit_waits_total")
                    break
            req = self._queue.pop(0)
            try:
                self._admit(req, slot)
            except Exception as e:  # a prefill fault fails this request and the residents
                self._finish(req, "failed", error=f"{type(e).__name__}: {e}")
                return disposed + 1 + self._fail_resident(
                    f"prefill fault poisoned the slot state: {type(e).__name__}: {e}")
        active = self._active()
        if not active:
            return disposed

        num_latents = self.model.max_latents
        boundary = any(s.m >= num_latents for s in active)
        t0 = self._clock()
        try:
            if self._pool is not None:
                # map the page each row's next write lands on (infallible:
                # admission reserved the worst case)
                changed = False
                for entry in active:
                    next_len = int(entry.req.prompt.size) + len(entry.emitted) + 1
                    changed |= self._pool.ensure(entry.slot, next_len)
                if changed:
                    self._push_table()
            with torch.no_grad():
                tokens = self._decode(boundary).cpu().numpy()  # host sync: the scheduling point
        except Exception as e:
            return disposed + self._fail_resident(f"{type(e).__name__}: {e}")
        token_at = self._clock()
        self.samples["decode_step_ms"].append((token_at - t0) * 1e3)
        self._inc("serving_decode_steps_total")
        self._inc("serving_decode_boundary_steps_total", int(boundary))
        # a paged step on the card attends through K4; on the CPU through the gather
        self._inc("kv_ragged_kernel_steps_total",
                  int(self._pool is not None and self.device.type == "cuda"))
        self._inc("serving_decode_rows_total", self.slots)
        self._inc("serving_decode_rows_padded_total", self.slots - len(active))
        eos = self.config.eos_token_id
        for entry in active:
            token = int(tokens[entry.slot])
            if entry.emitted:
                self.samples["inter_token_ms"].append((token_at - entry.last_token_at) * 1e3)
            else:
                self.samples["ttft_ms"].append((token_at - entry.req.submitted_at) * 1e3)
            entry.emitted.append(token)
            entry.last_token_at = token_at
            entry.m = min(entry.m + 1, num_latents)
            if (eos is not None and token == eos) or len(entry.emitted) >= entry.max_new:
                self._retire(entry, "ok")
                disposed += 1
        self._inc("serving_tokens_generated_total", len(active))
        return disposed

    def run_until_idle(self) -> int:
        """Step until no request is queued or resident; returns the number of
        requests disposed of."""
        served = 0
        while self.pending():
            served += self.step()
        return served

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        c = self.counters
        if self._pool is not None:
            c["kv_pool_block_allocs_total"] = self._pool.allocs_total
            c["kv_pool_block_frees_total"] = self._pool.frees_total
        out = super().stats()
        rows = c["serving_decode_rows_total"]
        padded = c["serving_decode_rows_padded_total"]
        out.update({
            "engine": "slots",
            "slots": self.slots,
            "slots_active": len(self._active()),
            "decode_steps": c["serving_decode_steps_total"],
            "boundary_steps": c["serving_decode_boundary_steps_total"],
            "prefills": c["serving_prefills_total"],
            "slot_occupancy": round((rows - padded) / max(1, rows), 4),
            "decode_rows_padding_waste": round(padded / max(1, rows), 4),
            "decode_strategy_boundary": self.boundary_mode,
            "kv_layout": self.kv_layout,
        })
        if self._pool is not None:
            out["kv_pool"] = {
                **self._pool.stats(),
                "layout": self.kv_layout,
                "dtype": str(self._state["pool_k"].dtype).split(".")[-1],
                "admit_waits": c["kv_pool_admit_waits_total"],
                "ragged_kernel_steps": c["kv_ragged_kernel_steps_total"],
            }
        return out

    def health(self) -> dict:
        out = super().health()
        out["slots"] = self.slots
        out["slots_active"] = len(self._active())
        out["kv_layout"] = self.kv_layout
        if self._pool is not None:
            out["kv_pool_in_use"] = self._pool.in_use
            out["kv_pool_leaked"] = self._pool.leaked()
        return out
