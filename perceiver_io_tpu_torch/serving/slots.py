"""Token-granular continuous batching: the persistent-slot decode engine.

Counterpart of ``perceiver_io_tpu/serving/slots.py``'s ``SlotServingEngine``.
The bucket engine (:mod:`.engine`) runs whole ``generate()`` calls per
micro-batch; this engine keeps a fixed-shape resident decode state of ``S``
slots and schedules **per token**:

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
- :meth:`SlotServingEngine.step`: expire deadlines, advance an in-flight
  chunked admission by one call, refill free slots from the queue (under
  the paged layouts behind the pool gate), one decode step, then retire
  rows on EOS, ``max_new_tokens`` or deadline, releasing their pages. The
  slot an admission is filling takes part in the decode step with its last
  occupant's counters; under the paged layouts the step's block table maps
  nothing for it, so its writes land in the null block, never in the new
  request's staged or shared pages (dense rows write their own cache row,
  which the finalize overwrites).

**Chunked prefill** (``prefill_chunk=C``): a prompt whose prefix spans more
than ``C`` positions is admitted one call per ``step()``, between the
residents' decode steps: each call projects ``C`` prefix positions
(:func:`~..inference.generate._prefill_chunk_kv`) into batch-1 staging
caches, and a last call runs the finalize (latent k/v, the attend, the
stack; :func:`~..inference.generate._prefill_finalize`) and inserts the
row. The persistent state never holds a half-built row.

**Prefix sharing** (``prefix_cache="on"``, paged layouts only): a radix
index (:class:`~.kv_pool.PrefixBlockIndex`) over published full prompt-prefix
blocks lets an admission whose leading token ids match map those pool
blocks by reference, copy-on-write the first partially usable block, and
project only the unshared suffix, straight into its private pages; a fully
hot prefix admits with the finalize alone
(:func:`~..inference.generate._prefill_finalize_paged`, K4 on the card). A
shared page is never written through (write routing and the COW guard),
blocks free on their last reference, and unreferenced cached prefixes drop
LRU-first before an admission is made to wait.

**Preemption** (``preemption="recompute" | "swap" | "auto"``, paged layouts
only): with it off, admission reserves each request's worst case
``prompt + max_new_tokens``. With it on, a request admits when its prompt
pages fit (plus ``admit_headroom_blocks``), decode pages map lazily at each
block crossing, and a crossing that finds the pool dry first drops a cached
prefix, then preempts a victim: never a higher tier than the resident that
needs the page, then the tenant holding the most pages, the most pages held,
the fewest tokens generated, the newest request; if every other request
outranks it, the resident yields itself; the last one never does. A head of
a strictly higher tier preempts lower tiers to admit. The queue is sorted by
tier (FIFO within one) when preemption is on or a request has a priority.
A victim is requeued: ``recompute`` frees its pages and replays it from its
prompt (greedy token-identical); ``swap`` first copies its pages and row
state to host tensors (:class:`~.kv_pool.SwapBundle`) and resumes it where
it stopped once its worst case fits again (a readmitted victim always
reserves its worst case, so preemptions end); ``auto`` prices both per
victim (the decode step's p50 times the tokens a replay would redo, against
the pool bytes over ``swap_link_gbps``) and takes the cheaper. A victim
taken mid-admission always recomputes. ``postmortems()`` keeps each
victim's record.

**Speculative decoding** (``speculation="k<K>d<D>"``): in place of the
decode step, a round drafts ``K`` tokens per slot from the model's first
``D`` self-attention layers and ONE lane-batched verify forward scores all
``K + 1`` positions (:mod:`~..inference.speculative`); each row advances by
its accepted burst, ``n_e`` in ``[1, K + 1]`` tokens, truncated on the host
at EOS and ``max_new_tokens``. The round decodes by windowed recompute and
leaves every KV cache as it is, so it composes with each layout, chunking,
sharing and preemption; under the paged layouts each row maps its
worst-case burst at once (``ensure_many``). Each token gets its own
``on_token`` call and ITL sample (the burst's first carries the round's
latency, the rest 0 ms). Greedy only, as in JAX (``validate_spec``).

**Sampling** (``do_sample=True``): every decode step draws one ``(S, V)``
Gumbel tensor over all slots, idle ones included, from the engine's
``torch.Generator`` (JAX splits one key per decode step and samples every
slot from it); :meth:`warmup` draws on its two warm decode steps, as JAX
splits there. Chunking, prefix sharing and preemption run unchanged; a
recomputed victim replays with fresh draws.

**Measured axes** (:mod:`~..inference.decode_strategy`): ``decode_strategy``,
``kv_layout``, ``prefix_cache`` and ``speculation`` each resolve explicit
argument > env var > registry verdict > default at construction;
:meth:`SlotServingEngine.warmup` runs the autotuners of the axes asked for
as ``"auto"`` and rebuilds onto the KV-layout verdict. ``swap_link_gbps``
starts from the platform's measured rate in the registry, and every swap
transfer records one there.

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

**Telemetry** (as in JAX, each skipped when unset): the counters, gauges
and histograms of the registry (``kv_pool_*``, ``kv_prefix_*``,
``kv_cache_resident_bytes`` counted from the state's own tensors, per-tenant
``kv_pool_tenant_blocks_in_use_*`` gauges); the tracer's per-request events
(``serving.slot_assigned``, ``serving.first_token``, ``serving.prefill_chunk``,
``serving.prefix_hit``, ``serving.preempted``, ``serving.swapped``,
``serving.restored``, ``serving.readmitted``, ``serving.slot_retired``,
``serving.cancelled``); one timeline record per ``step()`` pass; the flight
recorder's ``pool_exhausted`` (an admission waits on the pool) and
``preemption_storm`` (two victims in one step) triggers; the chaos sites
``serving.request``, ``serving.batch`` and, with preemption on,
``kv.exhaust`` (consulted once per decode step: the first page mapping of
the step raises :class:`~.kv_pool.PoolExhausted`); the profiler trigger,
fed each decode step's ms.

For the fleet (:mod:`.fleet`, :mod:`.autoscaler`): ``evacuate`` retires
every live request at once with its pages tagged by the cause, and
``resize_slots`` rebuilds an idle engine's state at another slot count.

**Serving mesh** (``mesh=``, :mod:`.sharding`): the engine runs on rank 0
of a ``data`` x ``model`` mesh of processes, one a device, and every device
op goes through :class:`_SlotDevice`, whose ops each rank of the mesh runs
on its shard (slots over ``data``, heads over ``model``; the driver sends
each op's plan to the others). Slots must divide the data axis and heads the
model axis. Greedy output equals the unsharded engine's (the row-parallel
partial sums are the only float difference), and a 1x1 mesh runs the
unsharded engine's arithmetic, state byte for byte. No trace-env
fingerprint guards the prefix index or keys the registry (the port has no
trace-env flags).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference import decode_strategy as decode_strategy_mod
from perceiver_io_tpu_torch.inference import speculative as spec_mod
from perceiver_io_tpu_torch.inference.generate import (
    GenerationConfig,
    _decode_forward,
    _decode_prefill,
    _decode_step_boundary,
    _decode_step_boundary_paged,
    _on_device,
    _prefill_chunk_kv,
    _prefill_finalize,
    _prefill_finalize_paged,
    _slot_decode_step,
    _slot_decode_step_paged,
)
from perceiver_io_tpu_torch.inference.samplers import apply_min_new_tokens, default_generator, sample_logits
from perceiver_io_tpu_torch.observability import default_ledger
from perceiver_io_tpu_torch.observability.timeline import tenant_label, tier_label
from perceiver_io_tpu_torch.ops import paged_attention as paged_ops
from perceiver_io_tpu_torch.parallel import collectives
from perceiver_io_tpu_torch.serving.engine import ServeRequest, ServingEngine, _round_ms
from perceiver_io_tpu_torch.serving.sharding import RESULT_OPS, as_serving_sharding
from perceiver_io_tpu_torch.serving.kv_pool import (
    KVPagePool,
    PoolExhausted,
    PrefixBlockIndex,
    SwapBundle,
)

PAGED_KV_LAYOUTS = decode_strategy_mod.PAGED_KV_LAYOUTS
PREEMPTION_MODES = ("off", "recompute", "swap", "auto")
#: the host link's rate (decimal GB/s) the swap cost model assumes until a
#: measured transfer refines it
SWAP_LINK_GBPS_PRIOR = 16.0

#: the slot engine's counters, declared at 0 (JAX's list; the port adds
#: ``serving_decode_boundary_steps_total``)
_SLOT_COUNTERS = (
    "serving_decode_steps_total",
    "serving_decode_rows_total",
    "serving_decode_rows_padded_total",
    "serving_prefills_total",
    "serving_prefill_chunks_total",
    "kv_pool_block_allocs_total",
    "kv_pool_block_frees_total",
    "kv_pool_admit_waits_total",
    "kv_prefix_hits_total",
    "kv_prefix_misses_total",
    "kv_prefix_shared_blocks_total",
    "kv_prefix_shared_tokens_total",
    "kv_prefix_cow_copies_total",
    "kv_prefix_evicted_blocks_total",
    "kv_prefix_published_blocks_total",
    "kv_quant_fallback_total",
    "kv_ragged_kernel_steps_total",
    "kv_preemptions_total",
    "kv_readmissions_total",
    "kv_swaps_total",
    "kv_swap_restores_total",
    "kv_swap_bytes_total",
    "spec_rounds_total",
    "spec_tokens_proposed_total",
    "spec_tokens_accepted_total",
    "spec_tokens_emitted_total",
    "serving_decode_boundary_steps_total",
)
#: the slot engine's raw sample lists -> their registry histograms (both
#: swap legs feed JAX's one ``kv_swap_ms``)
SLOT_SAMPLE_HISTOGRAMS = {
    "decode_step_ms": "serving_decode_step_ms",
    "prefill_ms": "serving_prefill_ms",
    "prefill_chunk_ms": "serving_prefill_chunk_ms",
    "swap_out_ms": "kv_swap_ms",
    "swap_in_ms": "kv_swap_ms",
}
#: the per-slot row state a swapped victim carries (besides its pages and
#: stack caches); the counters travel as int32, as the reference's state
#: holds them, and come back as the port's int64
_ROW_KEYS = ("window", "pad", "length", "m", "steps", "logits")
_ROW_HOST_DTYPES = {"window": torch.int32, "pad": torch.int32, "length": torch.int32,
                    "m": torch.int32, "steps": torch.int32}


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


@dataclasses.dataclass
class _PrefixPlan:
    """One admission's prefix-cache match: the cached full blocks it maps by
    reference, the optional partially usable block it copies on write, and
    the shared span ``shared_tokens``, where its prefill starts."""

    nodes: list  # fully shared _PrefixNode chain
    partial: Optional[object]  # COW donor node (divergent or straddling block)
    shared_tokens: int  # the prefill projects only [shared_tokens, prefix_len)


@dataclasses.dataclass
class _ChunkedAdmit:
    """One in-flight chunked admission: its reserved slot and the chunk
    schedule. Its window, pad and batch-1 staging caches (none for a shared
    admission, which stages straight into its private pool pages within
    ``[lo, hi)``) live on the device (:class:`_SlotDevice`)."""

    req: ServeRequest
    slot: int
    bucket_len: int
    m0: int
    by_index: np.ndarray  # (n,) ids by token index (prompt, then pad ids)
    offsets: List[int]  # chunk starts; one finalize call follows the last
    chunk: int
    next_chunk: int = 0
    prefill_ms: float = 0.0  # summed over the admission's calls
    plan: Optional[_PrefixPlan] = None
    lo: int = 0
    hi: int = 0


def _blank_state(model, slots: int, pad_token_id: int, device: torch.device,
                 pool_tokens: Optional[int] = None, quantized: bool = False) -> dict:
    """Zeroed persistent decode state of ``slots`` rows. ``pool_tokens``
    selects the paged layout (one flat ``(pool_tokens, h, d)`` pool instead of
    per-slot ``(h, N, d)`` cross caches); ``quantized`` stores it int8 with
    fp32 scales, whose zeros dequantize to exactly 0. A tensor-parallel
    model's state holds its share of the heads."""
    n, num_latents = model.max_seq_len, model.max_latents
    mha = model.perceiver_ar.cross_attention.cross_attn.attention
    d = mha.num_qk_channels // mha.num_heads
    h = mha.num_heads if mha.tp is None else mha.tp.local(mha.num_heads)
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


def _insert_row(state: dict, slot: Optional[int], *, window, pad, logits, cache, length, m: int,
                table_row=None, block_size: Optional[int] = None) -> None:
    """Write one prefilled row (batch-1 caches and row state) into slot
    ``slot`` of the state, **in place**. Under the paged layouts the row's
    dense cross k/v scatter into the pool through the slot's block table:
    mapped positions land on its blocks, the rest on the null block. A cache
    without cross k/v (a shared admission's) leaves the pool alone. ``slot``
    None writes the pool alone (a data rank whose rows do not hold the slot
    keeps its pool replica in step)."""
    if "cross_k" not in cache:
        pass  # the row's cross k/v already sit in its pool pages
    elif table_row is None:
        if slot is None:
            return
        state["cross_k"][slot] = cache["cross_k"][0]
        state["cross_v"][slot] = cache["cross_v"][0]
    else:
        n = cache["cross_k"].shape[2]
        flat = paged_ops.flat_position_indices(table_row, block_size, n)
        paged_ops.scatter_kv(state["pool_k"], state.get("scale_k"), flat,
                             cache["cross_k"][0].transpose(0, 1))
        paged_ops.scatter_kv(state["pool_v"], state.get("scale_v"), flat,
                             cache["cross_v"][0].transpose(0, 1))
    if slot is None:
        return
    for dst, src in zip(state["stack_k"] + state["stack_v"], cache["stack_k"] + cache["stack_v"]):
        dst[slot] = src[0]
    state["window"][slot] = window[0]
    state["pad"][slot] = pad[0]
    state["length"][slot] = length[0]
    state["m"][slot] = m
    state["steps"][slot] = 0
    state["logits"][slot] = logits[0]


def _stage_chunk(model, stage_k: torch.Tensor, stage_v: torch.Tensor, tokens: torch.Tensor,
                 offset: int) -> None:
    """An unshared chunk call: project ``C`` prefix positions into the
    admission's batch-1 staging caches, **in place**."""
    k, v = _prefill_chunk_kv(model, tokens, offset)
    c = tokens.shape[1]
    stage_k[:, :, offset:offset + c] = k.to(stage_k.dtype)
    stage_v[:, :, offset:offset + c] = v.to(stage_v.dtype)


def _stage_shared_chunk(model, state: dict, table_row: torch.Tensor, tokens: torch.Tensor,
                        offset: int, lo: int, hi: int, block_size: int) -> None:
    """A shared admission's chunk call: project ``C`` prefix positions and
    scatter those inside ``[lo, hi)`` (the unshared span) straight into the
    slot's private pool pages through its table, **in place** (quantizing
    under int8 scales). Positions outside it are dropped: a shared page is
    never written through, and a clamped chunk's overrun re-covers
    positions already staged."""
    k, v = _prefill_chunk_kv(model, tokens, offset)
    a, b = max(lo - offset, 0), min(hi - offset, tokens.shape[1])
    if a >= b:
        return
    pos = torch.arange(offset + a, offset + b, device=tokens.device)
    flat = paged_ops.flat_write_indices(table_row[None], pos[None], block_size)[0]
    paged_ops.scatter_kv(state["pool_k"], state.get("scale_k"), flat, k[0, :, a:b].transpose(0, 1))
    paged_ops.scatter_kv(state["pool_v"], state.get("scale_v"), flat, v[0, :, a:b].transpose(0, 1))


def _copy_page(state: dict, src: int, dst: int, block_size: int) -> None:
    """The device half of copy-on-write: pool block ``dst`` takes block
    ``src``'s k/v, **in place**, and under int8 its scales too (bit-exact,
    no requantization)."""
    s = slice(src * block_size, (src + 1) * block_size)
    d = slice(dst * block_size, (dst + 1) * block_size)
    for key in ("pool_k", "pool_v", "scale_k", "scale_v"):
        if key in state:
            state[key][d] = state[key][s]


def _page_positions(table_row: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat pool indices of every position of every page of a padded block
    table row, page order (unmapped pages address the null block)."""
    return paged_ops.flat_position_indices(table_row, block_size,
                                           table_row.shape[-1] * block_size).long()


def _swap_extract(state: dict, table_row: torch.Tensor, slot: Optional[int], block_size: int) -> dict:
    """The device half of swap-out: copy one slot's pool pages, through its
    **full padded** table row (int8 pages with their scales), and its row
    state and stack caches into host tensors. The copies are synchronous,
    so the gather has finished when this returns: the caller may release
    the pages, and the next admission may overwrite them. ``slot`` None
    copies the pages alone (a data rank that does not hold the row)."""
    flat = _page_positions(table_row, block_size)

    def host(x, dtype=None):
        return x.to(device="cpu", dtype=dtype, copy=True)

    out = {key: host(state[key][flat]) for key in ("pool_k", "pool_v", "scale_k", "scale_v")
           if key in state}
    out["row"] = None
    if slot is None:
        return out
    row = {key: host(state[key][slot], _ROW_HOST_DTYPES.get(key)) for key in _ROW_KEYS}
    row["stack_k"] = [host(layer[slot]) for layer in state["stack_k"]]
    row["stack_v"] = [host(layer[slot]) for layer in state["stack_v"]]
    out["row"] = row
    return out


def _payload_bytes(payload: dict, pages: bool = True, row: bool = True) -> int:
    """Bytes of a swap payload's host tensors (the transfer one way): its
    stack caches, and its pages and its other row state when asked for."""
    leaves = [v for k, v in payload.items() if k != "row"] if pages else []
    for key, value in (payload["row"] or {}).items():
        if row or key.startswith("stack_"):
            leaves.extend(value if isinstance(value, list) else [value])
    return int(sum(t.numel() * t.element_size() for t in leaves))


def _swap_restore(state: dict, payload: dict, table_row: torch.Tensor, slot: Optional[int],
                  lo_blocks: int, block_size: int) -> None:
    """The device half of swap-in, **in place**: scatter the payload's pages
    through the slot's new table row and write its row state back. Pages
    below ``lo_blocks`` (the shared prefix run, whose content never left
    the pool) and the unmapped tail go to the null block, so a shared page
    is never written through; int8 pages and scales come back bit-exact."""
    flat = _page_positions(table_row, block_size)
    pos = torch.arange(flat.numel(), device=flat.device)
    idx = torch.where(pos >= lo_blocks * block_size, flat, pos % block_size)
    for key in ("pool_k", "pool_v", "scale_k", "scale_v"):
        if key in state:
            state[key][idx] = payload[key].to(device=state[key].device, dtype=state[key].dtype)
    if slot is None:
        return
    row = payload["row"]
    for key in _ROW_KEYS:
        state[key][slot] = row[key].to(device=state[key].device, dtype=state[key].dtype)
    for name in ("stack_k", "stack_v"):
        for dst, src in zip(state[name], row[name]):
            dst[slot] = src.to(device=dst.device, dtype=dst.dtype)


class _SlotDevice:
    """One rank's share of the slot engine's device state and every op that
    touches it: the engine runs its own, and under a serving mesh each
    follower rank builds one from the driver's ``init`` plan and runs the
    same ops (:func:`~.sharding.follow`). An op's arguments are host values
    (slots are global indices); its result, where it has one, is the
    driver's.

    Without a mesh the shard is the whole state. On a mesh it holds its data
    rank's slot rows ``[row0, row0 + slots_local)`` and its model rank's
    heads; a batch-1 admission runs on every data rank (each writes its pool
    replica; the rank holding the slot writes the row), and the decode step
    all-gathers its tokens and the pool rows its data ranks wrote over the
    ``data`` group (:meth:`_sync_pool`)."""

    def __init__(self, model, config: GenerationConfig, block_size: int, device: torch.device,
                 sharding=None):
        self.model = model
        self.config = config
        self.block_size = block_size
        self.device = device
        self.sharding = sharding
        self.data_group = None if sharding is None else sharding.data_group
        self.generator = default_generator(device)
        self.state: Optional[dict] = None
        self.table: Optional[torch.Tensor] = None  # this rank's rows, on the device
        self.host_table: Optional[np.ndarray] = None  # every row, on the host
        #: the in-flight admission's window, pad and staging caches
        self.admit: Optional[dict] = None
        #: request id -> this rank's share of a swapped victim, and the slot
        #: it left
        self.payloads: Dict[int, dict] = {}
        self._swapped_from: Dict[int, int] = {}
        self.slots = self.row0 = self.slots_local = 0

    @classmethod
    def from_plan(cls, model, sharding, args: dict) -> "_SlotDevice":
        """A follower's shard from the driver's ``init`` plan."""
        return cls(sharding.put_params(model), args["config"], args["block_size"], sharding.device,
                   sharding)

    # -- geometry -------------------------------------------------------------
    def _local(self, slot: int) -> Optional[int]:
        """The local row of global ``slot``, or None when another data rank
        holds it."""
        row = slot - self.row0
        return row if 0 <= row < self.slots_local else None

    def _table_row(self, slot: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.host_table[slot])).to(self.device)

    def _sync(self) -> None:
        self.state["length"][0].item()  # host sync: the op has run

    def rebuild(self, slots: int, pool_tokens: Optional[int], quantized: bool) -> None:
        """Drop the state (and the card's cache) before allocating a blank
        one of ``slots`` rows (this rank's share)."""
        self.state = self.table = self.admit = None
        self.payloads.clear()
        self._swapped_from.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.slots = slots
        if self.sharding is None:
            self.row0, self.slots_local = 0, slots
        else:
            self.row0, self.slots_local = self.sharding.local_rows(slots)
        self._geometry = (pool_tokens, quantized)
        self.reset()

    def reset(self) -> None:
        """A blank state of the current geometry (the old one dropped first)."""
        self.state = None
        pool_tokens, quantized = self._geometry
        self.state = _blank_state(self.model, self.slots_local, self.config.pad_token_id, self.device,
                                  pool_tokens=pool_tokens, quantized=quantized)

    def set_table(self, table: np.ndarray) -> None:
        """The allocator's block table (after it changed): every row on the
        host, this rank's rows on the device."""
        self.host_table = table
        local = table if self.sharding is None else self.sharding.put_leaf("table", table)
        self.table = torch.from_numpy(np.ascontiguousarray(local)).to(self.device)

    def _row_window(self, prompt: np.ndarray):
        """The prompt's right-aligned ``(1, n)`` window and ``(1,)`` pad
        count, on the device."""
        n = self.model.max_seq_len
        window = torch.full((1, n), self.config.pad_token_id, dtype=torch.long)
        window[0, n - prompt.size:] = torch.from_numpy(prompt.astype(np.int64))
        pad = torch.full((1,), n - prompt.size, dtype=torch.long)
        return window.to(self.device), pad.to(self.device)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in slot order."""
        return t if self.data_group is None else collectives.all_gather(t, self.data_group)

    # -- admissions -----------------------------------------------------------
    def copy_page(self, src: int, dst: int) -> None:
        _copy_page(self.state, src, dst, self.block_size)

    def prefill(self, slot: int, prompt: np.ndarray, m0: int) -> None:
        """One-call admission: the batch-1 prefill, inserted into ``slot``."""
        window, pad = self._row_window(prompt)
        table_row = None if self.host_table is None else self._table_row(slot)
        with torch.no_grad():
            logits, cache, length, _ = _decode_prefill(self.model, window, pad, m0)
            _insert_row(self.state, self._local(slot), window=window, pad=pad, logits=logits,
                        cache=cache, length=length, m=m0, table_row=table_row,
                        block_size=self.block_size)
        self._sync()

    def admit_begin(self, prompt: np.ndarray, staged: bool) -> None:
        """A chunked admission's window, pad and (unshared) staging caches."""
        window, pad = self._row_window(prompt)
        self.admit = {"window": window, "pad": pad}
        if staged:
            ref = self.state["stack_k"][0]
            n = self.model.max_seq_len
            self.admit["stage_k"] = torch.zeros((1, ref.shape[1], n, ref.shape[3]), dtype=ref.dtype,
                                                device=self.device)
            self.admit["stage_v"] = torch.zeros_like(self.admit["stage_k"])

    def admit_chunk(self, slot: int, offset: int, tokens: np.ndarray, lo: int, hi: int) -> None:
        """One staging chunk: into the staging caches, or (a shared
        admission, no staging) into the slot's private pool pages."""
        ids = torch.from_numpy(tokens[None]).to(self.device)
        with torch.no_grad():
            if "stage_k" in self.admit:
                _stage_chunk(self.model, self.admit["stage_k"], self.admit["stage_v"], ids, offset)
            else:
                _stage_shared_chunk(self.model, self.state, self._table_row(slot), ids, offset, lo, hi,
                                    self.block_size)
        self._sync()

    def admit_finalize(self, slot: int, m0: int) -> None:
        """The admission's last call: the finalize inserts the row."""
        a, st, local = self.admit, self.state, self._local(slot)
        with torch.no_grad():
            if "stage_k" not in a:
                logits, cache, length, _ = _prefill_finalize_paged(
                    self.model, a["window"], a["pad"], m0, st["pool_k"], st["pool_v"],
                    self._table_row(slot), self.block_size, scale_k=st.get("scale_k"),
                    scale_v=st.get("scale_v"))
                _insert_row(st, local, window=a["window"], pad=a["pad"], logits=logits, cache=cache,
                            length=length, m=m0)
            else:
                logits, cache, length, _ = _prefill_finalize(
                    self.model, a["window"], a["pad"], m0, a["stage_k"], a["stage_v"])
                _insert_row(st, local, window=a["window"], pad=a["pad"], logits=logits, cache=cache,
                            length=length, m=m0,
                            table_row=None if self.host_table is None else self._table_row(slot),
                            block_size=self.block_size)
        self.admit = None
        self._sync()

    def admit_drop(self) -> None:
        self.admit = None

    # -- swap -----------------------------------------------------------------
    def swap_extract(self, request_id: int, slot: int, table_row: np.ndarray) -> int:
        """Copy the victim's pages and (where this rank holds it) its row to
        host tensors, kept under its request id; returns the payload's bytes
        over the whole mesh (each page and row counted once)."""
        row_t = torch.from_numpy(np.ascontiguousarray(table_row)).to(self.device)
        payload = _swap_extract(self.state, row_t, self._local(slot), self.block_size)
        self.payloads[request_id] = payload
        self._swapped_from[request_id] = slot
        sh = self.sharding
        if sh is None or sh.num_devices == 1:
            return _payload_bytes(payload)
        # pages and the stack split over model, row state replicated over it
        mine = _payload_bytes(payload, pages=sh.data_index == 0, row=sh.model_index == 0)
        return int(collectives.all_reduce(torch.tensor([mine], dtype=torch.long), sh.group)[0])

    def swap_restore(self, request_id: int, slot: int, lo_blocks: int) -> None:
        """Scatter the payload's pages through ``slot``'s table (every data
        rank, into its replica) and its row into ``slot``. A victim restored
        into another data rank's slot than the one it left takes its row
        from the rank that saved it (one broadcast over ``data``)."""
        payload = self.payloads.pop(request_id)
        left = self._swapped_from.pop(request_id)
        if self.data_group is not None and left // self.slots_local != slot // self.slots_local:
            box = [payload["row"]]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(self.data_group, left // self.slots_local), group=self.data_group)
            payload["row"] = box[0]
        with torch.no_grad():
            _swap_restore(self.state, payload, self._table_row(slot), self._local(slot), lo_blocks,
                          self.block_size)
        self._sync()  # the host-to-device leg ends here

    def drop_payload(self, request_id: int) -> None:
        self.payloads.pop(request_id, None)
        self._swapped_from.pop(request_id, None)

    # -- decode ---------------------------------------------------------------
    def _draws(self, gen_state, generator):
        """The sampled step's generator: the driver's own, or this rank's set
        to the driver's state; and the global rows this rank keeps of the
        ``(S, V)`` draw."""
        gen = generator if generator is not None else self.generator
        if gen_state is not None and generator is None:
            gen.set_state(gen_state)
        rows = None
        if self.data_group is not None:
            rows = (self.row0, self.row0 + self.slots_local, self.slots)
        return gen, rows

    def _sync_pool(self, table: torch.Tensor, length: torch.Tensor, pad: torch.Tensor,
                   migrate: Optional[torch.Tensor]) -> None:
        """Write the pool rows every data rank's rows wrote this step into
        each replica: the append at ``min(length, N - 1)`` and, for the rows
        ``migrate`` marks (cached boundary rows), the migration slot. One
        all-gather of the flat indices and one of each pool array over the
        ``data`` group; then the null block (scratch no read uses) is
        cleared, so the replicas stay byte-equal."""
        st, bs = self.state, self.block_size
        n, num_latents = self.model.max_seq_len, self.model.max_latents
        pos = [length.clamp(max=n - 1)]
        if migrate is not None:
            mig = ((n - num_latents - 1) - pad).clamp(min=0)
            pos.append(torch.where(migrate, mig, torch.zeros_like(mig)))
        flat = paged_ops.flat_write_indices(table, torch.stack(pos, dim=1), bs).long()
        if migrate is not None:
            flat[:, 1] = torch.where(migrate, flat[:, 1], torch.zeros_like(flat[:, 1]))
        idx = flat.reshape(-1)
        every = collectives.all_gather(idx, self.data_group)
        live = every >= bs
        for key in ("pool_k", "pool_v", "scale_k", "scale_v"):
            if key in st:
                rows = collectives.all_gather(st[key][idx].contiguous(), self.data_group)
                st[key][every[live]] = rows[live]
                st[key][:bs] = 0

    def decode(self, boundary: bool, cached: bool, admitting: Optional[int] = None,
               gen_state=None, generator: Optional[torch.Generator] = None):
        """One fixed-shape token step over this rank's slots (the engine's
        ``_decode``); returns ``(every slot's token (S,), the generator's
        state after a sampled step or None)``."""
        st = self.state
        model = self.model
        n, num_latents = model.max_seq_len, model.max_latents
        cfg = self.config
        min_new = cfg.min_new_tokens if cfg.eos_token_id is not None else 0
        logits = apply_min_new_tokens(st["logits"].float(), st["steps"][:, None], min_new,
                                      cfg.eos_token_id or 0)
        pad_positions = torch.arange(n, device=self.device)[None, :] < st["pad"][:, None]
        gen, rows = self._draws(gen_state, generator)
        token = sample_logits(logits, cfg.sampling, st["window"], pad_positions, generator=gen,
                              rows=rows)
        window = torch.cat([st["window"][:, 1:], token[:, None]], dim=1)
        pad = (st["pad"] - 1).clamp(min=0)
        length, m = st["length"], st["m"]
        is_b = m >= num_latents
        cached_b = boundary and cached
        # each row's writes come from the step that owns it
        write_ok = ~is_b if cached_b else None
        pooled = "pool_k" in st
        if not pooled:
            logits_a = _slot_decode_step(model, token, st, length, m, write_ok)
            if cached_b:
                logits_b = _decode_step_boundary(model, window, pad, st["cross_k"], st["cross_v"],
                                                 length, write_ok=is_b)[0]
        else:
            table = self.table
            local = None if admitting is None else self._local(admitting)
            if local is not None:
                # the slot an admission fills already maps the new request's
                # staged and shared pages, but its row still holds its last
                # occupant's counters: the step sees it map nothing, so that
                # row's appends and migrations land in the null block
                table = table.clone()
                table[local] = 0
            scales = {"scale_k": st.get("scale_k"), "scale_v": st.get("scale_v")}
            logits_a = _slot_decode_step_paged(
                model, token, st["pool_k"], st["pool_v"], table, st, length, m,
                self.block_size, write_ok, **scales,
            )
            if cached_b:
                logits_b = _decode_step_boundary_paged(
                    model, window, pad, st["pool_k"], st["pool_v"], table, length,
                    self.block_size, is_b, **scales,
                )
            if self.data_group is not None:
                self._sync_pool(table, length, pad, is_b if cached_b else None)
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
        post = gen.get_state() if gen_state is not None else None
        return self._gather(token), post

    def spec_round(self, k: int, draft_layers: int) -> tuple:
        """One speculative round over this rank's slots (the engine's
        ``_spec_round``); returns every slot's ``(cand, n_e)`` on the host."""
        st, cfg = self.state, self.config
        min_new = cfg.min_new_tokens if cfg.eos_token_id is not None else 0
        eos = cfg.eos_token_id or 0
        with torch.no_grad():
            cand = spec_mod.propose_tokens(self.model, st["window"], st["pad"], st["m"], st["steps"],
                                           st["logits"], k, draft_layers, min_new, eos)
            lane_logits = spec_mod.verify_lanes(self.model, st["window"], st["pad"], st["m"], cand)
            n_e, next_logits = spec_mod.accept_prefix(lane_logits, cand, st["steps"], min_new, eos)
            window, pad, m = spec_mod.advance_window(st["window"], st["pad"], st["m"], cand, n_e,
                                                     self.model.max_latents)
            st.update(window=window, pad=pad, m=m,
                      length=(st["length"] + n_e).clamp(max=self.model.max_seq_len),  # idle slots saturate
                      steps=st["steps"] + n_e, logits=next_logits.to(st["logits"].dtype))
        # host sync: the scheduling point
        return self._gather(cand).cpu().numpy(), self._gather(n_e).cpu().numpy()

    def digests(self) -> list:
        """``[data index, model index, digest]`` of every rank of the mesh:
        the digest is a 56-bit prefix of the SHA-256 of this rank's pool
        arrays (0 without a pool)."""
        digest = 0
        if "pool_k" in self.state:
            h = hashlib.sha256()
            for key in ("pool_k", "pool_v", "scale_k", "scale_v"):
                if key in self.state:
                    h.update(self.state[key].cpu().numpy().tobytes())
            digest = int.from_bytes(h.digest()[:7], "little")
        sh = self.sharding
        mine = torch.tensor([[0 if sh is None else sh.data_index, 0 if sh is None else sh.model_index,
                              digest]], dtype=torch.long)
        if sh is not None and sh.group is not None:
            mine = collectives.all_gather(mine, sh.group)
        return mine.tolist()

    def warmup_steps(self, prompt_lens, prefill_chunk: Optional[int], shared: bool, spec,
                     swap: bool, cached: bool, gen_state=None,
                     generator: Optional[torch.Generator] = None):
        """Each step warmup drives, once, over the live state with an
        all-zero block table (every pool write lands in the null block);
        returns ``(count, the generator's state after or None)``."""
        model, cfg, st = self.model, self.config, self.state
        n, bs = model.max_seq_len, self.block_size
        row0 = None if self.table is None else torch.zeros_like(self.table[0])
        pad_id = cfg.pad_token_id
        m0 = min(cfg.num_latents, model.max_latents)
        first = self._local(0)

        def window_of(length: int):
            window = torch.full((1, n), pad_id, dtype=torch.long, device=self.device)
            return window, torch.full((1,), n - length, dtype=torch.long, device=self.device)

        steps = 0
        with torch.no_grad():
            for bucket_len in prompt_lens:
                if bucket_len - min(bucket_len, cfg.num_latents) > model.max_prefix_len:
                    continue
                window, pad = window_of(bucket_len)
                m = min(bucket_len, cfg.num_latents)
                logits, cache, length, _ = _decode_prefill(model, window, pad, m)
                _insert_row(st, first, window=window, pad=pad, logits=logits, cache=cache,
                            length=length, m=m, table_row=row0, block_size=bs)
                steps += 1
            window, pad = window_of(n)
            if prefill_chunk is not None:
                ref = st["stack_k"][0]
                stage_k = torch.zeros((1, ref.shape[1], n, ref.shape[3]), dtype=ref.dtype,
                                      device=self.device)
                stage_v = torch.zeros_like(stage_k)
                tokens = torch.full((1, prefill_chunk), pad_id, dtype=torch.long, device=self.device)
                _stage_chunk(model, stage_k, stage_v, tokens, 0)
                _prefill_finalize(model, window, pad, m0, stage_k, stage_v)
                steps += 2
            if shared:
                _prefill_finalize_paged(model, window, pad, m0, st["pool_k"], st["pool_v"], row0, bs,
                                        scale_k=st.get("scale_k"), scale_v=st.get("scale_v"))
                _copy_page(st, 0, 0, bs)
                steps += 2
            for boundary in (False, True):
                gen_state = self.decode(boundary, cached, gen_state=gen_state, generator=generator)[1]
                steps += 1
            if spec is not None:
                self.spec_round(*spec)
                steps += 1
            if swap:
                payload = _swap_extract(st, row0, first, bs)
                _swap_restore(st, payload, row0, first, 0, bs)
                steps += 2
        self._sync()
        return steps, gen_state


class SlotServingEngine(ServingEngine):
    """Token-granular scheduler over the persistent-slot decode state. Shares
    the bucket engine's request surface (``submit`` / ``serve`` / ``step`` /
    ``run_until_idle`` / ``drain`` / ``cancel`` / ``stats`` / ``health``,
    bounded queue, deadlines), but ``step()`` advances ONE TOKEN across all
    slots, admitting and retiring in flight.

    :param slots: number of persistent decode slots ``S``. The bucket
        table's ``batch_sizes`` are ignored; ``prompt_lens`` are the prefill
        buckets.
    :param kv_layout: ``"dense"``, ``"paged"``, ``"paged_int8"`` or ``"auto"``
        (the registry verdict, measured again by :meth:`warmup`); None reads
        ``PERCEIVER_KV_LAYOUT``, else ``"auto"``, whose untuned default is dense.
    :param kv_block_size: token positions per pool block (paged layouts;
        default ``min(16, max_seq_len)``).
    :param kv_blocks: usable pool capacity in blocks (the null block is
        extra); default: dense capacity, ``slots * ceil(max_seq_len /
        kv_block_size)``. Below that, requests whose worst case does not fit
        now wait at the queue head (``kv_pool_admit_waits_total``) and
        requests that can never fit are rejected at submit.
    :param decode_strategy: the boundary phase's step: ``"cached"``,
        ``"recompute"`` or ``"auto"`` (the registry verdict, else cached);
        None reads ``PERCEIVER_DECODE_STRATEGY``, else ``"auto"``.
    :param prefill_chunk: admit prompts whose prefix spans more than this
        many positions one chunk per ``step()`` (module docstring); None
        admits every prompt in one call.
    :param prefix_cache: ``"on"`` shares published prompt-prefix blocks
        between requests (paged layouts only); ``"off"`` does not; ``"auto"``
        reads the registry (else off); None reads ``PERCEIVER_PREFIX_CACHE``.
    :param preemption: ``"off"`` (default, also None), ``"recompute"``,
        ``"swap"`` or ``"auto"`` (paged layouts only; module docstring).
    :param admit_headroom_blocks: decode blocks a lazy admission reserves
        beyond its prompt pages (0 admits on prompt pages alone).
    :param swap_link_gbps: the host link's rate (decimal GB/s) for the
        swap cost model; default the platform's rate in the registry, else
        :data:`SWAP_LINK_GBPS_PRIOR`. Every measured transfer moves it
        halfway to the measured rate and records it in the registry.
    :param speculation: ``"off"``, ``"k<K>d<D>"`` (K in {2, 4, 8}, D in
        {1, 2}) or ``"auto"`` (the registry verdict, else off; measured by
        :meth:`warmup`); None reads ``PERCEIVER_SPECULATION``. Greedy only.
    :param mesh: the serving mesh (module docstring): None (unsharded), a
        :class:`~.sharding.ServingMeshSpec`, a resolved
        :class:`~.sharding.ServingSharding`, or a
        :class:`~perceiver_io_tpu_torch.parallel.mesh.Mesh` with fsdp/seq at
        1. The engine runs on the driver rank; the device is the mesh's.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None, table=None, *,
                 slots: int = 8, kv_layout: Optional[str] = None,
                 kv_block_size: Optional[int] = None, kv_blocks: Optional[int] = None,
                 decode_strategy: Optional[str] = None, prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[str] = None, preemption: Optional[str] = None,
                 admit_headroom_blocks: int = 0, swap_link_gbps: Optional[float] = None,
                 speculation: Optional[str] = None, mesh=None, device: DeviceLike = "cuda",
                 **kwargs):
        sharding = as_serving_sharding(mesh)
        if sharding is not None:
            if sharding.data_size > 1 and slots % sharding.data_size:
                raise ValueError(
                    f"slots ({slots}) must divide evenly over the mesh data axis "
                    f"({sharding.data_size}): the decode step shards slots along it")
            heads = model.perceiver_ar.cross_attention.cross_attn.attention.num_heads
            if sharding.model_size > 1 and heads % sharding.model_size:
                raise ValueError(
                    f"attention heads ({heads}) must divide evenly over the mesh model axis "
                    f"({sharding.model_size}): the KV caches shard heads along it")
            if resolve_device(device).type != sharding.device.type:
                raise ValueError(f"the engine was asked for {device}, its mesh computes on "
                                 f"{sharding.device}")
            device = sharding.device
        if kv_layout is not None and kv_layout not in decode_strategy_mod.KV_LAYOUTS:
            raise ValueError(
                f"kv_layout must be one of {decode_strategy_mod.KV_LAYOUTS}, got {kv_layout!r}")
        if prefix_cache is not None and prefix_cache not in decode_strategy_mod.PREFIX_CACHE_MODES:
            raise ValueError(f"prefix_cache must be one of {decode_strategy_mod.PREFIX_CACHE_MODES}, "
                             f"got {prefix_cache!r}")
        if speculation is not None and speculation not in decode_strategy_mod.SPECULATION_MODES:
            raise ValueError(f"speculation must be one of {decode_strategy_mod.SPECULATION_MODES}, "
                             f"got {speculation!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if preemption is not None and preemption not in PREEMPTION_MODES:
            raise ValueError(f"preemption must be one of {PREEMPTION_MODES}, got {preemption!r}")
        if admit_headroom_blocks < 0:
            raise ValueError(f"admit_headroom_blocks must be >= 0, got {admit_headroom_blocks}")
        if swap_link_gbps is not None and swap_link_gbps <= 0:
            raise ValueError(f"swap_link_gbps must be > 0, got {swap_link_gbps}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if kv_block_size is not None and kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
        if kv_blocks is not None and kv_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
        super().__init__(model, config, table, decode_strategy=decode_strategy, device=device,
                         **kwargs)
        if not _on_device(model, self.device):
            raise ValueError(f"model lies on {model.device}, the engine was asked for {self.device}")
        self.sharding = sharding
        n = model.max_seq_len
        self.slots = int(slots)
        self.prefill_chunk = None if prefill_chunk is None else int(min(prefill_chunk, n))
        # each measured axis resolves explicit > env var > registry > default;
        # an explicit "auto" layout is measured again by warmup()
        self.kv_layout_requested = kv_layout
        #: sizing the pool is choosing a paged layout: a dense resolution
        #: would drop the budget, so it is refused, and warmup keeps the layout
        self._kv_sized = kv_block_size is not None or kv_blocks is not None
        self.kv_block_size = int(min(kv_block_size or min(16, n), n))
        self.kv_blocks = int(kv_blocks or self.slots * -(-n // self.kv_block_size))
        resolved = decode_strategy_mod.resolve_kv_layout(kv_layout, model)
        if self._kv_sized and resolved not in PAGED_KV_LAYOUTS:
            raise ValueError(
                "kv_block_size/kv_blocks size the paged pool, but the KV layout resolved to "
                f"{resolved!r}: the budget would be ignored; pass kv_layout='paged' or "
                "'paged_int8' (sizing the pool is choosing the paged layout)"
            )
        self.prefix_cache_requested = prefix_cache
        #: the resolved preference; the active ``prefix_cache`` follows the
        #: layout (only a paged pool shares), re-derived at every rebuild
        self._prefix_pref = decode_strategy_mod.resolve_prefix_cache(prefix_cache, model)
        if prefix_cache == "on" and kv_layout != "auto" and resolved not in PAGED_KV_LAYOUTS:
            raise ValueError(
                "prefix_cache='on' shares pool blocks between requests but the KV layout is "
                f"{resolved!r}: prefix sharing requires kv_layout='paged' (or 'paged_int8'; "
                "dense slots have no block tables to share)"
            )
        self.preemption = preemption or "off"
        self.admit_headroom_blocks = int(admit_headroom_blocks)
        if self.preemption != "off" and kv_layout != "auto" and resolved not in PAGED_KV_LAYOUTS:
            raise ValueError(
                f"preemption={preemption!r} admits against the block pool but the KV layout "
                f"resolved to {resolved!r} — lazy pages need kv_layout='paged' (or 'paged_int8'; "
                "dense slots reserve their worst case by construction)"
            )
        self.speculation_requested = speculation
        self.speculation = decode_strategy_mod.resolve_speculation(speculation, model)
        self._spec = spec_mod.parse_speculation(self.speculation)
        if self._spec is not None:
            spec_mod.validate_spec(self._spec, model, self.config)
        #: the swap cost model's host-link rate: explicit, else the rate
        #: measured on this platform (the registry), else the prior
        self.swap_link_gbps = float(
            swap_link_gbps if swap_link_gbps is not None
            else decode_strategy_mod.lookup_swap_gbps(self.device.type) or SWAP_LINK_GBPS_PRIOR)
        self._pinned_boundary_mode: Optional[str] = None
        self.registry.declare_counters(*_SLOT_COUNTERS)
        self._sample_names.update(SLOT_SAMPLE_HISTOGRAMS)
        self.samples.update({key: [] for key in SLOT_SAMPLE_HISTOGRAMS})
        self._tenant_gauge_keys: set = set()
        self._preempts_this_step = 0
        #: preemption accounting: victims per tier and per tenant label, the
        #: tokens each tenant label generated, and the per-victim post-mortem
        #: records (a bounded ring; the totals survive it)
        self._preempted_by_tier: Dict[int, int] = {}
        self._preempted_by_tenant: Dict[str, int] = {}
        self._tokens_by_tenant: Dict[str, int] = {}
        self._postmortems: Deque[dict] = deque(maxlen=256)
        self._postmortem_totals = {
            "count": 0, "swapped": 0, "tokens_discarded": 0, "pages_released": 0,
            "victim_bytes": 0, "recompute_est_ms": 0.0, "swap_est_ms": 0.0,
            "swap_measured_ms": 0.0,
        }
        #: request id -> the host image of a swapped-out victim awaiting readmission
        self._swap_bundles: Dict[int, SwapBundle] = {}
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._admitting: Optional[_ChunkedAdmit] = None
        self._kv_waiting_id: Optional[int] = None
        self._pool: Optional[KVPagePool] = None
        #: this rank's shard of the device state (None: a driver outside
        #: its mesh's group, whose ops run on the followers alone)
        self._dev: Optional[_SlotDevice] = None
        if sharding is None:
            self._dev = _SlotDevice(model, self.config, self.kv_block_size, self.device)
        else:
            self._op("init", config=self.config, block_size=self.kv_block_size)
            if sharding.is_member:
                self._dev = _SlotDevice(sharding.put_params(model), self.config, self.kv_block_size,
                                        self.device, sharding)
            reg = self.registry
            # mesh geometry gauges: their presence is how `obs report` knows a mesh ran
            reg.set_gauge("serving_mesh_devices", sharding.num_devices)
            reg.set_gauge("serving_mesh_data", sharding.data_size)
            reg.set_gauge("serving_mesh_model", sharding.model_size)
        self._init_kv_state(resolved)
        self._update_slot_gauges()

    @property
    def _state(self) -> Optional[dict]:
        """This rank's slot state (the whole state without a mesh)."""
        return None if self._dev is None else self._dev.state

    def _op(self, name: str, local: Optional[dict] = None, **args):
        """Run one device op: on a mesh its plan goes to the followers
        first; this rank runs it on its shard (with ``local``, arguments
        that stay on this rank). A driver outside the group reads the
        result from the group's first rank."""
        sh = self.sharding
        reply = sh is not None and not sh.is_member and name in RESULT_OPS
        if sh is not None:
            sh.send(name, {**args, "_reply": True} if reply else args)
        if name == "init":
            return None
        if reply:
            return sh.reply()
        if self._dev is None:
            return None
        return getattr(self._dev, name)(**args, **(local or {}))

    @property
    def boundary_mode(self) -> str:
        """The boundary phase's step, ``"cached"`` or ``"recompute"``
        (``decode_strategy`` > env var > registry > cached), pinned at first
        use: under recompute the boundary rows' cross caches go stale, so a
        later verdict must not swap the step under residents. ``warmup()``
        (no residents) resolves it again."""
        if self._pinned_boundary_mode is None:
            self._pinned_boundary_mode = decode_strategy_mod.resolve(
                self.decode_strategy, self.model).boundary
        return self._pinned_boundary_mode

    # -- state and pool -----------------------------------------------------
    def _init_kv_state(self, layout: str) -> None:
        """(Re)build the device state, the pool and the prefix index for
        ``layout``; the caller guarantees no residents. The old state and
        pool are dropped (and the card's cache emptied) before the new ones
        are allocated, so the card never holds two pools. Parked swap
        bundles describe the old pool and drop: their requests replay."""
        if self._pool is not None:
            for rid in list(self._swap_bundles):
                self._drop_bundle(rid, cause="swapped")
        self._pool = None
        self.kv_layout = layout
        paged = layout in PAGED_KV_LAYOUTS
        self._op("rebuild", slots=self.slots,
                 pool_tokens=(self.kv_blocks + 1) * self.kv_block_size if paged else None,
                 quantized=layout == "paged_int8")
        if paged:
            self._pool = KVPagePool(self.kv_blocks, self.kv_block_size, self.slots,
                                    self.model.max_seq_len)
            self._push_table()
            self.prefix_cache = "on" if self._prefix_pref == "on" else "off"
        else:
            self.prefix_cache = "off"
        self._prefix_index: Optional[PrefixBlockIndex] = (
            PrefixBlockIndex(self.kv_block_size) if self.prefix_cache == "on" else None)
        # bytes per cached position (k and v) and the int8 layout's fp32
        # scales, at the whole state's shapes (a mesh's shards add up to
        # them); the stack caches count in the footprint gauges but not in
        # the swap cost model
        model = self.model
        mha = model.perceiver_ar.cross_attention.cross_attn.attention
        h = mha.num_heads
        d = mha.num_qk_channels // h
        self._pool_dtype = torch.int8 if layout == "paged_int8" else model.dtype
        self._kv_token_bytes = 2 * h * d * (self._pool_dtype.itemsize if paged else model.dtype.itemsize)
        self._kv_scale_token_bytes = 2 * h * 4 if layout == "paged_int8" else 0
        self._kv_stack_bytes = (2 * len(model.perceiver_ar.self_attention.layers) * self.slots * h
                                * model.max_latents * d * model.dtype.itemsize)
        reg = self.registry
        if self._pool is not None:
            # a new pool's allocation counters start at 0
            self._kv_counter_base = {"allocs": 0, "frees": 0}
            self._kv_capacity_bytes = (
                self.kv_blocks * self.kv_block_size
                * (self._kv_token_bytes + self._kv_scale_token_bytes) + self._kv_stack_bytes)
            reg.set_gauge("kv_cache_capacity_bytes", self._kv_capacity_bytes)
            reg.set_gauge("kv_pool_blocks", self._pool.num_blocks)
            reg.set_gauge("kv_pool_block_bytes", self.kv_block_size * self._kv_token_bytes)
            reg.set_gauge("kv_pool_block_scale_bytes",
                          self.kv_block_size * self._kv_scale_token_bytes)
        else:
            self._kv_capacity_bytes = (
                self.slots * self.model.max_seq_len * self._kv_token_bytes + self._kv_stack_bytes)
            reg.set_gauge("kv_cache_capacity_bytes", self._kv_capacity_bytes)
        # K4 runs the paged attends on the card; the CPU takes the gather
        reg.set_gauge("kv_ragged_kernel_enabled",
                      int(self._pool is not None and self.device.type == "cuda"))
        self._update_kv_gauges()

    def _update_kv_gauges(self) -> None:
        """Publish the live KV footprint: under the paged layouts
        ``kv_cache_resident_bytes`` counts the mapped pages (and the dense
        stack caches), dense keeps it at capacity; the pool's gauges, the
        per-tenant page gauges and the pool's allocation counters ride along."""
        pool, reg = self._pool, self.registry
        if pool is None:
            resident = self._kv_capacity_bytes
        else:
            resident = (pool.in_use * self.kv_block_size
                        * (self._kv_token_bytes + self._kv_scale_token_bytes)
                        + self._kv_stack_bytes)
            reg.set_gauge("kv_pool_blocks_in_use", pool.in_use)
            reg.set_gauge("kv_pool_blocks_reserved", pool.reserved)
            reg.set_gauge("kv_pool_blocks_high_water", pool.high_water)
            reg.set_gauge("kv_pool_headroom_blocks", pool.headroom_blocks)
            if self._prefix_index is not None:
                reg.set_gauge("kv_prefix_cached_blocks", self._prefix_index.cached_blocks)
            live: Dict[str, int] = {}
            for tenant, held in self._tenant_pages().items():
                key = tenant_label(tenant)
                live[key] = live.get(key, 0) + held
            for key, held in live.items():
                reg.set_gauge(f"kv_pool_tenant_blocks_in_use_{key}", held)
            for key in self._tenant_gauge_keys - set(live):
                reg.set_gauge(f"kv_pool_tenant_blocks_in_use_{key}", 0)
            self._tenant_gauge_keys |= set(live)
            base = self._kv_counter_base
            if pool.allocs_total > base["allocs"]:
                reg.inc("kv_pool_block_allocs_total", pool.allocs_total - base["allocs"])
                base["allocs"] = pool.allocs_total
            if pool.frees_total > base["frees"]:
                reg.inc("kv_pool_block_frees_total", pool.frees_total - base["frees"])
                base["frees"] = pool.frees_total
        reg.set_gauge("kv_cache_resident_bytes", resident)
        if self.sharding is not None:
            # the model-axis shard of the live KV bytes (pages and stack
            # split over heads)
            reg.set_gauge("kv_cache_resident_bytes_per_shard", resident // self.sharding.model_size)
        default_ledger().set_kv_cache_bytes(resident)

    def _update_slot_gauges(self) -> None:
        active = sum(1 for s in self._slots if s is not None)
        self.registry.set_gauge("serving_slots_active", active)
        self.registry.set_gauge("serving_slots_idle", self.slots - active)

    def _push_table(self) -> None:
        """Copy the allocator's block table to the device (after it changed):
        each data rank of a mesh its rows."""
        self._op("set_table", table=self._pool.table().copy())

    def _kv_release(self, slot: int, cause: str = "retire") -> None:
        if self._pool is not None:
            had_pages = self._pool.mapped_blocks(slot) > 0
            self._pool.release(slot, cause=cause)
            if had_pages:
                self._push_table()
            self._update_kv_gauges()

    def _copy_page(self, src: int, dst: int) -> None:
        self._op("copy_page", src=int(src), dst=int(dst))
        self._inc("kv_prefix_cow_copies_total")

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
        one that fits the pool but not its free space now waits in the queue.
        The bound is blind to the prefix cache: a request's pages are all
        distinct resident blocks at once, shared or not; sharing relaxes
        only the admission gate's concurrent accounting."""
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

    def _geometry(self, req: ServeRequest) -> tuple:
        """``(bucket_len, m0, prefix_len)`` of a request."""
        length = int(req.prompt.size)
        bucket_len = self._pick_prompt_bucket(length, req.config)
        m0 = min(bucket_len, req.config.num_latents)
        return bucket_len, m0, length - m0

    # -- prefix sharing -----------------------------------------------------
    def _shared_chunk_size(self) -> int:
        """Chunk size of shared admissions: ``prefill_chunk`` when set, else
        a block-scaled default (the suffix past a hot prefix is short)."""
        n = self.model.max_seq_len
        return int(self.prefill_chunk or min(n, max(self.kv_block_size, 16)))

    def _prefix_plan(self, req: ServeRequest) -> Optional[_PrefixPlan]:
        """Match the prompt's leading ids against the prefix index and clamp
        the usable span to the request's own prefix region ``[0, L - m0)``
        (latent positions are boundary-normalised per request, and migration
        rewrites from ``L - m0`` on). None on a miss or with the cache off."""
        index = self._prefix_index
        if index is None:
            return None
        prompt = req.prompt
        prefix_len = self._geometry(req)[2]
        bs = self.kv_block_size
        if prefix_len < 1 or not index.cached_blocks:
            return None
        nodes = index.match(prompt)
        full = nodes[:prefix_len // bs]
        shared = len(full) * bs
        partial = None
        room = prefix_len - shared
        if room > 0:
            if len(nodes) > len(full):
                # the next cached block matches but straddles this request's
                # latent boundary: copy it, use its first ``room`` positions
                partial, extra = nodes[len(full)], room
            else:
                partial, extra = index.best_partial(full, prompt[:prefix_len])
                if extra < 1:
                    partial = None
            if partial is not None:
                shared += extra
        if shared < 1:
            return None
        if self.prefill_chunk is None and prefix_len - shared > 4 * self._shared_chunk_size():
            # a small hit before a long unshared suffix, with no chunk
            # discipline: draining the suffix inline as many chunk calls in
            # one step is slower than one bucket prefill; treat it as a miss
            return None
        return _PrefixPlan(nodes=full, partial=partial, shared_tokens=shared)

    def _map_shared_prefix(self, req: ServeRequest, slot: int, plan: _PrefixPlan) -> None:
        """Reserve and map a hit's pages: the matched blocks by reference
        (left out of the reservation), the partial block shared and then
        copied on write (the page copy runs before any write lands), and the
        rest of the worst case reserved privately."""
        pool = self._pool
        self._reserve_admit(slot, int(req.prompt.size), req.config.max_new_tokens,
                            shared_blocks=len(plan.nodes), pessimistic=bool(req.preemptions))
        blocks = [node.block for node in plan.nodes]
        if plan.partial is not None:
            blocks.append(plan.partial.block)
        pool.map_shared(slot, blocks)
        if plan.partial is not None:
            old, new = pool.cow(slot, len(plan.nodes), use_reservation=True)
            self._copy_page(old, new)
        # the shared and copied pages may cover every page the request will
        # touch, so no later ensure() would push the table
        self._push_table()
        self._inc("kv_prefix_hits_total")
        self._inc("kv_prefix_shared_blocks_total", len(blocks))
        self._inc("kv_prefix_shared_tokens_total", plan.shared_tokens)
        if self.tracer is not None:
            self.tracer.event("serving.prefix_hit", trace_id=req.trace_id, slot=slot,
                              shared_tokens=plan.shared_tokens, shared_blocks=len(plan.nodes),
                              cow=plan.partial is not None)

    def _publish_prefix(self, req: ServeRequest, slot: int) -> None:
        """Publish the admitted row's full prefix blocks (first donor wins).
        Runs after the finalize, so every published page holds final
        ``kv_norm``-side values the donor's decode never rewrites."""
        if self._prefix_index is None:
            return
        count = self._geometry(req)[2] // self.kv_block_size
        if count < 1:
            return
        published = self._prefix_index.insert(req.prompt, self._pool.slot_blocks(slot)[:count],
                                              self._pool)
        self._inc("kv_prefix_published_blocks_total", published)

    def _evict_for(self, need: int) -> bool:
        """LRU-drop unreferenced cached prefixes until ``need`` blocks are
        reservable: cached prefixes must never starve admissions. Returns
        True when the need is now reservable."""
        while not self._pool.can_reserve(need):
            if self._prefix_index is None or self._prefix_index.evict_one(self._pool) is None:
                return False
            self._inc("kv_prefix_evicted_blocks_total")
        return True

    def _cow_guard(self, entry: _Slot, next_len: int) -> bool:
        """A shared page is never written through: before a decode step,
        copy on write any still-shared page the step's append (or, in the
        boundary phase, migration) would land on. Unreachable under the
        publish policy (shared spans end before ``prefix_len``, writes start
        there); kept as the enforced invariant."""
        if self._prefix_index is None:
            return False
        bs = self.kv_block_size
        pages = {(next_len - 1) // bs}
        if entry.m >= self.model.max_latents:
            mig = next_len - 1 - self.model.max_latents
            if mig >= 0:
                pages.add(mig // bs)
        changed = False
        for page in sorted(pages):
            if self._pool.page_shared(entry.slot, page):
                self._copy_page(*self._pool.cow(entry.slot, page))
                changed = True
        return changed

    # -- preemption -----------------------------------------------------------
    def _reserve_admit(self, slot: int, prompt_tokens: int, max_new: int, *,
                       shared_blocks: int = 0, pessimistic: bool = False) -> None:
        """One admission's pool reservation: the worst case up front (with
        preemption off, or ``pessimistic`` for a readmitted victim) or lazily,
        the prompt pages plus ``admit_headroom_blocks`` with the worst case
        as a soft watermark (:meth:`KVPagePool.reserve_lazy`)."""
        total = prompt_tokens + max_new
        if self.preemption == "off" or pessimistic:
            self._pool.reserve(slot, total, shared_blocks=shared_blocks)
        else:
            self._pool.reserve_lazy(slot, prompt_tokens, total, headroom=self.admit_headroom_blocks,
                                    shared_blocks=shared_blocks)

    def _admit_need(self, req: ServeRequest, plan: Optional[_PrefixPlan],
                    bundle: Optional[SwapBundle] = None) -> int:
        """Blocks the gate must see reservable before ``req`` admits: its
        worst case less the blocks it maps by reference, or, under lazy
        admission, its private prompt pages plus the headroom. A request
        preempted before readmits under its worst case: lazy readmission
        could let long tails evict each other forever, while each preemption
        that moves a request to the guaranteed class bounds them by the
        request count. A swapped victim (``bundle``) maps its bundle's
        shared prefix blocks by reference."""
        if bundle is not None:
            shared = len(bundle.shared)
        else:
            shared = len(plan.nodes) if plan is not None else 0
        tokens = int(req.prompt.size) + req.config.max_new_tokens
        total = self._pool.blocks_needed(tokens) - shared
        if self.preemption == "off" or req.preemptions:
            return total
        prompt = self._pool.blocks_needed(int(req.prompt.size)) - shared
        return min(prompt + self.admit_headroom_blocks, total)

    def _tenant_pages(self) -> Dict[Optional[str], int]:
        """Pool pages held per tenant by the residents and the admission in
        flight: at equal priority the tenant holding the most yields first."""
        pages: Dict[Optional[str], int] = {}
        holders = self._active() + ([self._admitting] if self._admitting is not None else [])
        for entry in holders:
            t = entry.req.tenant
            pages[t] = pages.get(t, 0) + self._pool.mapped_blocks(entry.slot)
        return pages

    def _pick_victim(self, priority_cap: int, *, strict: bool,
                     exclude_slot: int = -1) -> Optional[Union[_Slot, _ChunkedAdmit]]:
        """The victim among the residents and the admission in flight: never
        a tier above ``priority_cap`` (nor at it when ``strict``), then the
        lowest tier, the most pages held by its tenant, the most pages held,
        the fewest tokens generated, the newest request."""
        tenant_pages = self._tenant_pages()

        def key(req: ServeRequest, slot: int, generated: int):
            return (req.priority, -tenant_pages.get(req.tenant, 0),
                    -self._pool.mapped_blocks(slot), generated, -req.request_id)

        def eligible(req: ServeRequest) -> bool:
            return req.priority < priority_cap or (not strict and req.priority == priority_cap)

        best, best_key = None, None
        for entry in self._active():
            if entry.slot == exclude_slot or not eligible(entry.req):
                continue
            k = key(entry.req, entry.slot, len(entry.emitted))
            if best_key is None or k < best_key:
                best, best_key = entry, k
        admit = self._admitting
        if admit is not None and admit.slot != exclude_slot and eligible(admit.req):
            k = key(admit.req, admit.slot, 0)
            if best_key is None or k < best_key:
                best = admit
        return best

    def _preempt_victim(self, victim: Union[_Slot, _ChunkedAdmit],
                        beneficiary: Optional[int] = None) -> None:
        """Preempt one victim and requeue its request (still ``queued``):
        every page it maps returns (shared ones are dereferenced, never
        freed under their other holders). The disposition is priced first,
        so ``auto`` and the post-mortem read the same numbers: ``recompute``
        frees the pages and discards the tokens, ``swap`` copies them to the
        host first (:meth:`_swap_out`). A victim taken mid-admission has no
        row to save: its staging caches drop and it recomputes.
        ``beneficiary`` is the request the pages go to (None: a yield)."""
        req = victim.req
        if isinstance(victim, _ChunkedAdmit):
            generated = 0
            self._admitting = None
            self._op("admit_drop")
        else:
            generated = len(victim.emitted)
            self._slots[victim.slot] = None
        pages = self._pool.mapped_blocks(victim.slot)
        # the decode step's p50 over the registry's window, as JAX reads it
        step_ms = self.registry.percentile("serving_decode_step_ms", 50.0) or 0.0
        victim_bytes = pages * self.kv_block_size * (self._kv_token_bytes
                                                     + self._kv_scale_token_bytes)
        recompute_ms = generated * step_ms
        swap_ms = victim_bytes / (self.swap_link_gbps * 1e9) * 1e3
        mode = "recompute"
        if not isinstance(victim, _ChunkedAdmit) and (
                self.preemption == "swap" or (self.preemption == "auto" and swap_ms < recompute_ms)):
            mode = "swap"
        swap_out = self._swap_out(victim) if mode == "swap" else None
        if swap_out is None:
            self._kv_release(victim.slot, cause="preempted")
        req.preemptions += 1
        req.started_at = None
        self._queue.append(req)  # the next admission pass sorts the queue
        self._preempts_this_step += 1
        self._inc("kv_preemptions_total")
        tier = int(req.priority)
        self._inc(f"kv_preemptions_tier_{tier_label(tier)}_total")
        self._preempted_by_tier[tier] = self._preempted_by_tier.get(tier, 0) + 1
        tkey = tenant_label(req.tenant)
        self._preempted_by_tenant[tkey] = self._preempted_by_tenant.get(tkey, 0) + 1
        pm = {
            "request_id": req.request_id, "tenant": req.tenant, "priority": tier,
            "slot": victim.slot, "mode": mode,
            # under swap nothing is discarded: the cost model's input
            "tokens_discarded": generated, "pages_released": pages,
            "victim_bytes": int(victim_bytes), "decode_step_ms": round(step_ms, 3),
            "recompute_est_ms": round(recompute_ms, 3), "swap_est_ms": round(swap_ms, 3),
            "swap_advantage_ms": round(recompute_ms - swap_ms, 3),
        }
        if swap_out is not None:
            pm["swap_measured_ms"] = round(swap_out["ms"], 3)
            pm["payload_bytes"] = swap_out["bytes"]
        self._postmortems.append(pm)
        totals = self._postmortem_totals
        totals["count"] += 1
        totals["swapped"] += int(mode == "swap")
        totals["tokens_discarded"] += generated
        totals["pages_released"] += pages
        totals["victim_bytes"] += int(victim_bytes)
        totals["recompute_est_ms"] += recompute_ms
        totals["swap_est_ms"] += swap_ms
        if swap_out is not None:
            totals["swap_measured_ms"] += swap_out["ms"]
        self._tl_event("preempted", request_id=req.request_id, slot=victim.slot,
                       tenant=req.tenant, priority=tier, mode=mode, tokens_discarded=generated,
                       pages_released=pages, beneficiary=beneficiary)
        self._update_slot_gauges()
        if self.tracer is not None:
            self.tracer.event("serving.preempted", trace_id=req.trace_id, slot=victim.slot,
                              priority=tier, tenant=req.tenant, mode=mode, pages_released=pages,
                              tokens_discarded=generated, beneficiary=beneficiary)
        if self._preempts_this_step == 2 and self.flight_recorder is not None:
            # two victims in one scheduling instant: the pool is thrashing
            pool = self._pool.stats()
            self.flight_recorder.trigger(
                "preemption_storm",
                f"{self._preempts_this_step} residents preempted in one step: pool "
                f"{pool['in_use']}/{pool['blocks']} blocks in use — sustained memory "
                "pressure, not a long tail",
                trace_ids=[req.trace_id] if req.trace_id else [],
                blocks=pool["blocks"], blocks_in_use=pool["in_use"],
            )

    def _swap_out(self, victim: _Slot) -> dict:
        """Copy the victim's pages and row state to the host, then release
        its blocks (``frees_by_cause["swapped"]``; its leading shared blocks
        keep one bundle reference each, so their content stays in the pool)
        and park the :class:`SwapBundle` under its request id. The copy runs
        before the release: once freed, the pages may be reused by the next
        admission. Returns ``{"bytes", "ms"}`` of the measured transfer."""
        req, slot, pool = victim.req, victim.slot, self._pool
        t0 = self._clock()
        # the host table's row: this step's ensure loop may not have pushed it yet
        bytes_moved = int(self._op("swap_extract", request_id=req.request_id, slot=slot,
                                   table_row=np.array(pool.table_row(slot))))
        wall = self._clock() - t0
        shared, private = pool.extract(slot, cause="swapped")
        self._push_table()
        self._update_kv_gauges()
        # the payload stays with each rank's shard (_SlotDevice.payloads)
        self._swap_bundles[req.request_id] = SwapBundle(
            request_id=req.request_id, shared=shared, n_private=len(private),
            tokens=int(req.prompt.size) + len(victim.emitted), emitted=list(victim.emitted),
            m=int(victim.m), last_token_at=victim.last_token_at, bytes_moved=bytes_moved,
        )
        ms = wall * 1e3
        self._inc("kv_swaps_total")
        self._inc("kv_swap_bytes_total", bytes_moved)
        self._sample("swap_out_ms", ms)
        self._calibrate_swap(bytes_moved, wall)
        self._tl_event("swapped", request_id=req.request_id, slot=slot, tenant=req.tenant,
                       pages=len(shared) + len(private), shared_blocks=len(shared),
                       bytes=bytes_moved, ms=_round_ms(ms))
        if self.tracer is not None:
            self.tracer.event("serving.swapped", trace_id=req.trace_id, slot=slot,
                              pages=len(shared) + len(private), bytes=bytes_moved,
                              ms=_round_ms(ms))
        return {"bytes": bytes_moved, "ms": ms}

    def _restore_admit(self, req: ServeRequest, slot: int, bundle: SwapBundle) -> None:
        """Readmit a swapped victim without replay: reserve its worst case,
        map its shared run by reference and fresh private pages for its
        resident positions, scatter the payload through the new table row and
        resume it where it stopped (its tokens, latent count and last token
        time come back, so its next step samples the logits it was preempted
        with)."""
        pool = self._pool
        self._start_admit(req, slot)
        try:
            pool.restore(slot, bundle.shared, int(req.prompt.size) + req.config.max_new_tokens,
                         bundle.tokens)
        except BaseException:
            # the pool is untouched; the caller fails the request, so the
            # bundle's references must drop here
            self._release_bundle(bundle, cause="failover")
            raise
        pool.set_owner(slot, tenant_label(req.tenant))
        for block in bundle.shared:  # the slot holds its own references now
            pool.deref(block, cause="swapped")
        self._push_table()
        self._update_kv_gauges()
        t1 = self._clock()
        self._op("swap_restore", request_id=req.request_id, slot=slot, lo_blocks=len(bundle.shared))
        wall = self._clock() - t1
        ms = wall * 1e3
        self._inc("kv_swap_restores_total")
        self._inc("kv_swap_bytes_total", bundle.bytes_moved)
        self._sample("swap_in_ms", ms)
        self._calibrate_swap(bundle.bytes_moved, wall)
        self._slots[slot] = _Slot(req=req, slot=slot, max_new=req.config.max_new_tokens,
                                  m=int(bundle.m), emitted=list(bundle.emitted),
                                  last_token_at=bundle.last_token_at)
        self._tl_event("restored", request_id=req.request_id, slot=slot, tenant=req.tenant,
                       pages=pool.mapped_blocks(slot), shared_blocks=len(bundle.shared),
                       tokens_resident=bundle.tokens, bytes=bundle.bytes_moved, ms=_round_ms(ms))
        if self.tracer is not None:
            self.tracer.event("serving.restored", trace_id=req.trace_id, slot=slot,
                              pages=pool.mapped_blocks(slot), tokens=bundle.tokens,
                              bytes=bundle.bytes_moved, ms=_round_ms(ms))

    def _calibrate_swap(self, bytes_moved: int, seconds: float) -> None:
        """Move the link-rate model halfway to one measured transfer's rate
        and record it in the platform's swap-rate registry, so a later
        engine (or process, through the registry file) starts from it.
        Zero-length measurements (a frozen test clock) are skipped."""
        if seconds <= 0 or bytes_moved <= 0:
            return
        measured = bytes_moved / (seconds * 1e9)
        self.swap_link_gbps = round(0.5 * self.swap_link_gbps + 0.5 * measured, 6)
        decode_strategy_mod.record_swap_gbps(
            self.swap_link_gbps, platform=self.device.type, bytes_moved=int(bytes_moved),
            last_transfer_ms=round(seconds * 1e3, 3))

    def _release_bundle(self, bundle: SwapBundle, cause: str) -> None:
        """Drop a parked bundle's references on its shared blocks (it may
        hold the last one of a block the prefix index evicted meanwhile)."""
        for block in bundle.shared:
            self._pool.deref(block, cause=cause)
        if bundle.shared:
            self._update_kv_gauges()

    def _drop_bundle(self, request_id: int, cause: str) -> None:
        """Drop the parked bundle of a request that left the queue other
        than by its restore."""
        bundle = self._swap_bundles.pop(request_id, None)
        if bundle is not None:
            self._op("drop_payload", request_id=request_id)
            self._release_bundle(bundle, cause=cause)

    def shard_digests(self) -> list:
        """``[data index, model index, digest]`` of every rank's shard: the
        digest of its pool replica (:meth:`_SlotDevice.digests`). Data
        replicas of one model index hold byte-equal pools."""
        return self._op("digests")

    def postmortems(self) -> dict:
        """The preemption post-mortems: lifetime recompute-against-swap
        totals and the last few per-victim records."""
        totals = self._postmortem_totals
        return {
            "count": totals["count"],
            "swapped": totals["swapped"],
            "tokens_discarded": totals["tokens_discarded"],
            "pages_released": totals["pages_released"],
            "victim_bytes": totals["victim_bytes"],
            "recompute_est_ms": round(totals["recompute_est_ms"], 3),
            "swap_est_ms": round(totals["swap_est_ms"], 3),
            "swap_measured_ms": round(totals["swap_measured_ms"], 3),
            "swap_advantage_ms": round(totals["recompute_est_ms"] - totals["swap_est_ms"], 3),
            "swap_link_gbps": self.swap_link_gbps,
            "swapped_waiting": len(self._swap_bundles),
            "recent": list(self._postmortems)[-8:],
        }

    def _preempt_lower_tier(self, head: ServeRequest) -> bool:
        """Admission-time preemption: a head of a strictly higher tier may
        preempt a lower one; equal tiers wait FIFO."""
        victim = self._pick_victim(head.priority, strict=True)
        if victim is None:
            return False
        self._preempt_victim(victim, beneficiary=head.request_id)
        return True

    def _reclaim_decode_page(self, entry: _Slot) -> str:
        """A resident crossing a block boundary found the pool dry: drop an
        unreferenced cached prefix block, else preempt a victim at or below
        its tier, else (every other live request outranks it) it yields.
        Returns ``"reclaimed"`` (retry the mapping), ``"yielded"`` (the
        entry is gone) or ``"stuck"`` (it is the last live request, which is
        never preempted; unreachable while submit bounds one request's
        need)."""
        index = self._prefix_index
        while index is not None:
            freed = index.evict_one(self._pool)
            if freed is None:
                break
            self._inc("kv_prefix_evicted_blocks_total")
            if freed:
                return "reclaimed"
        victim = self._pick_victim(entry.req.priority, strict=False, exclude_slot=entry.slot)
        if victim is not None:
            self._preempt_victim(victim, beneficiary=entry.req.request_id)
            return "reclaimed"
        if self._admitting is not None or len(self._active()) > 1:
            self._preempt_victim(entry, beneficiary=None)
            return "yielded"
        return "stuck"

    # -- slot lifecycle -----------------------------------------------------
    def _active(self) -> List[_Slot]:
        return [s for s in self._slots if s is not None]

    def pending(self) -> bool:
        return (bool(self._queue) or self._admitting is not None
                or any(s is not None for s in self._slots))

    def _free_slot(self) -> Optional[int]:
        """Lowest free slot, other than the one an admission is filling."""
        reserved = self._admitting.slot if self._admitting is not None else -1
        for i, s in enumerate(self._slots):
            if s is None and i != reserved:
                return i
        return None

    def _chunk_eligible(self, req: ServeRequest, plan: Optional[_PrefixPlan] = None) -> bool:
        """True when ``req`` should be admitted chunk by chunk: chunking is
        on and its (unshared) prefix spans more than one chunk."""
        if self.prefill_chunk is None:
            return False
        prefix_len = self._geometry(req)[2]
        if plan is not None:
            prefix_len -= plan.shared_tokens
        return prefix_len > self.prefill_chunk

    def _start_admit(self, req: ServeRequest, slot: int) -> float:
        """Queue wait ends when the prefill (or a swapped victim's restore)
        starts; returns that instant. A preempted request counts a
        readmission into ``slot``."""
        t0 = self._clock()
        req.started_at = t0
        self._sample("queue_wait_ms", (t0 - req.submitted_at) * 1e3)
        if req.preemptions:
            self._inc("kv_readmissions_total")
            self._tl_event("readmitted", request_id=req.request_id, slot=slot,
                           tenant=req.tenant, preemptions=req.preemptions)
            if self.tracer is not None:
                self.tracer.event("serving.readmitted", trace_id=req.trace_id, slot=slot,
                                  preemptions=req.preemptions)
        return t0

    def _finish_admit(self, req: ServeRequest, slot: int, bucket_len: int, m0: int,
                      prefill_ms: float, hit: bool, chunks: Optional[int] = None) -> None:
        """The row is in the state: count the prefill, make the slot
        resident, and publish its prefix (a hit publishes its extension).
        ``chunks`` is a chunked admission's call count (None: one prefill)."""
        self._sample("prefill_ms", prefill_ms)
        if chunks is not None:
            self.registry.observe("serving_prefill_chunks", chunks)
        self._inc("serving_prefills_total")
        self._inc("serving_prompt_tokens_real_total", int(req.prompt.size))
        self._inc("serving_prompt_tokens_padded_total", bucket_len)
        self._slots[slot] = _Slot(req=req, slot=slot, max_new=req.config.max_new_tokens, m=m0)
        self._tl_event("admitted", request_id=req.request_id, slot=slot, tenant=req.tenant,
                       priority=req.priority, chunks=chunks or 0)
        if self.tracer is not None:
            extra = {} if chunks is None else {"chunks": chunks}
            self.tracer.event("serving.slot_assigned", trace_id=req.trace_id, slot=slot,
                              bucket=bucket_len, prefill_ms=round(prefill_ms, 3), **extra)
        if self._prefix_index is not None:
            if not hit:
                self._inc("kv_prefix_misses_total")
            self._publish_prefix(req, slot)

    def _admit(self, req: ServeRequest, slot: int, plan: Optional[_PrefixPlan] = None) -> None:
        if plan is not None:
            # a hit whose suffix fits one step: the whole shared admission
            # (mapping, staged suffix chunks, finalize) runs inline through
            # the chunked machinery; a fault clears the record before the
            # caller's handler rebuilds the state
            try:
                self._start_chunked_admit(req, slot, plan)
                while self._admitting is not None:
                    self._advance_chunked_admit()
            except Exception:
                self._admitting = None
                raise
            return
        cfg = req.config
        prompt_len = int(req.prompt.size)
        bucket_len, m0, _ = self._geometry(req)
        t0 = self._start_admit(req, slot)
        if self._pool is not None:
            # the gate checked capacity: reserve (the worst case, or lazily
            # the prompt's pages) and map the prompt's pages; decode steps
            # map the rest as positions fill
            self._reserve_admit(slot, prompt_len, cfg.max_new_tokens,
                                pessimistic=bool(req.preemptions))
            self._pool.set_owner(slot, tenant_label(req.tenant))
            self._pool.ensure(slot, prompt_len)
            self._push_table()
        # ends in a host sync: the prefill's time ends there
        self._op("prefill", slot=slot, prompt=req.prompt, m0=m0)
        self._finish_admit(req, slot, bucket_len, m0, (self._clock() - t0) * 1e3, hit=False)

    def _start_chunked_admit(self, req: ServeRequest, slot: int,
                             plan: Optional[_PrefixPlan] = None) -> None:
        """Begin a chunked admission into ``slot``: the row's window and
        chunk schedule, the pool reservation, fresh batch-1 staging caches
        (unshared) or the hit's mapped pages (shared), then the first call.
        Later calls advance one per ``step()``; a shared admission's chunks
        cover only the unshared suffix ``[shared_tokens, prefix_len)``, and a
        fully hot prefix schedules none, only the finalize."""
        n = self.model.max_seq_len
        prompt_len = int(req.prompt.size)
        bucket_len, m0, prefix_len = self._geometry(req)
        by_index = np.full((n,), req.config.pad_token_id, np.int64)
        by_index[:prompt_len] = req.prompt
        chunk = self._shared_chunk_size() if plan is not None else self.prefill_chunk
        # starts are clamped so a fixed-size chunk never runs past the
        # context: an overrunning chunk re-covers staged positions with the
        # same values (dropped on the shared path), and latent or future
        # positions it grazes are rewritten by the finalize or masked
        start = plan.shared_tokens if plan is not None else 0
        offsets = [min(o, n - chunk) for o in range(start, max(prefix_len, 1), chunk)]
        self._start_admit(req, slot)
        if self._pool is not None:
            self._pool.set_owner(slot, tenant_label(req.tenant))
        if plan is not None:
            self._map_shared_prefix(req, slot, plan)
        elif self._pool is not None:
            # reserved now (the worst case, or lazily the prompt's pages);
            # pages map chunk by chunk
            self._reserve_admit(slot, prompt_len, req.config.max_new_tokens,
                                pessimistic=bool(req.preemptions))
        # the row's window and pad, and (unshared) fresh staging caches
        self._op("admit_begin", prompt=req.prompt, staged=plan is None)
        self._admitting = _ChunkedAdmit(
            req=req, slot=slot, bucket_len=bucket_len, m0=m0,
            by_index=by_index, offsets=offsets, chunk=chunk,
            plan=plan, lo=start, hi=prefix_len if plan is not None else 0,
        )
        self._advance_chunked_admit()

    def _advance_chunked_admit(self) -> None:
        """Run the in-flight admission's next call: one staging chunk, or,
        after the last, the finalize, which inserts the row. The finalize is
        a call of its own, so the admission's worst stall between two decode
        steps is max(one chunk, one finalize)."""
        admit = self._admitting
        req, slot = admit.req, admit.slot
        i = admit.next_chunk
        final = i == len(admit.offsets)
        prompt_len = int(req.prompt.size)
        off = 0 if final else admit.offsets[i]
        if self._pool is not None:
            # map the pages this call's positions cover; the finalize needs
            # the whole prompt mapped (shared pages are mapped already)
            if self._pool.ensure(slot, prompt_len if final else min(off + admit.chunk, prompt_len)):
                self._push_table()
        t0 = self._clock()
        # each call ends in a host sync: its time ends there
        if not final:
            self._op("admit_chunk", slot=slot, offset=off, tokens=admit.by_index[off:off + admit.chunk],
                     lo=admit.lo, hi=admit.hi)
        else:
            self._op("admit_finalize", slot=slot, m0=admit.m0)
        call_ms = (self._clock() - t0) * 1e3
        admit.prefill_ms += call_ms
        admit.next_chunk += 1
        self._sample("prefill_chunk_ms", call_ms)
        if not final:
            self._inc("serving_prefill_chunks_total")
        self._tl_event("chunks", request_id=req.request_id, slot=slot, chunk=i, final=final,
                       ms=round(call_ms, 3))
        if self.tracer is not None:
            self.tracer.event("serving.prefill_chunk", trace_id=req.trace_id, slot=slot, chunk=i,
                              offset=off, final=final, ms=round(call_ms, 3))
        if not final:
            return
        self._admitting = None
        self._finish_admit(req, slot, admit.bucket_len, admit.m0, admit.prefill_ms,
                           hit=admit.plan is not None, chunks=len(admit.offsets))

    def _retire(self, entry: _Slot, status: str, *, error: Optional[str] = None,
                kv_cause: Optional[str] = None) -> None:
        if status == "ok":
            out = np.full((entry.max_new,), entry.req.config.pad_token_id, np.int32)
            out[:len(entry.emitted)] = entry.emitted
            entry.req.result = out
        self._finish(entry.req, status, error=error)
        self._slots[entry.slot] = None
        # the pool's free causes: ``kv_cause`` (an evacuation) overrides
        cause = kv_cause or {"cancelled": "cancelled", "failed": "failover"}.get(status, "retire")
        self._kv_release(entry.slot, cause=cause)
        if self.tracer is not None:
            self.tracer.event("serving.slot_retired", trace_id=entry.req.trace_id,
                              slot=entry.slot, status=status, decode_steps=len(entry.emitted))

    def _fail_admitting(self, error: str) -> None:
        """The in-flight admission fails: its slot's pages return."""
        admit, self._admitting = self._admitting, None
        self._kv_release(admit.slot)
        self._finish(admit.req, "failed", error=error)

    def _fail_resident(self, error: str) -> int:
        """A step failed: every resident request (and an admission in flight)
        fails, the queue survives, the prefix index is flushed and the
        device state is rebuilt blank."""
        failed = 0
        if self._admitting is not None:
            self._fail_admitting(error)
            failed += 1
        for entry in self._active():
            self._retire(entry, "failed", error=error)
            failed += 1
        if self._pool is not None:
            # parked bundles' shared blocks are about to be blanked: their
            # queued requests replay from their prompts instead
            for rid in list(self._swap_bundles):
                self._drop_bundle(rid, cause="failover")
            self._pool.release_all()
            if self._prefix_index is not None:
                # the pool is about to be blanked: cached blocks would
                # describe zeroed pages
                self._prefix_index.flush(self._pool)
            self._push_table()
            self._update_kv_gauges()
        self._op("reset")
        self._update_slot_gauges()
        return failed

    def cancel(self, request_id: int) -> bool:
        """Withdraw a request: a resident one retires ``cancelled`` at once
        and an admission in flight is dropped before its row enters the
        state (its slot and pool pages are free before the next ``step()``;
        shared pages keep their other references), a queued one leaves the
        queue. Returns True when found."""
        admit = self._admitting
        if admit is not None and admit.req.request_id == request_id:
            self._admitting = None
            self._kv_release(admit.slot, cause="cancelled")
            if self.tracer is not None:
                self.tracer.event("serving.cancelled", trace_id=admit.req.trace_id,
                                  stage="admitting", slot=admit.slot, tokens_emitted=0)
            self._finish(admit.req, "cancelled")
            return True
        for entry in self._active():
            if entry.req.request_id == request_id:
                if self.tracer is not None:
                    self.tracer.event("serving.cancelled", trace_id=entry.req.trace_id,
                                      stage="resident", slot=entry.slot,
                                      tokens_emitted=len(entry.emitted))
                self._retire(entry, "cancelled")
                self._update_slot_gauges()
                return True
        if super().cancel(request_id):
            self._drop_bundle(request_id, cause="cancelled")  # a queued swapped victim
            return True
        return False

    def evacuate(self, cause: str = "scale_down") -> int:
        """Withdraw every live request at once, the fleet's scale-down path:
        the admission in flight drops, every resident retires ``cancelled``
        with its pages (mapped and reserved) returned tagged ``cause`` in the
        pool's ``frees_by_cause``, parked swap bundles drop their retains
        under the same cause, and queued requests leave through the base
        path. Each gets a ``serving.cancelled`` event carrying ``cause``.
        Returns the number evacuated."""
        evacuated = 0
        admit = self._admitting
        if admit is not None:
            self._admitting = None
            self._kv_release(admit.slot, cause=cause)
            if self.tracer is not None:
                self.tracer.event("serving.cancelled", trace_id=admit.req.trace_id,
                                  stage="admitting", slot=admit.slot, tokens_emitted=0,
                                  cause=cause)
            self._finish(admit.req, "cancelled", error=f"evacuated ({cause})")
            evacuated += 1
        for entry in self._active():
            if self.tracer is not None:
                self.tracer.event("serving.cancelled", trace_id=entry.req.trace_id,
                                  stage="resident", slot=entry.slot,
                                  tokens_emitted=len(entry.emitted), cause=cause)
            self._retire(entry, "cancelled", error=f"evacuated ({cause})", kv_cause=cause)
            evacuated += 1
        for rid in list(self._swap_bundles):
            self._drop_bundle(rid, cause=cause)
        self._update_slot_gauges()
        return evacuated + super().evacuate(cause)

    def resize_slots(self, new_slots: int) -> int:
        """Rebuild the idle engine's decode state at ``new_slots`` slots (the
        autoscaler's ``scale_up_slots``), through the same ``_init_kv_state``
        rebuild a warmup layout switch uses: the old state and pool are
        dropped before the new ones are allocated. A pool the operator did
        not size scales with the slot count; a sized one keeps its blocks.
        Refused while a request is resident or an admission is in flight
        (drain or evacuate first); queued requests survive. Returns the
        previous slot count."""
        if new_slots < 1:
            raise ValueError(f"slots must be >= 1, got {new_slots}")
        if self.sharding is not None and new_slots % self.sharding.data_size:
            raise ValueError(
                f"slots ({new_slots}) must divide evenly over the mesh data axis "
                f"({self.sharding.data_size})")
        if any(s is not None for s in self._slots) or self._admitting is not None:
            raise RuntimeError(
                "resize_slots() with requests resident in slots would corrupt their decode "
                "state; drain() or evacuate() first")
        old = self.slots
        if new_slots == old:
            return old
        self.slots = int(new_slots)
        self._slots = [None] * self.slots
        if not self._kv_sized:
            self.kv_blocks = self.slots * -(-self.model.max_seq_len // self.kv_block_size)
        self._init_kv_state(self.kv_layout)
        self._update_slot_gauges()
        return old

    # -- the token-level scheduler ------------------------------------------
    def _decode(self, boundary: bool) -> torch.Tensor:
        """One fixed-shape token step over all slots: choose each row's token
        from the resident logits (sampled: one ``(S, V)`` draw over all
        slots), append it, advance every cache by one token. ``boundary``
        adds the prefix-growth step for rows with ``m == max_latents``
        (:meth:`_SlotDevice.decode`).
        :return: ``(S,)`` chosen tokens."""
        admitting = None if self._admitting is None else self._admitting.slot
        sampled = self.config.sampling.do_sample and self.sharding is not None
        token, post = self._op("decode", local={"generator": self.generator}, boundary=boundary,
                               cached=self.boundary_mode == "cached", admitting=admitting,
                               gen_state=self.generator.get_state() if sampled else None)
        if post is not None and self._dev is None:
            self.generator.set_state(post)  # the draws ran on the followers
        return torch.as_tensor(token)

    def _lane_blocked(self, head: ServeRequest, plan: Optional[_PrefixPlan],
                      ran_chunk_call: bool) -> tuple:
        """``(blocked, chunked)`` for the queue head: chunked and shared
        admissions share one lane that runs at most one call per step, so
        no step stalls the residents past max(one chunk, one finalize)."""
        try:
            chunked = self._chunk_eligible(head, plan)
        except ValueError:
            chunked = False
        lane = chunked or plan is not None
        return lane and (self._admitting is not None or ran_chunk_call), chunked

    def _admit_from_queue(self, ran_chunk_call: bool) -> int:
        """Refill free slots from the queue head: FIFO, sorted by tier first
        when preemption is on or a request has a priority. Under the paged
        layouts the head waits at the pool gate until its need
        (:meth:`_admit_need`) is reservable, after unreferenced cached
        prefixes have dropped LRU-first (each eviction can shrink the match,
        so the plan is derived again) and, under preemption, a head of a
        higher tier has preempted lower tiers. A swapped victim at the head
        is restored. Returns the requests disposed of; a prefill or restore
        fault fails the residents too."""
        disposed = 0
        self._preempts_this_step = 0
        if self._queue and (self.preemption != "off" or any(r.priority for r in self._queue)):
            # stable: FIFO within a tier, and a replay returns to its place
            self._queue.sort(key=lambda r: (-r.priority, r.request_id))
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                break
            head = self._queue[0]
            # a swapped victim restores from its bundle: no prefix plan (its
            # pages hold its prefix) and no chunk lane (one scatter)
            bundle = self._swap_bundles.get(head.request_id)
            plan = None
            if bundle is None:
                try:
                    plan = self._prefix_plan(head)
                except ValueError:
                    plan = None  # an infeasible head fails in _admit
            # the lane check comes before the gate: a head that cannot admit
            # this step must not evict cached prefixes for room it cannot use
            blocked, chunked = (False, False) if bundle is not None else \
                self._lane_blocked(head, plan, ran_chunk_call)
            if blocked:
                break
            if self._pool is not None:
                while True:
                    need = self._admit_need(head, plan, bundle)
                    if self._pool.can_reserve(need):
                        break
                    if not self._evict_for(need) and not (
                            self.preemption != "off" and self._preempt_lower_tier(head)):
                        break
                    if bundle is not None:
                        continue
                    try:
                        plan = self._prefix_plan(head)
                    except ValueError:
                        plan = None
                if not self._pool.can_reserve(need):
                    # one wait counted per waiting request, not per poll
                    if self._kv_waiting_id != head.request_id:
                        self._kv_waiting_id = head.request_id
                        self._inc("kv_pool_admit_waits_total")
                        if self.flight_recorder is not None:
                            # incident-worthy once per waiting request
                            pool = self._pool.stats()
                            self.flight_recorder.trigger(
                                "pool_exhausted",
                                f"admission stalled: request {head.request_id} needs "
                                f"{int(need)} pool blocks, {pool['blocks'] - pool['reserved']} "
                                f"of {pool['blocks']} unreserved",
                                trace_ids=[head.trace_id] if head.trace_id else [],
                                request_id=head.request_id, blocks_needed=int(need),
                                blocks=pool["blocks"], blocks_reserved=pool["reserved"],
                            )
                    break
                blocked, chunked = (False, False) if bundle is not None else \
                    self._lane_blocked(head, plan, ran_chunk_call)
                if blocked:
                    break
            req = self._queue.pop(0)
            if self._apply_request_chaos(req):
                self._drop_bundle(req.request_id, cause="failover")
                disposed += 1
                continue
            if bundle is not None:
                del self._swap_bundles[req.request_id]
                try:
                    self._restore_admit(req, slot, bundle)
                except Exception as e:  # the scatter may have half-written the state
                    error = f"{type(e).__name__}: {e}"
                    self._finish(req, "failed", error=error)
                    return disposed + 1 + self._fail_resident(
                        f"swap-restore fault poisoned the slot state: {error}")
                continue
            try:
                if chunked:
                    self._start_chunked_admit(req, slot, plan)
                else:
                    self._admit(req, slot, plan)
            except Exception as e:  # a prefill fault fails this request ...
                error = f"{type(e).__name__}: {e}"
                self._admitting = None
                self._finish(req, "failed", error=error)
                if chunked:
                    self._kv_release(slot)
                if chunked and plan is None:
                    disposed += 1  # ... an unshared first chunk wrote only its staging caches
                    continue
                return disposed + 1 + self._fail_resident(  # ... and the residents
                    f"prefill fault poisoned the slot state: {error}")
        return disposed

    def _map_decode_pages(self, active: List[_Slot], forced=None) -> bool:
        """Map the page each resident's next write lands on, and copy on
        write any still-shared page it would write through. A speculative
        round maps its worst-case burst, ``min(k+1, max_new - emitted)``
        tokens, at once (``ensure_many``: all of it or, on exhaustion,
        nothing), as that many plain steps would. With preemption off
        admission reserved the worst case, so this cannot run dry; under
        lazy admission a dry pool raises :class:`PoolExhausted`, and the
        resident reclaims a page (:meth:`_reclaim_decode_page`), preempting a
        victim or yielding. ``forced``, a ``kv.exhaust`` chaos fault, makes
        the step's first mapping raise :class:`PoolExhausted`. Returns True
        when the table changed."""
        changed = False
        for entry in active:
            if self._slots[entry.slot] is not entry:
                continue  # preempted as an earlier row's victim
            burst = 1 if self._spec is None else max(
                1, min(self._spec.k + 1, entry.max_new - len(entry.emitted)))
            next_len = int(entry.req.prompt.size) + len(entry.emitted) + burst
            while True:
                try:
                    if forced is not None and forced.kind == "error":
                        forced = None
                        raise PoolExhausted("chaos: kv.exhaust scripted pool pressure")
                    if burst > 1:
                        changed |= self._pool.ensure_many(entry.slot, next_len)
                    else:
                        changed |= self._pool.ensure(entry.slot, next_len)
                    changed |= self._cow_guard(entry, next_len)
                    break
                except PoolExhausted as e:
                    if self.preemption == "off":
                        raise
                    outcome = self._reclaim_decode_page(entry)
                    if outcome == "yielded":
                        break
                    if outcome == "stuck":
                        raise RuntimeError(
                            "preemption found no victim and no evictable prefix for the sole "
                            f"resident — single-request feasibility was checked at submit: {e}"
                        ) from e
        return changed

    def step(self) -> int:
        """Advance serving by ONE TOKEN: expire deadlines (queued, resident
        and mid-admission), advance an in-flight chunked admission by one
        call, refill free slots from the queue, run one decode step over all
        slots, retire rows that finished (EOS / ``max_new_tokens``). Returns
        the number of requests disposed of; ``pending()`` says whether work
        remains (a mid-generation step disposes of 0)."""
        return self._run_pass(self._step_pass)

    def _tl_record(self, t0: float, t1: float) -> None:
        """The slot engine's per-pass record: the bucket engine's, plus the
        slot occupancy, real and padded decode rows, the pool's occupancy
        and the pages each tenant holds."""
        draft, self._tl_draft = self._tl_draft, None
        marks, self._tl_marks = self._tl_marks or {}, None
        phases = {"total": round((t1 - t0) * 1e3, 3)}
        if "admit_done_s" in marks:
            phases["admit"] = round((marks["admit_done_s"] - t0) * 1e3, 3)
        if "decode_ms" in marks:
            phases["decode"] = round(marks["decode_ms"], 3)
        if "token_at_s" in marks:
            phases["account"] = round((t1 - marks["token_at_s"]) * 1e3, 3)
        rec = {
            "engine": "slots",
            "t_start_s": round(t0, 6),
            "t_end_s": round(t1, 6),
            "queue_depth": len(self._queue),
            "slots": [None if s is None else s.req.request_id for s in self._slots],
            "phases_ms": phases,
        }
        if "rows_active" in marks:
            active = int(marks["rows_active"])
            rec["rows"] = {"total": self.slots, "real": active, "padded": self.slots - active}
        if self._pool is not None:
            rec["pool"] = {"in_use": self._pool.in_use, "reserved": self._pool.reserved,
                           "headroom": self._pool.headroom_blocks}
            tenants: Dict[str, int] = {}
            for tenant, held in self._tenant_pages().items():
                key = tenant_label(tenant)
                tenants[key] = tenants.get(key, 0) + held
            if tenants:
                rec["tenants"] = dict(sorted(tenants.items()))
        rec.update(draft or {})
        self.timeline.append(rec)

    def _step_pass(self) -> int:
        disposed = self._step_body()
        self._update_kv_gauges()
        return disposed

    def _step_body(self) -> int:
        disposed = self._expire_overdue()
        # a swapped victim whose request left the queue by its deadline
        for rid in [r for r in self._swap_bundles if r not in {q.request_id for q in self._queue}]:
            self._drop_bundle(rid, cause="retire")
        now = self._clock()
        for entry in self._active():
            req = entry.req
            if req.deadline_at is not None and now >= req.deadline_at:
                self._retire(entry, "timed_out", error=(
                    f"deadline exceeded after {len(entry.emitted)} of {entry.max_new} tokens"))
                disposed += 1
        ran_chunk_call = False
        admit = self._admitting
        if admit is not None:
            if admit.req.deadline_at is not None and now >= admit.req.deadline_at:
                self._admitting = None
                self._kv_release(admit.slot)
                self._finish(admit.req, "timed_out", error=(
                    f"deadline exceeded after {admit.next_chunk} of {len(admit.offsets)} "
                    "prefill chunks"))
                disposed += 1
            else:
                final = admit.next_chunk == len(admit.offsets)
                ran_chunk_call = True
                try:
                    self._advance_chunked_admit()
                except Exception as e:
                    # an unshared chunk wrote only its staging caches; a
                    # shared chunk writes pool pages and a finalize the
                    # state, so those fail the residents too
                    error = f"{type(e).__name__}: {e}"
                    self._fail_admitting(error)
                    disposed += 1
                    if final or admit.plan is not None:
                        return disposed + self._fail_resident(
                            f"chunked-prefill fault poisoned the slot state: {error}")
        disposed += self._admit_from_queue(ran_chunk_call)
        self._update_slot_gauges()
        self._tl_mark_clock("admit_done_s")
        active = self._active()
        if not active:
            return disposed

        num_latents = self.model.max_latents
        t0 = self._clock()
        try:
            fault = self._chaos.hit("serving.batch") if self._chaos else None
            if fault is not None and fault.kind == "error":
                raise fault.make_error()
            if self._pool is not None:
                # kv.exhaust: scripted pool pressure, once per decode step
                forced = (self._chaos.hit("kv.exhaust")
                          if self._chaos is not None and self.preemption != "off" else None)
                if self._map_decode_pages(active, forced):
                    self._push_table()
                active = self._active()
                if not active:
                    return disposed  # every resident yielded: the replays admit next step
            # a speculative round's lanes cover latent growth and the boundary
            # per row, so it has no boundary variant
            boundary = self._spec is None and any(s.m >= num_latents for s in active)
            with torch.no_grad(), self._device_capture(
                    step=lambda: int(self.registry.counter("serving_decode_steps_total"))):
                if self._spec is None:
                    tokens = self._decode(boundary).cpu().numpy()  # host sync: the scheduling point
                    bursts = {e.slot: [int(tokens[e.slot])] for e in active}
                else:
                    cand, n_e = self._spec_round()
                    bursts = {e.slot: [int(t) for t in cand[e.slot, :int(n_e[e.slot])]]
                              for e in active}
        except Exception as e:
            return disposed + self._fail_resident(f"{type(e).__name__}: {e}")
        token_at = self._clock()
        decode_ms = (token_at - t0) * 1e3
        self._sample("decode_step_ms", decode_ms)
        self._tl_mark("decode_ms", decode_ms)
        self._tl_mark("rows_active", len(active))
        if self.profiler_trigger is not None:
            self.profiler_trigger.observe(decode_ms)
        self._inc("serving_decode_steps_total")
        self._inc("serving_decode_boundary_steps_total", int(boundary))
        # a plain paged step on the card attends through K4 (on the CPU
        # through the gather); a speculative round reads no cache
        self._inc("kv_ragged_kernel_steps_total", int(
            self._pool is not None and self.device.type == "cuda" and self._spec is None))
        self._inc("serving_decode_rows_total", self.slots)
        self._inc("serving_decode_rows_padded_total", self.slots - len(active))
        self._tl_mark("token_at_s", token_at)
        eos = self.config.eos_token_id
        emitted = 0
        tier_tokens: Dict[str, int] = {}
        for entry in active:
            # a burst is truncated here at EOS and max_new_tokens, where
            # that many plain steps would have stopped; its first token
            # carries the round's latency, the rest 0 ms of ITL
            for token in bursts[entry.slot]:
                first = not entry.emitted
                entry.emitted.append(token)
                emitted += 1
                if entry.req.on_token is not None:
                    self._emit_token(entry.req, len(entry.emitted) - 1, token)
                entry.m = min(entry.m + 1, num_latents)
                if first:
                    ttft_ms = (token_at - entry.req.ttft_from_s) * 1e3
                    self._observe_token_latency("ttft_ms", ttft_ms)
                    if self.timeline is not None:
                        self._tl_event("tokens", request_id=entry.req.request_id, slot=entry.slot,
                                       first=True, ttft_ms=round(ttft_ms, 3))
                    if self.tracer is not None:
                        self.tracer.event("serving.first_token", trace_id=entry.req.trace_id,
                                          slot=entry.slot, ttft_ms=round(ttft_ms, 3))
                else:
                    itl_ms = (token_at - entry.last_token_at) * 1e3
                    self._observe_token_latency("inter_token_ms", itl_ms)
                    if self.timeline is not None:
                        self._tl_event("tokens", request_id=entry.req.request_id, slot=entry.slot,
                                       first=False, itl_ms=round(itl_ms, 3))
                entry.last_token_at = token_at
                tkey = tier_label(entry.req.priority)
                tier_tokens[tkey] = tier_tokens.get(tkey, 0) + 1
                nkey = tenant_label(entry.req.tenant)
                self._tokens_by_tenant[nkey] = self._tokens_by_tenant.get(nkey, 0) + 1
                if (eos is not None and token == eos) or len(entry.emitted) >= entry.max_new:
                    self._retire(entry, "ok")
                    disposed += 1
                    break
        self._inc("serving_tokens_generated_total", emitted)
        if self._spec is not None:
            accepted = int(sum(int(n_e[e.slot]) - 1 for e in active))
            self._inc("spec_rounds_total")
            self._inc("spec_tokens_proposed_total", self._spec.k * len(active))
            self._inc("spec_tokens_accepted_total", accepted)
            self._inc("spec_tokens_emitted_total", emitted)
            if self.timeline is not None:
                self._tl_event("spec_round", rows=len(active), proposed=self._spec.k * len(active),
                               accepted=accepted, emitted=emitted)
        for tkey, n in tier_tokens.items():
            self._inc(f"serving_tokens_tier_{tkey}_total", n)
        self._update_slot_gauges()
        return disposed

    def _spec_round(self) -> tuple:
        """One speculative round over all slots, in place of :meth:`_decode`:
        the draft proposes ``(S, k+1)`` candidates, ONE lane-batched verify
        forward scores them, and the row state advances past each row's
        ``n_e`` accepted tokens. The KV caches (dense cross or pool, and the
        latent stack) are left as they are: the lanes recompute the window,
        so what the caches hold past the prefill is never read again (the
        recompute boundary step's contract). So an idle or admitting slot's
        round writes only row state, which the admission's insert
        overwrites. :return: ``(cand (S, k+1), n_e (S,))`` on the host."""
        return self._op("spec_round", k=self._spec.k, draft_layers=self._spec.draft_layers)

    def run_until_idle(self) -> int:
        """Step until no request is queued, admitting or resident; returns
        the number of requests disposed of."""
        served = 0
        while self.pending():
            served += self.step()
        return served

    # -- warmup -------------------------------------------------------------
    def warmup(self, config: Optional[GenerationConfig] = None) -> int:
        """Before traffic: run the autotuners of the axes asked for as
        ``"auto"``, rebuild onto the KV-layout verdict, drive every step the
        engine can take once, then blank the slot state. Returns the number
        of steps driven (in PyTorch nothing compiles per shape: this builds
        the kernels and warms the allocator and the matmul libraries).

        - ``decode_strategy="auto"``: :func:`~..inference.decode_strategy.autotune_boundary`;
        - ``kv_layout="auto"`` (unless the pool was sized): ``autotune_kv_layout``,
          then a rebuild onto its verdict (the old pool freed first);
          ``kv_quant_fallback_total`` counts a quality gate that vetoed
          int8, and ``prefix_cache="on"`` over a dense verdict raises;
        - ``speculation="auto"``: ``autotune_speculation``, then the verdict
          is taken (JAX's serve CLI runs this probe; the port has no CLI).

        The steps driven: each feasible prompt bucket's prefill, the decode
        step and its boundary variant, the chunked prefill's chunk and
        finalize when ``prefill_chunk`` is set, the shared finalize and page
        copy with prefix sharing on, the draft/verify round with speculation
        on, and a swap round trip under ``swap``/``auto`` preemption.

        :raises RuntimeError: with residents or an admission in flight (the
            blank at the end would decode them from zeroed caches).
        :raises ValueError: for a config that differs from the engine's in
            more than ``max_new_tokens``.
        """
        if config is not None and dataclasses.replace(
                config, max_new_tokens=self.config.max_new_tokens) != self.config:
            raise ValueError(
                "slot engine warmup config must match the engine config (only max_new_tokens "
                "may differ)")
        if any(s is not None for s in self._slots) or self._admitting is not None:
            raise RuntimeError(
                "warmup() with requests resident in slots would corrupt their decode state; "
                "warm up before traffic or after drain()")
        model = self.model
        if self.decode_strategy == "auto":
            decode_strategy_mod.autotune_boundary(model)
        if self.kv_layout_requested == "auto" and not self._kv_sized:
            verdict = decode_strategy_mod.autotune_kv_layout(model, block_size=self.kv_block_size)
            if verdict != self.kv_layout:
                self._init_kv_state(verdict)
            gate = (decode_strategy_mod.kv_entry(model) or {}).get("quant_gate")
            if gate is not None and not gate.get("passed", False):
                self._inc("kv_quant_fallback_total")
            if self.prefix_cache_requested == "on" and self.kv_layout not in PAGED_KV_LAYOUTS:
                raise ValueError(
                    "prefix_cache='on' requires a paged kv_layout but the kv-layout autotuner "
                    "resolved dense at this shape — pass kv_layout='paged' explicitly to share "
                    "prefixes")
        if self.speculation_requested == "auto":
            self.speculation = decode_strategy_mod.autotune_speculation(model)
            self._spec = spec_mod.parse_speculation(self.speculation)
            if self._spec is not None:
                spec_mod.validate_spec(self._spec, model, self.config)
        self._pinned_boundary_mode = None  # no residents: take the freshest verdict
        steps = self._drive_warmup_steps()
        if self._prefix_index is not None:
            self._prefix_index.flush(self._pool)  # the blank below zeroes its pages
        for rid in list(self._swap_bundles):  # parked bundles describe pages about to be zeroed
            self._drop_bundle(rid, cause="retire")
        self._op("reset")
        return steps

    def _drive_warmup_steps(self) -> int:
        """Each step :meth:`warmup` drives, once, over the live state with an
        all-zero block table (every pool write lands in the null block);
        returns the count (:meth:`_SlotDevice.warmup_steps`)."""
        sampled = self.config.sampling.do_sample and self.sharding is not None
        spec = None if self._spec is None else (self._spec.k, self._spec.draft_layers)
        steps, post = self._op(
            "warmup_steps", local={"generator": self.generator}, prompt_lens=tuple(self.table.prompt_lens),
            prefill_chunk=self.prefill_chunk, shared=self._prefix_index is not None, spec=spec,
            swap=self._pool is not None and self.preemption in ("swap", "auto"),
            cached=self.boundary_mode == "cached",
            gen_state=self.generator.get_state() if sampled else None)
        if post is not None and self._dev is None:
            self.generator.set_state(post)
        return steps

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        self._update_kv_gauges()
        c = self.counters
        out = super().stats()
        reg = self.registry

        def pct(name: str) -> dict:
            return {"p50": _round_ms(reg.percentile(name, 50.0)),
                    "p95": _round_ms(reg.percentile(name, 95.0))}

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
            "decode_step_ms": pct("serving_decode_step_ms"),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": c["serving_prefill_chunks_total"],
            "prefill_chunk_ms": pct("serving_prefill_chunk_ms"),
            "decode_strategy_boundary": self.boundary_mode,
            "kv_layout": self.kv_layout,
            "speculation": {"mode": self.speculation},
        })
        if self._spec is not None:
            rounds, proposed = c["spec_rounds_total"], c["spec_tokens_proposed_total"]
            accepted, emitted = c["spec_tokens_accepted_total"], c["spec_tokens_emitted_total"]
            out["speculation"].update({
                "k": self._spec.k, "draft_layers": self._spec.draft_layers, "rounds": rounds,
                "proposed": proposed, "accepted": accepted, "emitted": emitted,
                # drafted tokens the verify kept, over drafted tokens proposed
                "acceptance_rate": round(accepted / max(1, proposed), 4),
                "tokens_per_round": round(emitted / max(1, rounds), 4),
            })
        if self._pool is not None:
            out["kv_pool"] = {
                **self._pool.stats(),
                "layout": self.kv_layout,
                "dtype": str(self._pool_dtype).split(".")[-1],
                "admit_waits": c["kv_pool_admit_waits_total"],
                "ragged_kernel_steps": c["kv_ragged_kernel_steps_total"],
                "resident_bytes": int(reg.gauge("kv_cache_resident_bytes") or 0),
                "capacity_bytes": self._kv_capacity_bytes,
                "block_bytes": self.kv_block_size * self._kv_token_bytes,
                "block_scale_bytes": self.kv_block_size * self._kv_scale_token_bytes,
                "quant_fallbacks": c["kv_quant_fallback_total"],
            }
            out["prefix_cache"] = {"enabled": self._prefix_index is not None}
            if self._prefix_index is not None:
                hits, misses = c["kv_prefix_hits_total"], c["kv_prefix_misses_total"]
                out["prefix_cache"].update({
                    "hits": hits,
                    "misses": misses,
                    "hit_ratio": round(hits / max(1, hits + misses), 4),
                    "shared_blocks": c["kv_prefix_shared_blocks_total"],
                    "shared_tokens": c["kv_prefix_shared_tokens_total"],
                    "cow_copies": c["kv_prefix_cow_copies_total"],
                    "evicted": c["kv_prefix_evicted_blocks_total"],
                    "published": c["kv_prefix_published_blocks_total"],
                    **self._prefix_index.stats(),
                })
            out["preemption"] = {
                "mode": self.preemption,
                "admit_headroom_blocks": self.admit_headroom_blocks,
                "preemptions": c["kv_preemptions_total"],
                "readmissions": c["kv_readmissions_total"],
                "swaps": c["kv_swaps_total"],
                "swap_restores": c["kv_swap_restores_total"],
                "swap_bytes": c["kv_swap_bytes_total"],
                "swapped_waiting": len(self._swap_bundles),
                "swap_link_gbps": self.swap_link_gbps,
                "by_tier": dict(sorted(self._preempted_by_tier.items())),
                "by_tenant": dict(sorted(self._preempted_by_tenant.items())),
                "headroom_blocks": self._pool.headroom_blocks,
                "postmortems": self.postmortems(),
            }
        # per-tenant rollup: resident pool pages, generated tokens, victims
        pages_by_tenant: Dict[str, int] = {}
        if self._pool is not None:
            for tenant, held in self._tenant_pages().items():
                key = tenant_label(tenant)
                pages_by_tenant[key] = pages_by_tenant.get(key, 0) + held
        keys = set(pages_by_tenant) | set(self._tokens_by_tenant) | set(self._preempted_by_tenant)
        if keys:
            out["tenants"] = {key: {"blocks_in_use": pages_by_tenant.get(key, 0),
                                    "tokens": self._tokens_by_tenant.get(key, 0),
                                    "preemptions": self._preempted_by_tenant.get(key, 0)}
                              for key in sorted(keys)}
        if self.sharding is not None:
            out["mesh"] = {
                "data": self.sharding.data_size,
                "model": self.sharding.model_size,
                "devices": self.sharding.num_devices,
                "spec": self.sharding.describe(),
            }
        return out

    def health(self) -> dict:
        out = super().health()
        out["slots"] = self.slots
        out["slots_active"] = len(self._active())
        out["admitting"] = self._admitting is not None
        out["kv_layout"] = self.kv_layout
        out["prefix_cache"] = self.prefix_cache
        out["preemption"] = self.preemption
        out["speculation"] = self.speculation
        if self._pool is not None:
            out["kv_pool_in_use"] = self._pool.in_use
            out["kv_pool_leaked"] = self._pool.leaked()
        out["mesh"] = None if self.sharding is None else self.sharding.describe()
        return out
