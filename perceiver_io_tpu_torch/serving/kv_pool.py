"""Block-paged KV pool: the host-side allocator behind the slot engine's
paged KV layouts (``kv_layout="paged"`` and ``"paged_int8"``).

A copy of ``perceiver_io_tpu/serving/kv_pool.py`` (``SwapBundle``,
``PoolExhausted``, ``KVPagePool``, ``PrefixBlockIndex``), which is pure host
code; the port keeps its own copy so that it imports nothing of the JAX
package. Its ``SwapBundle`` holds no payload: the slot engine keeps that
with its device state.

ONE fixed device pool of KV blocks (``block_size`` token positions each) is
shared by every slot, with a per-slot **block table** mapping token-index
pages to pool blocks. A request only ever consumes
``ceil((prompt + max_new) / block_size)`` blocks, its own worst case, not
the context's.

- **Block 0 is the null block.** It is never allocated; every unmapped
  table entry points at it, so device writes routed through the table for
  idle or retired rows land in trash that no masked read uses. The device
  pool has ``num_blocks + 1`` blocks for a pool of capacity ``num_blocks``.
- **Reserve at admit, map lazily.** Admission reserves the request's whole
  worst-case block count (``reserve``), so a resident never hits pool
  exhaustion mid-decode; blocks are mapped page by page as positions fill
  (``ensure``). Under the slot engine's preemption a request reserves only
  its prompt pages (``reserve_lazy``) and a decode page past them may find
  the pool dry (:class:`PoolExhausted`, the engine's cue to preempt).
- **Deterministic allocation order.** The free list is a min-heap: the
  lowest free block id goes first, so identical schedules produce identical
  block tables.
- **Zero-leak accounting.** ``release`` frees the mapped blocks and the
  unconsumed reservation; at idle ``in_use`` is 0 and :meth:`leaked` is 0.
- **Refcounts and copy-on-write** (``retain``/``deref``,
  ``map_shared``/``page_shared``/``cow``) back prefix sharing: the slot
  engine maps published prefix blocks by reference and copies a shared
  page before any write could land on it. **Host swap**
  (``extract``/``restore``): a swapped victim's private blocks free
  (``frees_by_cause["swapped"]``) and its leading shared blocks keep one
  bundle reference each, until its restore maps fresh blocks.
- **The prefix index** (:class:`PrefixBlockIndex`) is a radix trie over
  published full prompt-prefix blocks, holding one pool reference per
  block, LRU-evicted leaf first.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class SwapBundle:
    """Self-contained host-side image of one swapped-out victim
    (docs/serving.md "Host-swap preemption").

    The payload (host copies of the victim's pool pages, ``pool_k`` /
    ``pool_v`` gathered through its padded block-table row, plus int8
    per-block scales under ``kv_layout="paged_int8"``, and a ``row`` dict
    of its per-slot state leaves) is not in the bundle: it stays with the
    device state (``serving/slots.py`` ``_SlotDevice.payloads``, under the
    request id), each rank of a serving mesh keeping its shard's.
    ``shared`` lists the leading prefix-shared block ids that were deref'd
    rather than copied — the bundle holds ONE retain on each
    (:meth:`KVPagePool.extract`), so their device content survives until
    restore re-references them or the bundle is dropped. Restore re-maps
    into whatever free blocks exist at readmission; nothing in the bundle
    names the original private ids.
    """

    request_id: int
    shared: List[int]
    n_private: int
    #: resident token positions (prompt + generated) restore must re-map
    tokens: int
    emitted: List[int]
    m: int
    last_token_at: float
    bytes_moved: int


class PoolExhausted(RuntimeError):
    """Raised by :meth:`KVPagePool.reserve` when the request's worst-case
    block count exceeds the currently unreserved pool — the engine's
    admission gate catches it and leaves the request queued."""


class KVPagePool:
    """Host-side block allocator + per-slot block tables for one engine.

    :param num_blocks: usable pool capacity in blocks (the null block is
        extra; the device pool holds ``num_blocks + 1`` blocks).
    :param block_size: token positions per block.
    :param slots: number of persistent decode slots (block-table rows).
    :param max_len: max token positions one slot can hold (the model
        context length) — fixes the block-table width.
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int, max_len: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        import numpy as np

        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.slots = int(slots)
        self.pages_per_slot = -(-int(max_len) // self.block_size)
        # ids 1..num_blocks; 0 is the null block (see module docstring)
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        heapq.heapify(self._free)
        self._table = np.zeros((self.slots, self.pages_per_slot), np.int32)
        self._mapped: Dict[int, List[int]] = {s: [] for s in range(self.slots)}
        self._reserved: Dict[int, int] = {s: 0 for s in range(self.slots)}
        #: block id -> live reference count (slot mappings + prefix-index
        #: retains). Every allocated block appears here; a block is freed
        #: exactly when its count drains to 0, so
        #: ``num_blocks == len(_free) + len(_refcount)`` is the zero-leak
        #: invariant :meth:`leaked` checks.
        self._refcount: Dict[int, int] = {}
        self.high_water = 0
        self.allocs_total = 0
        self.frees_total = 0
        #: blocks mapped into a slot's table by reference (no allocation)
        self.shared_maps_total = 0
        #: derefs that left the block alive (another slot / the prefix
        #: index still holds it) — the non-free half of refcounted release
        self.shared_derefs_total = 0
        #: copy-on-write replacements performed (a fresh block swapped in
        #: for a shared mapping; the engine pays the device page copy)
        self.cow_swaps_total = 0
        #: blocks freed per retirement route (``retire`` = ordinary EOS /
        #: max_new / deadline, ``cancelled`` = client-driven reclaim through
        #: the gateway's disconnect path, ``failover`` = engine fault) — the
        #: accounting that makes abandoned-resident leaks visible instead
        #: of folded into ordinary churn (docs/serving.md "Streaming")
        self.frees_by_cause: Dict[str, int] = {}
        #: slot -> soft watermark (total pages the slot may EVER map —
        #: ``ceil((prompt + max_new) / block_size)``) for slots admitted
        #: through :meth:`reserve_lazy`. Lazy slots hold a hard reservation
        #: only for their prompt pages (+ headroom); decode pages past it
        #: allocate straight from the free heap, so :meth:`ensure` becomes
        #: FALLIBLE for them (:class:`PoolExhausted` = the engine's
        #: preemption trigger) instead of an accounting-bug ValueError.
        self._soft: Dict[int, int] = {}
        #: slot -> owner label (the engine's sanitized tenant label) for
        #: per-tenant pool attribution; cleared on :meth:`release`. The
        #: pool never interprets the label — it only sums mapped blocks
        #: per owner for :meth:`stats` (``in_use_by_owner``).
        self._owner: Dict[int, str] = {}

    # -- sizing -------------------------------------------------------------
    def blocks_needed(self, tokens: int) -> int:
        """Worst-case block count for a request holding ``tokens`` positions
        (prompt + max_new for the slot engine's scope)."""
        return -(-max(0, int(tokens)) // self.block_size)

    @property
    def in_use(self) -> int:
        """Blocks currently mapped to a slot (physically allocated)."""
        return self.num_blocks - len(self._free)

    @property
    def reserved(self) -> int:
        """Blocks committed to residents: mapped plus not-yet-mapped
        reservation balance. Admission must gate on this, not ``in_use`` —
        lazily-mapped pages are already spoken for."""
        return self.in_use + sum(self._reserved.values())

    @property
    def available(self) -> int:
        return self.num_blocks - self.reserved

    def can_reserve(self, blocks: int) -> bool:
        return blocks <= self.available

    # -- refcounts -----------------------------------------------------------
    def refcount(self, block: int) -> int:
        """Live references on an allocated block (0 for free blocks)."""
        return self._refcount.get(block, 0)

    def retain(self, block: int) -> None:
        """Add one reference to an allocated block (the prefix index's
        publish path); the block now survives its mapping slots' releases
        until the extra reference is dropped with :meth:`deref`."""
        if block not in self._refcount:
            raise ValueError(f"block {block} is not allocated")
        self._refcount[block] += 1

    def deref(self, block: int, cause: str = "retire") -> int:
        """Drop one reference; physically free the block when the count
        drains to zero. Returns 1 when the block was freed, else 0 —
        ``cause`` tags :attr:`frees_by_cause` only for the actual free
        (live derefs count under :attr:`shared_derefs_total`)."""
        count = self._refcount.get(block)
        if count is None:
            raise ValueError(f"block {block} is not allocated")
        if count > 1:
            self._refcount[block] = count - 1
            self.shared_derefs_total += 1
            return 0
        del self._refcount[block]
        heapq.heappush(self._free, block)
        self.frees_total += 1
        self.frees_by_cause[cause] = self.frees_by_cause.get(cause, 0) + 1
        return 1

    def _alloc(self) -> int:
        block = heapq.heappop(self._free)  # lowest id first: deterministic
        self._refcount[block] = 1
        self.allocs_total += 1
        return block

    # -- lifecycle ----------------------------------------------------------
    def reserve(self, slot: int, tokens: int, *, shared_blocks: int = 0) -> int:
        """Commit the worst-case block count for a request of ``tokens``
        total positions to ``slot``; returns the count reserved. Raises
        :class:`PoolExhausted` when the pool cannot ever satisfy it right
        now (the caller keeps the request queued) and ``ValueError`` on a
        slot that already holds a reservation (engine bug, not load).

        ``shared_blocks`` is the number of leading pages the caller will
        map BY REFERENCE to already-resident prefix blocks
        (:meth:`map_shared`): those pages allocate nothing, so they are
        excluded from the reservation — the capacity win prefix sharing
        exists for (docs/serving.md "Prefix sharing")."""
        if self._reserved[slot] or self._mapped[slot]:
            raise ValueError(f"slot {slot} already holds pool pages/reservation")
        total = self.blocks_needed(tokens)
        if total > self.pages_per_slot:
            raise ValueError(
                f"{tokens} tokens need {total} blocks but one slot maps at "
                f"most {self.pages_per_slot}"
            )
        if not 0 <= shared_blocks <= total:
            raise ValueError(
                f"shared_blocks {shared_blocks} out of range for a "
                f"{total}-block request"
            )
        need = total - shared_blocks
        if not self.can_reserve(need):
            raise PoolExhausted(
                f"need {need} blocks, {self.available} of {self.num_blocks} "
                "unreserved"
            )
        self._reserved[slot] = need
        return need

    def reserve_lazy(self, slot: int, prompt_tokens: int, total_tokens: int,
                     *, headroom: int = 0, shared_blocks: int = 0) -> int:
        """Optimistic admission: commit only the blocks the *prompt* needs
        (plus ``headroom`` decode blocks, clamped to the worst case), and
        record ``ceil(total_tokens / block_size)`` as a SOFT watermark —
        the reservation ledger the up-front path hard-commits becomes
        advisory. Returns the hard-committed count.

        Decode pages past the commitment allocate from the free heap when
        the resident actually crosses a block boundary; :meth:`ensure` on a
        lazy slot raises :class:`PoolExhausted` when that heap is dry — the
        signal the slot engine turns into a preemption instead of an
        admission-time head-of-line block (docs/serving.md "Preemption &
        priorities"). Raise semantics at admit mirror :meth:`reserve`:
        ``ValueError`` for structurally-infeasible or double bookings,
        :class:`PoolExhausted` when the committed need doesn't fit now.
        """
        if self._reserved[slot] or self._mapped[slot]:
            raise ValueError(f"slot {slot} already holds pool pages/reservation")
        total = self.blocks_needed(total_tokens)
        prompt = self.blocks_needed(prompt_tokens)
        if not 0 <= prompt <= total:
            raise ValueError(
                f"prompt_tokens {prompt_tokens} out of range for "
                f"{total_tokens} total tokens"
            )
        if total > self.pages_per_slot:
            raise ValueError(
                f"{total_tokens} tokens need {total} blocks but one slot "
                f"maps at most {self.pages_per_slot}"
            )
        if not 0 <= shared_blocks <= prompt:
            raise ValueError(
                f"shared_blocks {shared_blocks} out of range for a "
                f"{prompt}-prompt-block request"
            )
        if headroom < 0:
            raise ValueError(f"headroom must be >= 0, got {headroom}")
        # hard commitment: private prompt pages + headroom, never more than
        # the worst case would have taken (headroom can't over-reserve)
        need = min(prompt - shared_blocks + headroom, total - shared_blocks)
        if not self.can_reserve(need):
            raise PoolExhausted(
                f"need {need} blocks, {self.available} of {self.num_blocks} "
                "unreserved"
            )
        self._reserved[slot] = need
        self._soft[slot] = total
        return need

    def is_lazy(self, slot: int) -> bool:
        """True when ``slot`` was admitted through :meth:`reserve_lazy` —
        its :meth:`ensure` may raise :class:`PoolExhausted`."""
        return slot in self._soft

    @property
    def headroom_blocks(self) -> int:
        """Free blocks not spoken for by any hard reservation — the real
        distance to the next :class:`PoolExhausted` on a lazy slot's
        boundary crossing (the ``kv_pool_headroom_blocks`` gauge)."""
        return max(0, len(self._free) - sum(self._reserved.values()))

    def map_shared(self, slot: int, blocks: Sequence[int]) -> None:
        """Map already-resident blocks as ``slot``'s leading pages by
        reference (one retain each) — the prefix-sharing admit path. Must
        run right after :meth:`reserve` (the slot's table is still empty)
        and before any :meth:`ensure`; the shared pages were excluded from
        the reservation via ``reserve(..., shared_blocks=len(blocks))``."""
        mapped = self._mapped[slot]
        if mapped:
            raise ValueError(
                f"slot {slot} already maps {len(mapped)} pages; shared "
                "prefix pages must be the leading ones"
            )
        for block in blocks:
            self.retain(block)
            self._table[slot, len(mapped)] = block
            mapped.append(block)
            self.shared_maps_total += 1

    def page_shared(self, slot: int, page: int) -> bool:
        """True when ``slot``'s mapping at ``page`` is NOT exclusively
        owned (another slot or the prefix index also references the
        block) — the engine's write guard: such a page must be COW'd
        before any decode write could land on it."""
        mapped = self._mapped[slot]
        if page >= len(mapped):
            return False
        return self._refcount[mapped[page]] > 1

    def cow(self, slot: int, page: int, cause: str = "cow", *,
            use_reservation: bool = False) -> Tuple[int, int]:
        """Copy-on-write: replace ``slot``'s mapping at ``page`` with a
        fresh private block and deref the old one (tagged ``cause`` if
        that deref is its last). Returns ``(old_block, new_block)`` — the
        caller copies the page's device content before writing into it.

        ``use_reservation=True`` is the admit-time partial-block COW: that
        page was counted in the request's private need, so the swap
        consumes one reservation. The decode-path write guard passes
        False — the replaced page already consumed its reservation when it
        mapped, so the extra block comes from the free heap and must not
        eat into ANY slot's outstanding reservations
        (:class:`PoolExhausted` if it would)."""
        mapped = self._mapped[slot]
        if page >= len(mapped):
            raise ValueError(f"slot {slot} has no mapping at page {page}")
        if use_reservation and self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        elif len(self._free) <= sum(self._reserved.values()):
            raise PoolExhausted(
                "copy-on-write needs a free block but every free block is "
                "reserved"
            )
        old = mapped[page]
        new = self._alloc()
        mapped[page] = new
        self._table[slot, page] = new
        self.cow_swaps_total += 1
        self.high_water = max(self.high_water, self.in_use)
        self.deref(old, cause=cause)
        return old, new

    def ensure(self, slot: int, tokens: int) -> bool:
        """Map physical blocks for every page covering positions
        ``[0, tokens)`` of ``slot``, consuming its reservation; returns True
        when any new block was mapped (the caller refreshes gauges and the
        device table). Infallible for positions within the reservation —
        the free-list invariant guarantees a block is available. Pages
        already mapped (privately or shared) are left untouched.

        Lazy slots (:meth:`reserve_lazy`) may map past their hard
        reservation up to the soft watermark, allocating from the free
        heap — but only from blocks no hard reservation has spoken for;
        when none remains this raises :class:`PoolExhausted` with the slot
        table UNCHANGED (no partial mapping), the engine's cue to preempt
        a victim and retry."""
        pages = self.blocks_needed(tokens)
        mapped = self._mapped[slot]
        soft = self._soft.get(slot)
        if soft is not None and pages > soft:
            raise ValueError(
                f"slot {slot} needs {pages} pages past its soft watermark "
                f"{soft} — admission accounting bug"
            )
        changed = False
        while len(mapped) < pages:
            from_reservation = self._reserved[slot] > 0
            if not from_reservation:
                if soft is None:
                    raise ValueError(
                        f"slot {slot} mapping page {len(mapped)} past its "
                        "reservation — admission accounting bug"
                    )
                if len(self._free) <= sum(self._reserved.values()):
                    raise PoolExhausted(
                        f"slot {slot} crossing a block boundary at page "
                        f"{len(mapped)} with no unreserved free block — "
                        "preempt a victim to continue"
                    )
            block = self._alloc()
            if from_reservation:
                self._reserved[slot] -= 1
            self._table[slot, len(mapped)] = block
            mapped.append(block)
            changed = True
        if changed:
            self.high_water = max(self.high_water, self.in_use)
        return changed

    def ensure_many(self, slot: int, tokens: int) -> bool:
        """Burst form of :meth:`ensure` — ATOMIC over a multi-block span.

        A speculative round can accept up to ``k+1`` tokens at once, so one
        call may need to map several fresh blocks. :meth:`ensure` maps
        page-by-page and checks the lazy-slot free-heap guard per page:
        correct for the one-crossing-per-step decode path, but a burst
        hitting exhaustion mid-span would leave the LEADING pages mapped —
        a partial mapping the preempt-and-retry loop would then double
        count. This wrapper pre-checks the WHOLE span against the
        unreserved free heap (reservation-consuming pages keep
        :attr:`headroom_blocks` unchanged, so lazy pages alone spend it)
        and only then delegates — on :class:`PoolExhausted` the slot table
        is untouched, and the block-id sequence is identical to ``n``
        single :meth:`ensure` calls (same min-heap order)."""
        pages = self.blocks_needed(tokens)
        mapped = self._mapped[slot]
        new_pages = max(0, pages - len(mapped))
        if new_pages == 0:
            return False
        soft = self._soft.get(slot)
        if soft is not None and pages > soft:
            raise ValueError(
                f"slot {slot} needs {pages} pages past its soft watermark "
                f"{soft} — admission accounting bug"
            )
        lazy_pages = max(0, new_pages - self._reserved[slot])
        if lazy_pages:
            if soft is None:
                raise ValueError(
                    f"slot {slot} mapping {lazy_pages} pages past its "
                    "reservation — admission accounting bug"
                )
            if lazy_pages > self.headroom_blocks:
                raise PoolExhausted(
                    f"slot {slot} needs {lazy_pages} unreserved free blocks "
                    f"for a {new_pages}-page burst but only "
                    f"{self.headroom_blocks} remain — preempt a victim to "
                    "continue"
                )
        return self.ensure(slot, tokens)

    def release(self, slot: int, cause: str = "retire") -> int:
        """Deref ``slot``'s mapped blocks and drop its unconsumed
        reservation (retire/cancel/failover/timeout all route here);
        returns the number of blocks PHYSICALLY freed — shared blocks
        whose count stays positive (other slots, the prefix index) remain
        resident and are counted under :attr:`shared_derefs_total`
        instead. ``cause`` feeds :attr:`frees_by_cause` so cancellation
        reclaims stay separable from ordinary retirement churn."""
        mapped = self._mapped[slot]
        freed = 0
        for block in mapped:
            freed += self.deref(block, cause=cause)
        mapped.clear()
        self._reserved[slot] = 0
        self._soft.pop(slot, None)
        self._owner.pop(slot, None)
        self._table[slot, :] = 0
        return freed

    def release_all(self) -> int:
        """Failover path: every slot's pages back to the free list."""
        return sum(self.release(s, cause="failover") for s in range(self.slots))

    # -- host swap (docs/serving.md "Host-swap preemption") ------------------
    def extract(self, slot: int, cause: str = "swapped") -> Tuple[List[int], List[int]]:
        """Swap-out bookkeeping for ``slot``: split its mapped blocks into
        the leading prefix-shared run (refcount > 1 — deref'd, never
        copied; the bundle takes ONE retain on each so the device content
        stays resident) and the private tail, then :meth:`release` the
        slot so the private blocks return to the free heap tagged
        ``frees_by_cause[cause]``. Returns ``(shared, private)`` block-id
        lists in page order. The caller must gather the device pages
        BEFORE calling this — once released, the private ids may be
        re-allocated by the very next admission.

        Shared blocks form a leading run by construction:
        :meth:`map_shared` only ever maps leading pages, and any later
        write through a shared page went through :meth:`cow` first."""
        blocks = list(self._mapped[slot])
        shared: List[int] = []
        for block in blocks:
            if self._refcount.get(block, 0) > 1:
                shared.append(block)
            else:
                break
        for block in shared:
            self.retain(block)
        private = blocks[len(shared):]
        self.release(slot, cause=cause)
        return shared, private

    def restore(self, slot: int, shared: Sequence[int], total_tokens: int,
                resident_tokens: int) -> List[int]:
        """Re-admit a swapped-out victim into ``slot``: reserve its FULL
        worst case (pessimistic readmission — the anti-thrash rule; the
        ``shared`` prefix blocks are excluded), re-map the shared run by
        reference, then map fresh private blocks covering
        ``resident_tokens`` positions from whatever the free heap holds
        now. Returns the fresh private block ids (page order) — the engine
        scatters the bundle's page payload into exactly these. The caller
        drops the bundle's retains on ``shared`` afterwards (the slot now
        holds its own references). Raises :class:`PoolExhausted` with the
        slot untouched when the worst case doesn't fit yet."""
        self.reserve(slot, total_tokens, shared_blocks=len(shared))
        if shared:
            self.map_shared(slot, shared)
        self.ensure(slot, resident_tokens)
        return list(self._mapped[slot][len(shared):])

    # -- views --------------------------------------------------------------
    def table(self):
        """The ``(slots, pages_per_slot)`` int32 block table (a live view;
        the engine copies it to device each step it changed)."""
        return self._table

    def table_row(self, slot: int):
        return self._table[slot]

    def set_owner(self, slot: int, owner: Optional[str]) -> None:
        """Tag ``slot``'s blocks with an owner label (the engine's
        sanitized tenant label) for per-tenant attribution in
        :meth:`stats`; ``None`` clears the tag. Cleared automatically on
        :meth:`release` — a freed slot carries no stale attribution."""
        if owner is None:
            self._owner.pop(slot, None)
        else:
            self._owner[slot] = str(owner)

    def in_use_by_owner(self) -> Dict[str, int]:
        """Mapped blocks summed per owner label; untagged slots with
        mapped blocks attribute to ``"default"``. Shared (refcounted)
        blocks count once per mapping — attribution, so a tenant holding a
        reference is charged for it even when another tenant shares the
        physical block."""
        held: Dict[str, int] = {}
        for slot, mapped in self._mapped.items():
            if not mapped:
                continue
            owner = self._owner.get(slot, "default")
            held[owner] = held.get(owner, 0) + len(mapped)
        return dict(sorted(held.items()))

    def mapped_blocks(self, slot: int) -> int:
        return len(self._mapped[slot])

    def slot_blocks(self, slot: int) -> Tuple[int, ...]:
        """The physical block ids mapped to ``slot``, page order — the
        prefix index publishes a retired-to-be slot's leading full prefix
        blocks from this view."""
        return tuple(self._mapped[slot])

    def leaked(self) -> int:
        """Blocks neither free nor carrying a live reference — always 0
        unless the allocator itself is buggy (pinned by the leak drills).
        Refcount-aware: a prefix block retained by the index after its
        donor retired is REFERENCED, not leaked — it frees on its last
        deref (the satellite accounting the refcount drills pin). The
        cross-check against per-slot attribution still holds through
        :meth:`refcount`: every mapped occurrence plus every index retain
        is one count."""
        return self.num_blocks - len(self._free) - len(self._refcount)

    def utilization(self) -> float:
        return self.in_use / self.num_blocks

    def stats(self) -> dict:
        mapped_refs = sum(len(m) for m in self._mapped.values())
        total_refs = sum(self._refcount.values())
        return {
            "blocks": self.num_blocks,
            "block_size": self.block_size,
            "pages_per_slot": self.pages_per_slot,
            "in_use": self.in_use,
            "reserved": self.reserved,
            "high_water": self.high_water,
            "allocs_total": self.allocs_total,
            "frees_total": self.frees_total,
            "frees_by_cause": dict(sorted(self.frees_by_cause.items())),
            "utilization": round(self.utilization(), 4),
            # always 0 unless the allocator is buggy; surfaced here so a
            # scale-down victim's post-mortem (the autoscaler's `retired`
            # records) carries its own zero-leak evidence
            "leaked": self.leaked(),
            # refcounted-sharing accounting (docs/serving.md "Prefix
            # sharing"): blocks referenced beyond their mapping slot,
            # reference totals (mapped occurrences + index retains), and
            # the shared map / live-deref / COW churn counters
            "shared_blocks": sum(1 for c in self._refcount.values() if c > 1),
            "refs_total": total_refs,
            "refs_retained": total_refs - mapped_refs,
            "shared_maps_total": self.shared_maps_total,
            "shared_derefs_total": self.shared_derefs_total,
            "cow_swaps_total": self.cow_swaps_total,
            # optimistic-admission accounting (docs/serving.md "Preemption
            # & priorities"): residents admitted lazily and the distance to
            # the next boundary-crossing PoolExhausted
            "lazy_slots": len(self._soft),
            "headroom_blocks": self.headroom_blocks,
            # per-tenant pool attribution (docs/observability.md
            # "Scheduler timeline & post-mortems"): mapped blocks summed
            # per owner label the engine tagged at admission
            "in_use_by_owner": self.in_use_by_owner(),
        }


class _PrefixNode:
    """One full prompt-prefix block in the radix index: the token ids it
    covers (its edge label from ``parent``), the physical pool block
    holding those positions' cross k/v, and the LRU stamp."""

    __slots__ = ("tokens", "block", "parent", "children", "last_used")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_PrefixNode"]):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.last_used = 0


class PrefixBlockIndex:
    """Radix/trie index over published full prompt-prefix blocks
    (docs/serving.md "Prefix sharing").

    Each node is ONE full block of ``block_size`` token ids, chained from
    the prompt start — node depth ``i`` covers absolute positions
    ``[i*block_size, (i+1)*block_size)``, whose cross k/v are per-position
    functions of (token id, absolute position) in the ``kv_norm``-side
    prefix region, so a published block's device content is bit-valid for
    ANY later prompt sharing that token prefix. Only blocks fully inside
    their donor's prefix region are ever published (latent-region values
    are boundary-dependent and get rewritten by migration), which is what
    makes shared pages immutable for their whole residency.

    The index holds one pool reference per published block
    (:meth:`KVPagePool.retain`), so cached prefixes survive their donor's
    retirement and are dropped — LRU leaves first, ``cause="shared"`` —
    only by :meth:`evict_one` under pool pressure or :meth:`flush` on an
    engine state rebuild. All ordering is driven by a monotonic use
    counter, never wall time, so FakeClock drills replay bit-identically.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._tick = 0
        self.cached_blocks = 0
        self.published_total = 0
        self.evicted_total = 0

    # -- lookup --------------------------------------------------------------
    def _touch(self, node: _PrefixNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def match(self, tokens) -> List[_PrefixNode]:
        """Longest chain of cached FULL blocks matching the prompt's
        leading token ids (LRU-touched). The caller clamps the usable
        span to its own prefix region."""
        bs = self.block_size
        out: List[_PrefixNode] = []
        children = self._root
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                break
            self._touch(node)
            out.append(node)
            children = node.children
        return out

    def best_partial(self, matched: List[_PrefixNode], tokens) -> Tuple[Optional[_PrefixNode], int]:
        """The cached block extending ``matched`` whose token ids share
        the longest leading run with the prompt's next block — the
        divergent-mid-block COW donor. Returns ``(node, lcp_tokens)``;
        ``(None, 0)`` when nothing extends the chain. Ties break toward
        the most recently used node, then insertion order, so the choice
        is deterministic."""
        bs = self.block_size
        depth = len(matched)
        rest = tuple(int(t) for t in tokens[depth * bs:(depth + 1) * bs])
        if not rest:
            return None, 0
        children = matched[-1].children if matched else self._root
        best, best_lcp = None, 0
        for key, node in children.items():
            lcp = 0
            for a, b in zip(rest, key):
                if a != b:
                    break
                lcp += 1
            if lcp > best_lcp or (
                lcp == best_lcp and lcp > 0 and best is not None
                and node.last_used > best.last_used
            ):
                best, best_lcp = node, lcp
        if best is not None:
            self._touch(best)
        return best, best_lcp

    # -- publish -------------------------------------------------------------
    def insert(self, tokens, blocks: Sequence[int], pool: KVPagePool) -> int:
        """Publish ``blocks`` as the full prefix blocks covering
        ``tokens``' leading ids (block ``i`` holds positions
        ``[i*bs, (i+1)*bs)``); retains each NEWLY published block on the
        pool. Blocks whose token path is already cached are skipped — the
        first donor wins and later identical prefixes keep their private
        copies (no dedupe-in-place; docs/serving.md). Returns the number
        of blocks newly published."""
        bs = self.block_size
        children = self._root
        parent: Optional[_PrefixNode] = None
        published = 0
        for i, block in enumerate(blocks):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            if len(key) < bs:
                break
            node = children.get(key)
            if node is None:
                pool.retain(block)
                node = _PrefixNode(key, int(block), parent)
                children[key] = node
                self.cached_blocks += 1
                self.published_total += 1
                published += 1
            self._touch(node)
            parent = node
            children = node.children
        return published

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[_PrefixNode]:
        out = []
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def _drop(self, node: _PrefixNode, pool: KVPagePool, cause: str) -> int:
        siblings = node.parent.children if node.parent is not None else self._root
        del siblings[node.tokens]
        self.cached_blocks -= 1
        self.evicted_total += 1
        return pool.deref(node.block, cause=cause)

    def evict_one(self, pool: KVPagePool, cause: str = "shared") -> Optional[int]:
        """Drop the least-recently-used LEAF (trie integrity: a parent is
        only evictable once childless). Returns the number of pool blocks
        physically freed (0 when the block is still mapped by a resident
        — it frees later on that resident's release), or None when the
        index is empty."""
        leaves = self._leaves()
        if not leaves:
            return None
        victim = min(leaves, key=lambda n: n.last_used)
        return self._drop(victim, pool, cause)

    def flush(self, pool: KVPagePool, cause: str = "shared") -> int:
        """Drop every cached block (deepest first). Mandatory whenever the
        device pool's CONTENT is rebuilt (the slot engine's fault recovery),
        because the index's blocks would otherwise describe zeroed pages.
        Returns the number of pool blocks physically freed."""
        freed = 0
        while True:
            leaves = self._leaves()
            if not leaves:
                return freed
            for node in leaves:
                freed += self._drop(node, pool, cause)

    def stats(self) -> dict:
        return {
            "cached_blocks": self.cached_blocks,
            "published_total": self.published_total,
            "evicted_total": self.evicted_total,
        }
