"""StateBackend + HybridBackend — recurrent state behind the CacheBackend seam.

Attention's KV cache grows with the sequence; Mamba/xLSTM mixers carry a
**fixed-size recurrent state** (conv tail + ``h`` for Mamba; ``C/n/m``
for mLSTM, ``c/n/h/m`` for sLSTM).  The CacheBackend protocol was first
written against growing caches, so recurrent and hybrid (Jamba-style)
stacks could only be served through the plain slot path with chunked
prefill, speculation and paged admission all gated off.  This module
closes that gap with two backends (docs/STATE_CACHE.md):

* :class:`StateBackend` — a per-slot **state-slab arena**: slot ``i`` of
  every layer's slab is request ``i``'s entire cache.  Capacity is O(1)
  per request regardless of sequence length, so the only admission
  resource is the slot itself and ``grow`` can never fail — the
  concurrent-request capacity story is "as many slots as fit in memory",
  not "as many *tokens*".  Mixed stacks are fine too: attention layers
  keep contiguous slot rows.
* :class:`HybridBackend` — Jamba-style per-layer composition: attention
  layers page K/V through the block-pool arena (block tables, preemptive
  or reserved admission, CachePressure) while recurrent layers live in
  state slabs keyed by the same scheduler slot.  One ``can_admit`` /
  ``CachePressure`` story covers both resource kinds, and ``release``
  frees blocks and clears slab bookkeeping atomically.

What makes every scheduler feature work on O(1) state:

* **Chunked prefill** — the model's recurrent prefill is a sequential
  per-token scan whose update replicates single-token decode op-for-op,
  so the slab row after chunk k is bit-identical to a cold prefill of
  ``prompt[:end_k]``: the slab IS the ingest-frontier checkpoint, and
  chunk boundaries can never shift the state.
* **Speculative verify / truncate** — state has no "rewind the position"
  rollback, so the verify pass leaves slabs *uncommitted* and returns a
  per-position **state stack** (the state after each window token);
  ``truncate(req, new_len)`` commits the accepted prefix's entry via a
  jitted rewind.  ``spec_window`` bounds the stack's memory, surfaced to
  the scheduler through :meth:`CacheBackend.spec_window_cap`.
* **Preemption / cancellation** — ``release`` only drops bookkeeping:
  slab garbage is harmless because the next insert overwrites the whole
  slot row (same argument the slot layout makes for its cache rows).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .backend import CacheBackend, PagedBackend, SlotBackend


class StateBackend(SlotBackend):
    """State-slab arena serving recurrent (and mixed) stacks.

    Inherits the slot layout's allocation story — a slot IS the
    reservation, admission is slot-availability only — because a
    recurrent layer's slot cache already *is* a fixed-size state slab.
    What it adds is the state lifecycle: masked decode commits (the
    engine's ``state`` layout guards mid-ingest frontier state from
    stray batch writes), stack-returning verify, and truncate-as-rewind.

    ``spec_window`` caps the speculative window: verify materializes a
    per-position state stack ([N, 1+k, ...] per state leaf), so the
    draft budget is a memory knob here, not just a latency one.
    """

    kind = "state"
    supports_group_prefill = True

    def __init__(self, engine, num_slots: int = 4, *,
                 spec_window: int = 8):
        super().__init__(engine, num_slots)
        self.spec_window = int(spec_window)
        self._stacks = None                 # last verify's state stacks
        self._stack_pos0: Optional[np.ndarray] = None
        self._held: set = set()             # slots with a live slab

    def _stat_seed(self):
        # the base's stats too: the port's replays count their steps
        return {**super()._stat_seed(),
                "state_slabs_in_use": 0, "state_slabs_peak": 0}

    # -- capacity / admission -------------------------------------------
    @property
    def slabs_in_use(self) -> int:
        return len(self._held)

    def capacity_desc(self) -> str:
        return (f"engine max_len ({self.engine.max_len}); O(1) state "
                f"slabs impose no per-token bound") + self._mesh_suffix()

    def acquire(self, req, seq) -> None:
        super().acquire(req, seq)
        self._held.add(req.slot)
        self.stats["state_slabs_in_use"] = len(self._held)
        self.stats["state_slabs_peak"] = max(
            self.stats["state_slabs_peak"], len(self._held))
        self._trace("kvcache.state_slabs_in_use", len(self._held))

    def release(self, req) -> None:
        self._held.discard(req.slot)
        self.stats["state_slabs_in_use"] = len(self._held)
        self._trace("kvcache.state_slabs_in_use", len(self._held))
        super().release(req)

    # -- speculative decoding -------------------------------------------
    def spec_window_cap(self, frontier: int) -> int:
        return max(0, min(CacheBackend.spec_window_cap(self, frontier),
                          self.spec_window))

    def verify(self, tokens, positions, active) -> np.ndarray:
        guess, self.cache, self._stacks = self.engine.verify_window(
            self, self.cache, tokens, positions, active)
        self._stack_pos0 = np.asarray(positions).copy()
        return guess

    def truncate(self, req, new_len: int) -> None:
        """Commit the accepted prefix's recurrent state: the stack entry
        for the last *kept* window position (``new_len - 1`` in absolute
        positions, i.e. index ``new_len - pos0 - 1`` into the window)
        becomes the slab row.  Called once per surviving row right after
        its verify tick, while the stacks stashed by :meth:`verify` are
        current — finished rows are evicted instead (slab garbage is
        overwritten by the next insert)."""
        if self._stacks is None:
            return
        idx = int(new_len) - int(self._stack_pos0[req.slot]) - 1
        self.cache = self.engine.state_rewind(self.cache, self._stacks,
                                              req.slot, idx)


class HybridBackend(PagedBackend):
    """Jamba-style per-layer composition: paged attention + state slabs.

    Attention layers inherit the full paged story — block tables,
    watermark/reserve admission, ``CachePressure`` → preemption, tail
    block frees on truncate.  Recurrent layers ride the scheduler slot:
    their slab row needs no admission accounting (it exists for every
    slot) and no ``grow``; ``release`` drops block AND slab bookkeeping
    in one call, so the two resource kinds can never leak apart.

    Prefix sharing is force-disabled: a recurrent state summarizes its
    *entire* prefix positionally, so a shared attention block has no
    state counterpart to share — admission math is pages-only and
    ``prefix_len`` is always 0.
    """

    kind = "hybrid"
    supports_group_prefill = False

    def __init__(self, engine, num_slots: int = 4, *, num_blocks: int,
                 block_size: int = 16, admission: str = "preempt",
                 watermark: int = 0, spec_window: int = 8):
        super().__init__(engine, num_slots, num_blocks=num_blocks,
                         block_size=block_size, prefix_sharing=False,
                         admission=admission, watermark=watermark)
        self.spec_window = int(spec_window)
        self._stacks = None
        self._stack_pos0: Optional[np.ndarray] = None
        self._held: set = set()

    def _stat_seed(self):
        seed = super()._stat_seed()
        seed.update({"state_slabs_in_use": 0, "state_slabs_peak": 0})
        return seed

    # -- capacity / admission -------------------------------------------
    @property
    def slabs_in_use(self) -> int:
        return len(self._held)

    def capacity_desc(self) -> str:
        return (f"hybrid capacity ({self.max_request_tokens()} tokens = "
                f"min of engine max_len {self.engine.max_len} and "
                f"{self.num_blocks - 1} usable blocks x {self.block_size}"
                f" for the attention layers; state slabs are O(1))"
                ) + self._mesh_suffix()

    def acquire(self, req, seq) -> None:
        super().acquire(req, seq)
        self._held.add(req.slot)
        self.stats["state_slabs_in_use"] = len(self._held)
        self.stats["state_slabs_peak"] = max(
            self.stats["state_slabs_peak"], len(self._held))
        self._trace("kvcache.state_slabs_in_use", len(self._held))

    def release(self, req) -> None:
        self._held.discard(req.slot)
        self.stats["state_slabs_in_use"] = len(self._held)
        self._trace("kvcache.state_slabs_in_use", len(self._held))
        super().release(req)

    # -- ingestion refs (see PagedBackend.ingest) ------------------------
    def _insert_ref(self, req, page_ids):
        return (page_ids, req.slot)

    def _extend_ref(self, req, page_ids):
        return (self.tables[req.slot], page_ids, req.slot)

    # -- speculative decoding -------------------------------------------
    def spec_window_cap(self, frontier: int) -> int:
        return max(0, min(CacheBackend.spec_window_cap(self, frontier),
                          self.spec_window))

    def verify(self, tokens, positions, active) -> np.ndarray:
        guess, self.cache, self._stacks = self.engine.verify_window(
            self, self.cache, tokens, positions, active,
            block_tables=self.tables)
        self._stack_pos0 = np.asarray(positions).copy()
        self.stats["blocks_peak"] = self.pool.stats["peak_in_use"]
        self._trace_pool()
        return guess

    def truncate(self, req, new_len: int) -> None:
        """Paged tail frees (super) + recurrent state commit — see
        :meth:`StateBackend.truncate`."""
        super().truncate(req, new_len)
        if self._stacks is None:
            return
        idx = int(new_len) - int(self._stack_pos0[req.slot]) - 1
        self.cache = self.engine.state_rewind(self.cache, self._stacks,
                                              req.slot, idx)
