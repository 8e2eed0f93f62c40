"""CacheBackend — the one protocol both KV-cache layouts serve.

PR 3 bought paged memory efficiency at the cost of a forked serving
stack: slot and paged each had their own scheduler, engine method pair,
and decode path.  This module collapses the fork.  A
:class:`CacheBackend` owns everything layout-specific about serving one
decode batch:

* **cache allocation** — the device pytree (contiguous slot rows or a
  block-pool arena), built by ``LLMEngine.new_cache(backend)``;
* **row insert** — landing freshly prefilled K/V in the cache
  (whole-row copy vs page scatter);
* **decode dispatch** — one greedy step across the slot batch
  (``cache_pos`` rows vs block tables);
* **extension** — chunked/prefix prefill of a prompt *suffix* against
  already-cached K/V, which is what makes chunked prefill work on both
  layouts (it generalizes PR 3's paged-only ``prefill_extend``);
* **speculative verify / truncate** — scoring a drafted token window in
  one pass and rolling the cache back behind the rejected tail (the
  slot layout rewinds its write position; the paged layout frees
  now-empty tail blocks — docs/SPECULATIVE.md).

The scheduler (:class:`repro_torch.serving.batching.Scheduler`) is backend
agnostic: it talks queueing, slots, chunking and preemption policy; the
backend talks memory.  When the paged backend runs out of blocks it
raises :class:`CachePressure` and the scheduler preempts a victim — the
**preemptive admission** mode (``admission="preempt"``, the default)
that replaces PR 3's worst-case block reservation.  PR 3's semantics
are preserved behind ``admission="reserve"`` for A/B comparison: a
request is admitted only once its worst-case page demand is reserved,
so pressure can never arise mid-flight.

A preempted request is recomputed on readmission: the scheduler ingests
``prompt ++ tokens[:-1]`` again.  The backend recomputes the prompt
through prefill and extend in its original chunks, and feeds the
streamed tokens through the serve decode (or verify) step, which is
the arithmetic the decode ticks that made them ran (on the state
layouts: the masked decode, or the verify window and the rewind of the
replayed row to the window's last position in range).  A replay through
prefill alone rounds differently from decode on the card in bf16 and
need not re-derive a streamed token (ROADMAP Hazard 5).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .allocator import BlockPool
from .prefix import ROOT, PrefixIndex, chain_key


def max_request_tokens(max_len: int, num_blocks: int = 0,
                       block_size: int = 0) -> int:
    """Largest prompt + max_new_tokens a backend can ever serve.  Shared
    with GraphServer so client-side validation matches scheduler-side.
    ``num_blocks`` is the MESH-WIDE arena size: under a serving mesh the
    arena's leaves are sharded across TP ranks, so each block costs
    1/tp of its bytes per rank and the pool is correspondingly larger
    (GraphServer scales its default by ``LLMEngine.cache_shards`` —
    docs/SHARDING.md); the capacity this reports is what the whole mesh
    serves, not one chip."""
    if num_blocks:
        return min(int(max_len), (int(num_blocks) - 1) * int(block_size))
    return int(max_len)


class CachePressure(Exception):
    """Raised by a backend when an allocation cannot be satisfied right
    now.  The scheduler reacts by preempting a victim and retrying —
    this is control flow, not an error."""


class CacheBackend:
    """Base class/protocol: layout-specific serving state + device ops.

    ``bind(stats, trace)`` is called once by the owning scheduler; it
    shares the scheduler's stats dict (one merged view for servers and
    benchmarks) and builds the device cache.
    """

    kind: str = ""
    supports_group_prefill: bool = False

    def __init__(self, engine, num_slots: int = 4):
        self.engine = engine
        self.num_slots = int(num_slots)
        self.cache = None
        self.stats: Dict[str, Any] = {}
        self._trace: Callable[[str, float], None] = lambda name, value: None

    def bind(self, stats: Dict[str, Any],
             trace: Optional[Callable] = None) -> None:
        for k, v in self._stat_seed().items():
            stats.setdefault(k, v)
        self.stats = stats
        if trace is not None:
            self._trace = trace
        self.cache = self.engine.new_cache(self)

    def _stat_seed(self) -> Dict[str, Any]:
        # forward passes of the decode or verify step made by replays
        return {"replay_steps": 0}

    # -- capacity / admission -------------------------------------------
    def max_request_tokens(self) -> int:
        """Largest prompt + max_new_tokens this backend serves.  Under a
        serving mesh this is MESH-WIDE capacity (the arena is sharded
        across TP ranks — docs/SHARDING.md), matching the module-level
        :func:`max_request_tokens` contract."""
        raise NotImplementedError

    def capacity_desc(self) -> str:
        raise NotImplementedError

    def mesh_desc(self) -> Dict[str, Any]:
        """Serving-mesh shape this backend's arena is sharded over
        (``{"devices": 1, "axes": {}}`` when unsharded)."""
        return self.engine.mesh_desc

    def _mesh_suffix(self) -> str:
        """Human-readable mesh annotation for capacity descriptions —
        empty when unsharded so single-device error text is unchanged."""
        desc = self.mesh_desc()
        tp = int(desc.get("axes", {}).get("model", 1))
        if tp <= 1:
            return ""
        return (f", mesh-wide over {tp} model-parallel ranks "
                f"({desc.get('devices', tp)} devices)")

    def can_admit(self, req, seq: np.ndarray,
                  chunk: Optional[int]) -> bool:
        """May ``req`` (whose ingest sequence is ``seq``) take a slot now?
        ``chunk`` is the scheduler's chunk size (None = whole prompt)."""
        return True

    def acquire(self, req, seq: np.ndarray) -> None:
        """Take per-request resources at admission (prefix match, block
        refs, reservations).  Sets ``req.prefix_len`` to the tokens
        already covered by shared cache."""
        req.prefix_len = 0

    def release(self, req) -> None:
        """Return every resource ``acquire``/``ingest``/``grow`` took —
        called on eviction AND on preemption."""

    def cancel(self, req) -> None:
        """Abandon ``req`` mid-flight (client disconnect / missed
        deadline): the cancel seam next to ``verify``/``truncate``.

        The base behaviour is exactly :meth:`release` — blocks freed,
        trie refs dropped, reservations returned — because scheduler
        ticks are atomic: a cancel always lands between ticks, when a
        speculative window has already been verified and truncated, so
        there is never half-written state to unwind.  A backend with
        asynchronous device work would override this to also fence or
        abandon in-flight operations for the slot."""
        self.release(req)

    # -- prompt ingestion -----------------------------------------------
    def align_chunk(self, chunk: int) -> int:
        return int(chunk)

    def prefill_group(self, reqs: List) -> np.ndarray:
        """Prefill several equal-length whole prompts as one batch and
        insert each row into its request's slot; returns the first
        generated token per request.  Only meaningful where
        ``supports_group_prefill``."""
        raise NotImplementedError

    def ingest(self, req, seq: np.ndarray, start: int,
               end: int) -> Optional[int]:
        """Compute cache entries for ``seq[start:end)`` of ``req``
        (attending over the already-ingested ``[0, start)``) and write
        them into the cache.  Returns the next token after position
        ``end - 1`` when ``end == len(seq)`` (the request's first
        generated token), else None.  May raise :class:`CachePressure`
        before mutating any state."""
        raise NotImplementedError

    def _prompt_end(self, req, start: int, end: int) -> int:
        """Where chunk ``[start, end)`` of ``req``'s sequence leaves its
        prompt: positions below run through prefill or extend, positions
        at and above (a readmitted request's streamed tokens) through
        :meth:`_replay`."""
        return min(max(start, int(req.prompt.size)), end)

    def _replay(self, req, seq: np.ndarray, start: int, end: int,
                tok: Optional[int]) -> int:
        """Recompute positions ``[start, end)`` of a readmitted ``req``,
        its streamed tokens (none where ``start == end``: then only
        ``tok`` is checked), through the serve decode step, or through
        verify windows of ``1 + speculate_k`` where the request
        speculates: the calls of a real tick, over all slots with only
        ``req``'s row active, which write its K/V with the arithmetic of
        the ticks that made them.  ``tok`` is the token derived for
        position ``start`` (None when derived by an earlier call).  Each
        derived token must be the streamed one it stands for; returns
        the token derived after position ``end - 1``."""
        N, row = self.num_slots, req.slot
        p = start
        while p < end:
            self._check_derived(req, seq, p, tok)
            n = min(1 + req.speculate_k, self.engine.max_len - p)
            window = np.zeros((N, n), np.int32)
            window[row, :min(n, len(seq) - p)] = seq[p:p + n]
            positions = np.full(N, self._stray_position(), np.int32)
            positions[row] = p
            active = np.zeros(N, bool)
            active[row] = True
            m = min(n, end - p)          # the window's positions in range
            if req.speculate_k > 0:
                guess = self._step(self._replay_verify(row, m), window,
                                   positions, active, row)[row]
            else:
                guess = self._step(self.engine.decode, window[:, 0],
                                   positions, active, row)[row:row + 1]
            self.stats["replay_steps"] += 1
            for s in range(m - 1):
                self._check_derived(req, seq, p + s + 1, int(guess[s]))
            tok = int(guess[m - 1])
            p += m
        self._check_derived(req, seq, end, tok)
        return tok

    def _replay_verify(self, row: int, m: int) -> Callable:
        """The engine call of a replayed verify window whose first ``m``
        positions are in range.  On the state layouts the window pass
        commits no recurrent state: the replayed row's state after
        window position ``m - 1`` is committed from the stacks, as the
        tick's truncate would."""
        if self.kind not in ("state", "hybrid"):
            return self.engine.verify

        def call(backend, cache, tokens, positions, active, **kw):
            guess, cache, stacks = self.engine.verify_window(
                backend, cache, tokens, positions, active, **kw)
            return guess, self.engine.state_rewind(cache, stacks, row, m - 1)

        return call

    @staticmethod
    def _check_derived(req, seq, p: int, tok: Optional[int]) -> None:
        """``tok``, derived for position ``p``, must be the token streamed
        there if ``p`` holds one (past the prompt; the last streamed
        token, past ``seq``, is the scheduler's to check)."""
        if tok is not None and req.prompt.size <= p < len(seq) \
                and tok != int(seq[p]):
            raise RuntimeError(
                f"request {req.id!r}: replay after preemption derived "
                f"token {tok} at position {p} where {int(seq[p])} was "
                f"streamed — determinism contract broken")

    def _stray_position(self) -> int:
        """The write position of a replay call's inactive rows."""
        return 0

    def _step(self, call, tokens, positions, active, row) -> np.ndarray:
        """One engine decode or verify call of a replay, ``row`` the
        replayed slot; returns the tokens."""
        out, self.cache = call(self, self.cache, tokens, positions, active)
        return out

    # -- decode ----------------------------------------------------------
    def grow(self, req, pos: int) -> bool:
        """Make sure write position ``pos`` of ``req`` is backed by cache
        memory.  False = out of memory (scheduler should preempt)."""
        return True

    def decode(self, last_tokens: np.ndarray, positions: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """One greedy decode step across all slots; returns [N] tokens."""
        raise NotImplementedError

    # -- speculative decoding (verify / truncate seam) --------------------
    def spec_window_cap(self, frontier: int) -> int:
        """Largest draft count ``k`` a verify tick may use when the
        batch's most-advanced row sits at ``frontier``.  The base bound
        is cache geometry — the window writes at every row's frontier,
        so ``frontier + k`` must stay inside ``max_len``.  State-slab
        backends clamp further: their verify materializes a per-position
        state stack, so the window is also a memory budget
        (``spec_window``, docs/STATE_CACHE.md)."""
        return self.engine.max_len - 1 - int(frontier)

    def verify(self, tokens: np.ndarray, positions: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """Score a speculative window — ``tokens`` is [N, 1+k] (each
        row's last emitted token ++ k drafted tokens) — in one batched
        forward pass; returns the [N, 1+k] greedy argmax at every window
        position.  K/V for the whole window is written at
        ``positions[slot]..positions[slot]+k``; the scheduler then keeps
        the accepted prefix (rewinding ``positions``) and calls
        :meth:`truncate` so the backend can reclaim memory behind the
        rejected tail."""
        raise NotImplementedError

    def truncate(self, req, new_len: int) -> None:
        """Roll ``req``'s cache memory back to ``new_len`` tokens after
        speculative verification rejected drafted tail tokens.

        The slot layout needs no action: the scheduler's rewound
        ``positions[slot]`` masks the stale tail K/V, and the next
        verify/decode window overwrites it before it can ever become
        readable.  The paged layout overrides this to free now-empty
        tail blocks back to the :class:`BlockPool`."""


class SlotBackend(CacheBackend):
    """Contiguous layout: one max_len cache row per slot.

    No per-request memory bookkeeping — a slot IS the reservation — so
    admission is slot-availability only and ``grow`` never fails.
    Chunked prefill extends a slot row in place (suffix K/V written at
    the row's current offset)."""

    kind = "slot"
    supports_group_prefill = True

    def max_request_tokens(self) -> int:
        return self.engine.max_len

    def capacity_desc(self) -> str:
        return f"engine max_len ({self.engine.max_len})" \
            + self._mesh_suffix()

    def prefill_group(self, reqs: List) -> np.ndarray:
        """The batch is padded to a power-of-two width with duplicates of
        its first row: group width depends on arrival timing, so without
        bucketing each new width is a fresh XLA compile at an
        unpredictable moment.  Padding rows are row-independent (they
        cannot perturb real rows) and are simply not inserted."""
        width = 1
        while width < len(reqs):
            width *= 2
        prompts = np.stack([r.prompt for r in reqs]
                           + [reqs[0].prompt] * (width - len(reqs)))
        first, rows = self.engine.prefill(prompts)
        for i, req in enumerate(reqs):
            self.cache = self.engine.insert(self, self.cache, rows, i,
                                            req.slot)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_padded_rows"] += width - len(reqs)
        self.stats["prefill_tokens"] += int(prompts.shape[1]) * len(reqs)
        return first

    def ingest(self, req, seq, start, end) -> Optional[int]:
        cut = self._prompt_end(req, start, end)
        tok = None
        if start < cut:
            if start == 0:
                first, rows = self.engine.prefill(seq[None, :cut])
                self.cache = self.engine.insert(self, self.cache, rows, 0,
                                                req.slot)
            else:
                first, self.cache = self.engine.extend(
                    self, self.cache, seq[start:cut], start, req.slot)
                self.stats["extend_prefills"] += 1
            tok = int(first[0])
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += int(cut - start)
        tok = self._replay(req, seq, cut, end, tok)
        return tok if end == len(seq) else None

    def _stray_position(self) -> int:
        """The last position of a row: no row ever reads K/V there that
        it did not write itself in the same step (a request's K/V ends
        at ``max_len - 2``; a window writes before it reads), and
        window positions past the row are not written.  A sliding
        window's rows wrap, and every slot of a row past its window
        holds a position the row still reads, so there the stray rows
        sit at -1, where the windowed decode writes nothing
        (``attention.window_slots``)."""
        if self.engine.cfg.sliding_window:
            return -1
        return self.engine.max_len - 1

    def decode(self, last_tokens, positions, active) -> np.ndarray:
        next_tok, self.cache = self.engine.decode(
            self, self.cache, last_tokens, positions, active)
        return next_tok

    def verify(self, tokens, positions, active) -> np.ndarray:
        guess, self.cache = self.engine.verify(
            self, self.cache, tokens, positions, active)
        return guess


class PagedBackend(CacheBackend):
    """Paged layout: K/V in a block-pool arena, reached via per-slot
    block tables; full prompt blocks shared through a hash-trie prefix
    index (ref-counted; a hit skips that prefix's prefill compute).

    Admission modes:

    * ``"preempt"`` (default) — optimistic watermark admission: a
      request is admitted once the blocks for its *next chunk* (plus
      ``watermark`` spare blocks) are free.  On pool exhaustion the
      backend raises :class:`CachePressure` / returns False from
      :meth:`grow` and the scheduler preempts the least-important
      request, whose blocks are freed and whose cache is recomputed on
      readmission — deterministic greedy decode keeps every output
      bit-identical.
    * ``"reserve"`` — PR 3's worst-case reservation: admission reserves
      ``ceil((prompt + max_new) / block_size)`` pages up front, so
      extension can never fail mid-flight (and preemption never
      triggers).  Kept for A/B comparison; it strands blocks that the
      typical request never touches.
    """

    kind = "paged"
    supports_group_prefill = False

    def __init__(self, engine, num_slots: int = 4, *, num_blocks: int,
                 block_size: int = 16, prefix_sharing: bool = True,
                 admission: str = "preempt", watermark: int = 0):
        super().__init__(engine, num_slots)
        if admission not in ("preempt", "reserve"):
            raise ValueError(f"admission must be 'preempt' or 'reserve', "
                             f"got {admission!r}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.admission = admission
        self.watermark = int(watermark)
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.prefix: Optional[PrefixIndex] = \
            PrefixIndex() if prefix_sharing else None
        self.pages_per_seq = engine.max_len // self.block_size
        self.tables = np.zeros((self.num_slots, self.pages_per_seq),
                               np.int32)
        # each request's prefix hits (blocks) at its first admission
        self._first_hits: "weakref.WeakKeyDictionary[Any, int]" = \
            weakref.WeakKeyDictionary()

    def _stat_seed(self):
        return {
            **super()._stat_seed(),
            "prefill_tokens_saved": 0,    # covered by shared prefix blocks
            "shared_block_hits": 0,
            "admission_blocked_on_blocks": 0, "blocks_peak": 0,
        }

    # -- capacity / admission -------------------------------------------
    def max_request_tokens(self) -> int:
        return max_request_tokens(self.engine.max_len, self.num_blocks,
                                  self.block_size)

    def capacity_desc(self) -> str:
        return (f"paged-arena capacity ({self.max_request_tokens()} tokens"
                f" = min of engine max_len {self.engine.max_len} and "
                f"{self.num_blocks - 1} usable blocks x "
                f"{self.block_size})") + self._mesh_suffix()

    def _worst_case_pages(self, req) -> int:
        return -(-(req.prompt.size + req.max_new_tokens)
                 // self.block_size)

    def _match(self, seq, req=None, chunk=None):
        if self.prefix is None:
            return [], ROOT
        hits, parent = self.prefix.match(seq, self.block_size,
                                         max_blocks=(len(seq) - 1)
                                         // self.block_size)
        first = self._first_hits.get(req) if req is not None else None
        if first is not None and len(hits) != first:
            # a readmission: take the most hits that put its chunk
            # boundaries where its first admission's were, so that its
            # prompt is recomputed in the same pieces (on the card a
            # row's bits may depend on the rows it is computed with)
            step = -(-chunk // self.block_size) if chunk else 0
            n = max((h for h in range(len(hits) + 1)
                     if h == first or (step and (h - first) % step == 0)),
                    default=len(hits))
            hits = hits[:n]
            parent = ROOT
            for i in range(n):
                parent = chain_key(parent, seq[i * self.block_size:
                                               (i + 1) * self.block_size])
        return hits, parent

    def can_admit(self, req, seq, chunk) -> bool:
        hits, parent = self._match(seq, req, chunk)
        # stash for acquire(): nothing can change the trie between the
        # admission check and the acquire that immediately follows it
        self._admit_match = (req, hits, parent)
        if self.admission == "reserve":
            need = max(0, self._worst_case_pages(req) - len(hits))
            ok = self.pool.can_reserve(need)
        else:
            # optimistic: only the next chunk's pages (beyond shared
            # prefix hits) plus the watermark must be free right now.
            # The target is capped at the arena size — a near-capacity
            # request that passed submit validation must stay admissible
            # once the pool fully drains, or it would starve the queue
            # forever (the watermark is a damper, not a capacity cut).
            start = len(hits) * self.block_size
            end = len(seq) if chunk is None else min(len(seq),
                                                     start + chunk)
            need = -(-end // self.block_size) - len(hits)
            target = min(need + self.watermark, self.num_blocks - 1)
            ok = self.pool.available_blocks >= target
        if not ok:
            self.stats["admission_blocked_on_blocks"] += 1
        return ok

    def acquire(self, req, seq) -> None:
        stash = getattr(self, "_admit_match", None)
        if stash is not None and stash[0] is req:
            _, hits, parent = stash
            self._admit_match = None
        else:
            hits, parent = self._match(seq, req)
        self._first_hits.setdefault(req, len(hits))
        for b in hits:
            self.pool.ref_inc(b)
        self.tables[req.slot] = 0
        self.tables[req.slot, :len(hits)] = hits
        req.blocks = list(hits)
        req.n_pages = len(hits)
        req.registered = len(hits)
        req.prefix_key = parent
        req.prefix_len = len(hits) * self.block_size
        if hits:
            self.stats["shared_block_hits"] += len(hits)
            self.stats["prefill_tokens_saved"] += req.prefix_len
        if self.admission == "reserve":
            need = max(0, self._worst_case_pages(req) - len(hits))
            self.pool.reserve(need)
            req.reserved_left = need
        self._trace_pool()

    def release(self, req) -> None:
        if req.slot >= 0:
            self.tables[req.slot] = 0
        for b in req.blocks:
            if self.pool.free(b) and self.prefix is not None:
                self.prefix.unregister_block(b)
        req.blocks = []
        req.n_pages = 0
        req.registered = 0
        req.prefix_len = 0
        req.prefix_key = None
        if req.reserved_left:
            self.pool.release_reservation(req.reserved_left)
            req.reserved_left = 0
        self._trace_pool()

    # -- allocation helpers ---------------------------------------------
    def _can_alloc(self, n: int) -> bool:
        if self.admission == "reserve":
            return True                   # drawn from the reservation
        return self.pool.available_blocks >= n

    def _alloc(self, req) -> int:
        if self.admission == "reserve":
            req.reserved_left -= 1
            blk = self.pool.allocate(reserved=True)
        else:
            blk = self.pool.allocate()
        self.stats["blocks_peak"] = self.pool.stats["peak_in_use"]
        return blk

    # -- ingestion -------------------------------------------------------
    def align_chunk(self, chunk: int) -> int:
        bs = self.block_size
        return max(bs, -(-int(chunk) // bs) * bs)

    def _insert_ref(self, req, page_ids):
        """Engine write ref for a whole-prompt insert (hybrid adds the
        slot so recurrent slabs land alongside the page scatter)."""
        return page_ids

    def _extend_ref(self, req, page_ids):
        """Engine write ref for a chunked/prefix extend."""
        return (self.tables[req.slot], page_ids)

    def ingest(self, req, seq, start, end) -> Optional[int]:
        bs = self.block_size
        new_pages = -(-end // bs) - req.n_pages
        if not self._can_alloc(new_pages):
            raise CachePressure(f"{new_pages} blocks needed, "
                                f"{self.pool.available_blocks} free")
        owned = [self._alloc(req) for _ in range(new_pages)]
        self.tables[req.slot, req.n_pages:req.n_pages + new_pages] = owned
        req.blocks += owned
        req.n_pages += new_pages
        cut = self._prompt_end(req, start, end)
        tok = None
        if start < cut:
            # the prompt's pages of this chunk; a replay's window writes
            # land in its pages through the block table
            page_ids = np.zeros(self.pages_per_seq, np.int32)
            n_ids = -(-cut // bs) - (start // bs)
            page_ids[:n_ids] = req.blocks[start // bs:start // bs + n_ids]
            if start == 0:
                first, rows = self.engine.prefill(seq[None, :cut])
                self.cache = self.engine.insert(
                    self, self.cache, rows, 0,
                    self._insert_ref(req, page_ids))
            else:
                first, self.cache = self.engine.extend(
                    self, self.cache, seq[start:cut], start,
                    self._extend_ref(req, page_ids))
                self.stats["extend_prefills"] += 1
            tok = int(first[0])
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += int(cut - start)
        tok = self._replay(req, seq, cut, end, tok)
        if self.prefix is not None:
            # newly-written FULL blocks become shareable (immutable from
            # here on: later writes always land at positions >= end)
            for i in range(req.registered, end // bs):
                req.prefix_key = self.prefix.register(
                    req.prefix_key, seq[i * bs:(i + 1) * bs],
                    req.blocks[i])
                req.registered = i + 1
        self._trace_pool()
        return tok if end == len(seq) else None

    def _step(self, call, tokens, positions, active, row) -> np.ndarray:
        # the other rows' windows land in trash block 0
        tables = np.zeros_like(self.tables)
        tables[row] = self.tables[row]
        out, self.cache = call(self, self.cache, tokens, positions, active,
                               block_tables=tables)
        return out

    # -- decode ----------------------------------------------------------
    def grow(self, req, pos: int) -> bool:
        page = pos // self.block_size
        if page < req.n_pages:
            return True
        if not self._can_alloc(1):
            return False
        blk = self._alloc(req)
        req.blocks.append(blk)
        self.tables[req.slot, page] = blk
        req.n_pages += 1
        return True

    def decode(self, last_tokens, positions, active) -> np.ndarray:
        next_tok, self.cache = self.engine.decode(
            self, self.cache, last_tokens, positions, active,
            block_tables=self.tables)
        self.stats["blocks_peak"] = self.pool.stats["peak_in_use"]
        self._trace_pool()
        return next_tok

    def verify(self, tokens, positions, active) -> np.ndarray:
        guess, self.cache = self.engine.verify(
            self, self.cache, tokens, positions, active,
            block_tables=self.tables)
        self.stats["blocks_peak"] = self.pool.stats["peak_in_use"]
        self._trace_pool()
        return guess

    def truncate(self, req, new_len: int) -> None:
        """Trim ``req``'s block table to ``ceil(new_len / block_size)``
        pages, freeing tail blocks that held only rejected draft tokens.

        Safe by construction w.r.t. sharing: the verify window starts at
        or past the request's generation frontier, which always lies
        beyond its shared/registered prefix blocks — so a freed tail
        block has ref 1 and is unregistered (the prefix-index unregister
        mirrors :meth:`release` for defense in depth).  In
        ``admission="reserve"`` mode each freed page returns to the
        request's reservation, preserving the never-fail-mid-flight
        guarantee."""
        keep = -(-int(new_len) // self.block_size)
        if keep < req.registered:
            raise RuntimeError(
                f"request {req.id!r}: truncate to {new_len} tokens would "
                f"drop registered prefix blocks ({req.registered} pages)")
        while req.n_pages > keep:
            blk = req.blocks.pop()
            req.n_pages -= 1
            self.tables[req.slot, req.n_pages] = 0
            if self.pool.free(blk) and self.prefix is not None:
                self.prefix.unregister_block(blk)
            if self.admission == "reserve":
                self.pool.reserve(1)
                req.reserved_left += 1
        self._trace_pool()

    def _trace_pool(self) -> None:
        self._trace("kvcache.blocks_in_use", self.pool.blocks_in_use)
        self._trace("kvcache.blocks_free", self.pool.free_blocks)


def make_backend(engine, *, paged: bool = False, num_slots: int = 4,
                 num_blocks: int = 0, block_size: int = 16,
                 prefix_sharing: bool = True, admission: str = "preempt",
                 watermark: int = 0, backend: Optional[str] = None,
                 spec_window: int = 8) -> CacheBackend:
    """Backend factory used by the serving calculator and launchers.

    ``backend`` selects the layout by name — ``"slot" | "paged" |
    "state" | "hybrid"`` — and wins over the legacy ``paged`` flag
    (kept so existing call sites stay valid).  ``spec_window`` is the
    state/hybrid verify-window cap (docs/STATE_CACHE.md)."""
    kind = backend if backend is not None else \
        ("paged" if paged else "slot")
    if kind == "slot":
        return SlotBackend(engine, num_slots)
    if kind == "paged":
        return PagedBackend(engine, num_slots, num_blocks=num_blocks,
                            block_size=block_size,
                            prefix_sharing=prefix_sharing,
                            admission=admission, watermark=watermark)
    # deferred import: state.py subclasses the classes defined above
    from .state import HybridBackend, StateBackend
    if kind == "state":
        return StateBackend(engine, num_slots, spec_window=spec_window)
    if kind == "hybrid":
        return HybridBackend(engine, num_slots, num_blocks=num_blocks,
                             block_size=block_size, admission=admission,
                             watermark=watermark,
                             spec_window=spec_window)
    raise ValueError(f"unknown backend kind {kind!r} (expected 'slot', "
                     f"'paged', 'state' or 'hybrid')")
