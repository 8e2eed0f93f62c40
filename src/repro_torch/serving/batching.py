"""Continuous batching: ONE scheduler over the CacheBackend protocol.

This is the core of the GraphServer subsystem (vLLM-style continuous
batching mapped onto the repo's MediaPipe-like graph runtime).  The decode
batch is a fixed set of ``num_slots`` *slots*; each slot holds one
in-flight request's cache row (contiguous) or block table (paged) — the
layout difference lives entirely behind the request's
:class:`~repro_torch.serving.kvcache.CacheBackend`.  The scheduler owns policy:
the priority queue, slot assignment, **chunked prefill** (long prompts
ingested in fixed-token chunks interleaved with decode ticks, so a long
arrival no longer stalls every active request's next token),
**preemption** (when the paged backend runs out of blocks, the
least-important request is evicted and recomputed on readmission) and
**self-speculative decoding** (``speculate_k``: prompt-lookup drafts
verified in one batched pass, ``accepted + 1`` tokens emitted per tick
— docs/SPECULATIVE.md).

Determinism: greedy decode stays bit-identical to
``LLMEngine.generate`` one request at a time under every schedule —
admission order, chunk boundaries, speculative drafts and preemptions
included.  Prefill
batches group only equal-length prompts (no padding perturbs positions),
every decode-batch row op is row-independent, chunked/prefix extension
reproduces exactly the cold prefill's K/V (see the model-layer
docstrings), and a preempted request replays ``prompt ++ tokens[:-1]``
through the same deterministic prefill, re-deriving — and suppressing —
its already-streamed tokens before continuing.

The scheduler here is host-side and graph-agnostic: the MediaPipe wiring
(admission through ``FlowLimiterCalculator``, the tick loopback that lets
the graph scheduler interleave admission with decode steps) lives in
:mod:`repro.serving.calculators` / :mod:`repro.serving.pipeline`.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .kvcache.backend import CacheBackend, CachePressure
from .speculative import lookup_draft

_EMPTY_DRAFT = np.zeros(0, np.int32)

#: ids whose cancel arrived before the request itself (a CONTROL packet
#: overtaking its REQUEST through the flow limiter) are remembered up to
#: this many entries; older entries age out (a cancel for an id that
#: never arrives — e.g. shed upstream — must not pin memory forever).
_CANCEL_BACKLOG = 1024


class DeadlineExceeded(ValueError):
    """A request's deadline was already expired at submission time.

    Typed (rather than a bare ``ValueError``) so front ends can map it to
    a distinct client-visible rejection without string matching."""


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request as tracked by the scheduler."""
    id: Any
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    priority: int = 0                  # higher value = more important
    arrival: int = 0                   # monotone submission order
    speculate_k: int = 0               # max drafted tokens per decode tick
    # SLO fields (absolute times on the scheduler's clock; None = no SLO)
    deadline: Optional[float] = None        # whole request must finish by
    ttft_deadline: Optional[float] = None   # first token must be out by
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None     # first slot admission
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None   # maintained when observing
    # per-request speculative tallies (cheap ints; feed the final
    # per-request metrics record surfaced by the frontend)
    spec_drafted: int = 0
    spec_accepted: int = 0
    cancelled: bool = False            # cancel requested (or applied)
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    ingested: int = 0                  # tokens of `seq` already in cache
    preemptions: int = 0
    finished: bool = False
    finish_reason: str = ""            # "eos" | "length"
    # backend-owned state (paged: block table bookkeeping)
    blocks: List[int] = dataclasses.field(default_factory=list)
    n_pages: int = 0                   # pages present in the block table
    registered: int = 0                # pages published to the prefix index
    reserved_left: int = 0             # reserved-but-unallocated pages
    prefix_len: int = 0                # tokens reused from shared blocks
    prefix_key: Any = None             # prefix-index chain key

    @property
    def seq(self) -> np.ndarray:
        """The token sequence whose K/V must be in cache before this
        request can decode: the prompt, plus — after a preemption —
        every already-emitted token except the last (the last emitted
        token is re-derived by the replay prefill itself, which is what
        proves the recomputation bit-identical)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens[:-1], np.int32)])

    def sort_key(self):
        return (-self.priority, self.arrival)


@dataclasses.dataclass
class TokenEvent:
    """One generated token (or the request's completion).

    ``token is None`` marks a token-less completion: the request left the
    system by cancellation or a missed deadline instead of generating a
    final token (``request.finish_reason`` says which)."""
    request: Request
    token: Optional[int]
    index: int                          # 0-based position in the generation
    finished: bool


class Scheduler:
    """Admission + chunked prefill + per-step decode over a fixed-width
    slot batch, parameterized by a :class:`CacheBackend`.

    Drive it with::

        sched.submit(payload)      # any number of times, any time
        events = sched.admit()     # admission + one prefill chunk each
        events += sched.step()     # one decode step across active slots

    until :meth:`has_work` is False.  ``admit``/``step`` return
    :class:`TokenEvent` lists in deterministic order.

    ``chunk_size`` enables chunked prefill: a prompt longer than one
    chunk is ingested one chunk per ``admit`` tick while other slots keep
    decoding (the backend aligns the chunk — paged rounds up to a whole
    number of blocks).  ``None`` ingests whole prompts at admission.

    ``speculate_k`` enables self-speculative decoding (the default for
    requests that don't override it): each decode tick drafts up to
    ``k`` continuation tokens by prompt lookup
    (:func:`repro_torch.serving.speculative.lookup_draft`, n-gram size
    ``spec_ngram``), verifies the whole window in one batched forward
    pass, and emits ``accepted + 1`` tokens — bit-identical to plain
    greedy decode under every acceptance pattern (docs/SPECULATIVE.md).
    ``draft_fn(context, k)`` swaps in a custom drafting policy.
    """

    def __init__(self, backend: CacheBackend, *,
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 pad_id: int = 0, chunk_size: Optional[int] = None,
                 speculate_k: int = 0, spec_ngram: int = 3,
                 draft_fn: Optional[Callable[[np.ndarray, int],
                                             np.ndarray]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 trace=None, observer=None):
        engine = backend.engine
        if engine.cfg.is_encoder_decoder:
            raise ValueError("continuous batching supports decoder-only "
                             "models (encoder-decoder prefill needs "
                             "enc_embeds plumbing)")
        self.backend = backend
        self.engine = engine
        self.num_slots = backend.num_slots
        self.default_max_new = int(max_new_tokens)
        self.default_eos = eos_id
        self.pad_id = int(pad_id)
        self.chunk: Optional[int] = None
        if chunk_size is not None:
            engine.check_extend_support(backend.kind)
            self.chunk = backend.align_chunk(chunk_size)
        self.default_spec_k = int(speculate_k)
        self.draft_fn = draft_fn if draft_fn is not None else \
            functools.partial(lookup_draft, max_ngram=int(spec_ngram))
        self._spec_checked = False
        if self.default_spec_k > 0:
            self._check_spec()
        self.clock = clock
        self._has_slo = False          # any live request carries a deadline
        # cancels that arrived before their request (id -> True), capped
        self._cancelled_ids: "collections.OrderedDict[Any, bool]" = \
            collections.OrderedDict()
        self.waiting: List[Request] = []      # sorted by sort_key()
        self.ingesting: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self.free: List[int] = list(range(self.num_slots))  # LIFO reuse
        self.positions = np.zeros(self.num_slots, np.int32)
        self.last_tokens = np.full(self.num_slots, self.pad_id, np.int32)
        self._arrival = itertools.count()
        self.stats: Dict[str, Any] = {
            "submitted": 0, "completed": 0, "decode_steps": 0,
            "prefill_calls": 0, "prefill_requests": 0,
            "prefill_padded_rows": 0,
            "prefill_tokens": 0,          # prompt tokens actually computed
            "extend_prefills": 0, "chunked_prefill_ticks": 0,
            "preemptions": 0, "replayed_tokens": 0,
            "evictions_eos": 0, "evictions_length": 0,
            # speculative decoding: verify ticks, drafted/accepted draft
            # tokens, and tokens emitted on verify ticks (accepted + 1
            # bonus each) — acceptance rate = spec_accepted/spec_drafted
            "spec_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
            "spec_emitted": 0,
            # front-door lifecycle: requests cancelled (client disconnect
            # / explicit cancel) and requests terminated for a missed
            # deadline or TTFT target — both count toward `completed`
            "requests_cancelled": 0, "deadline_missed": 0,
            "max_active_slots": 0,
            # peak requests inside the subsystem (waiting + active): with a
            # FlowLimiter upstream this must never exceed max_in_flight
            "max_outstanding": 0,
        }
        self._trace = trace if trace is not None else \
            (lambda name, value: None)
        # lifecycle observer (serving/observe.py): spans + metrics.  The
        # `_observe` flag gates every clock read the hooks would need, so
        # a NULL_OBSERVER scheduler's hot path stays timing-free.
        from .observe import NULL_OBSERVER
        self.obs = observer if observer is not None else NULL_OBSERVER
        self._observe = bool(self.obs.enabled)
        backend.bind(self.stats, trace)

    def _check_spec(self) -> None:
        if not self._spec_checked:
            self.engine.check_spec_support(self.backend.kind)
            self._spec_checked = True

    # -- backend conveniences (servers, benchmarks, tests) ---------------
    @property
    def pool(self):
        return getattr(self.backend, "pool", None)

    @property
    def prefix(self):
        return getattr(self.backend, "prefix", None)

    # -- state predicates -------------------------------------------------
    @property
    def active(self) -> int:
        return self.num_slots - len(self.free)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.active > 0

    # -- request intake ---------------------------------------------------
    def submit(self, payload: Dict[str, Any]) -> Request:
        """payload: {'tokens': [S] ints, 'id': any, 'max_new_tokens': int?,
        'eos_id': int?, 'priority': int?, 'speculate_k': int?,
        'deadline_ms': float?, 'ttft_ms': float?, 'deadline': float?,
        'ttft_deadline': float?}.
        Validated against the backend's REAL capacity (paged: arena
        blocks, not just engine.max_len) so an unservable request fails
        here instead of starving the queue.

        SLO fields: ``deadline_ms`` / ``ttft_ms`` are relative to now
        (this submit) and raise :class:`DeadlineExceeded` when already
        non-positive — a request that cannot possibly meet its deadline
        is rejected up front rather than admitted to fail.  ``deadline``
        / ``ttft_deadline`` are absolute times on the scheduler's clock
        (used by the GraphServer, which validates at ITS submit time and
        must not crash the graph when time in the admission queue eats
        the budget — that becomes a `deadline_missed`, not an error)."""
        prompt = np.asarray(payload["tokens"], np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        max_new = int(payload.get("max_new_tokens", self.default_max_new))
        cap = self.backend.max_request_tokens()
        if prompt.size + max_new > cap:
            raise ValueError(
                f"request {payload.get('id')!r}: prompt ({prompt.size}) + "
                f"max_new_tokens ({max_new}) exceeds "
                f"{self.backend.capacity_desc()}")
        spec_k = int(payload.get("speculate_k", self.default_spec_k))
        if spec_k < 0:
            raise ValueError(f"request {payload.get('id')!r}: "
                             f"speculate_k must be >= 0, got {spec_k}")
        if spec_k > 0:
            self._check_spec()
        deadline = payload.get("deadline")
        ttft_deadline = payload.get("ttft_deadline")
        now = None
        for rel_key, abs_val in (("deadline_ms", deadline),
                                 ("ttft_ms", ttft_deadline)):
            if payload.get(rel_key) is None:
                continue
            rel = float(payload[rel_key])
            if rel <= 0:
                raise DeadlineExceeded(
                    f"request {payload.get('id')!r}: {rel_key}={rel:g} "
                    f"is already expired at submit")
            now = self.clock() if now is None else now
            if rel_key == "deadline_ms":
                deadline = now + rel / 1e3
            else:
                ttft_deadline = now + rel / 1e3
        req = Request(
            id=payload.get("id"),
            prompt=prompt,
            max_new_tokens=max_new,
            eos_id=payload.get("eos_id", self.default_eos),
            priority=int(payload.get("priority", 0)),
            speculate_k=spec_k,
            deadline=deadline,
            ttft_deadline=ttft_deadline,
            arrival=next(self._arrival))
        req.submitted_at = now if now is not None else self.clock()
        if deadline is not None or ttft_deadline is not None:
            self._has_slo = True
        if self._cancelled_ids.pop(req.id, None):
            # the cancel overtook the request through the admission path:
            # mark it now, the next admit() sweep completes it
            req.cancelled = True
        bisect.insort(self.waiting, req, key=Request.sort_key)
        self.stats["submitted"] += 1
        self.stats["max_outstanding"] = max(
            self.stats["max_outstanding"],
            self.stats["submitted"] - self.stats["completed"])
        if self._observe:
            self.obs.submitted(req, len(self.waiting))
        return req

    # -- cancellation + deadlines -----------------------------------------
    def cancel(self, target: Any) -> List[TokenEvent]:
        """Cancel a request at ANY point of its lifecycle; returns the
        completion event (empty list when there is nothing to cancel).

        ``target`` is a :class:`Request` or a request id.  Semantics per
        state:

        * **waiting / preempted-and-requeued** — dequeued and completed;
          it holds no cache resources (``release`` ran at preemption), so
          nothing else happens.  In particular a preempted-then-cancelled
          request does NOT take another ``preemptions`` count — cancel is
          its own path, never routed through :meth:`preempt`.
        * **active (mid-ingest / mid-decode / between verify ticks)** —
          the backend's :meth:`~repro_torch.serving.kvcache.CacheBackend.cancel`
          seam releases the slot's memory (paged: blocks freed, trie refs
          dropped, reservations returned) and the slot returns to the
          free list.  Scheduler ticks are atomic, so a "mid-verify"
          cancel lands between ticks, when positions/truncate already
          rolled the rejected tail back — abandoning a speculative
          window is always safe.
        * **unknown id** — remembered (bounded backlog) so a cancel that
          overtakes its own request through the admission path still
          lands; the request completes as cancelled at its first
          ``admit`` tick.  A cancel for an id that already finished is a
          no-op beyond that bookkeeping (the post-EOS race).

        Already-streamed tokens stay valid; the completion event carries
        ``token=None`` and ``finish_reason='cancelled'``."""
        req = target if isinstance(target, Request) else self._find(target)
        if req is None:
            self._cancelled_ids[target] = True
            while len(self._cancelled_ids) > _CANCEL_BACKLOG:
                self._cancelled_ids.popitem(last=False)
            return []
        if req.finished:
            return []
        req.cancelled = True
        return [self._finish_empty(req, "cancelled")]

    def _find(self, rid: Any) -> Optional[Request]:
        for r in self.slots:
            if r is not None and r.id == rid:
                return r
        for r in self.waiting:
            if r.id == rid:
                return r
        return None

    def _finish_empty(self, req: Request, reason: str) -> TokenEvent:
        """Terminate ``req`` without a token (cancel / missed deadline),
        releasing whatever it holds."""
        if req.slot >= 0 and self.slots[req.slot] is req:
            if req in self.ingesting:
                self.ingesting.remove(req)
            slot = req.slot
            self.backend.cancel(req)
            self.slots[slot] = None
            self.positions[slot] = 0
            self.last_tokens[slot] = self.pad_id
            self.free.append(slot)
            req.slot = -1
        elif req in self.waiting:
            self.waiting.remove(req)
        req.finished = True
        req.finish_reason = reason
        self.stats["completed"] += 1
        key = "requests_cancelled" if reason == "cancelled" \
            else "deadline_missed"
        self.stats[key] += 1
        self._trace(f"serve.{key}", self.stats[key])
        if self._observe:
            self.obs.finished(req, reason)
        return TokenEvent(req, None, len(req.tokens), True)

    def _lifecycle_sweep(self) -> List[TokenEvent]:
        """Complete pending cancellations and expire missed deadlines —
        runs at the top of every :meth:`admit` tick."""
        events: List[TokenEvent] = []
        for req in [r for r in self.waiting if r.cancelled]:
            events.append(self._finish_empty(req, "cancelled"))
        if not self._has_slo:
            return events
        now = self.clock()
        live = [r for r in self.waiting] + \
               [r for r in self.slots if r is not None]
        for req in live:
            if req.finished:
                continue
            missed = (req.deadline is not None and now >= req.deadline) \
                or (req.first_token_at is None
                    and req.ttft_deadline is not None
                    and now >= req.ttft_deadline)
            if missed:
                events.append(self._finish_empty(req, "deadline"))
        return events

    def _slo_preempt(self) -> bool:
        """SLO-aware admission: when no slot is free, a waiting request
        with a TTFT target may preempt a strictly-lower-priority active
        request (lowest priority, youngest arrival — same victim rule as
        cache pressure).  Equal priority never preempts, so plain
        priority admission keeps its no-preemption behaviour."""
        if self.free or not self.waiting:
            return bool(self.free)
        head = self.waiting[0]
        if head.ttft_deadline is None:
            return False
        candidates = [r for r in self.slots if r is not None]
        if not candidates:
            return False
        victim = min(candidates, key=lambda r: (r.priority, -r.arrival))
        if victim.priority >= head.priority:
            return False
        self._preempt(victim)
        return True

    # -- admission + chunked prefill --------------------------------------
    def admit(self) -> List[TokenEvent]:
        """Admit waiting requests into free slots and advance prompt
        ingestion by (at most) one chunk per in-flight request.

        Requests whose whole prompt fits one chunk are prefilled as one
        batch per equal prompt length when the backend supports it
        (dynamic prefill batching; padding rows are row-independent).
        Otherwise each newly-admitted request ingests its first chunk
        immediately — one at a time, so a request can share prefix
        blocks registered by the one admitted just before it.

        Before admission the tick sweeps lifecycle state: pending
        cancellations complete (resources released), expired deadlines
        and missed TTFT targets terminate their requests, and a waiting
        request with a TTFT target may preempt a strictly-lower-priority
        active request when no slot is free (SLO-aware admission — the
        deadline feeds the same priority+preemption machinery pressure
        uses)."""
        events: List[TokenEvent] = self._lifecycle_sweep()
        # continue in-flight chunked ingests first (FIFO fairness)
        for req in list(self.ingesting):
            events.extend(self._ingest_tick(req))
        group: List[Request] = []
        while self.waiting and (self.free or self._slo_preempt()):
            req = self.waiting[0]
            if not self.backend.can_admit(req, req.seq, self.chunk):
                break
            self.waiting.pop(0)
            slot = self.free.pop()
            req.slot = slot
            self.slots[slot] = req
            self.backend.acquire(req, req.seq)
            req.ingested = req.prefix_len
            self.positions[slot] = req.ingested
            self.ingesting.append(req)
            self.stats["max_active_slots"] = max(
                self.stats["max_active_slots"], self.active)
            if self._observe:
                first_admission = req.admitted_at is None
                if first_admission:
                    req.admitted_at = self.clock()
                # queue wait counts only the initial submit->slot wait;
                # readmissions after preemption still get their span
                self.obs.admitted(
                    req, (req.admitted_at - req.submitted_at) * 1e3
                    if first_admission else None)
            if (self.backend.supports_group_prefill and not req.tokens
                    and req.ingested == 0
                    and (self.chunk is None
                         or req.prompt.size <= self.chunk)):
                group.append(req)
            else:
                events.extend(self._ingest_tick(req))
        if group:
            events.extend(self._group_prefill(group))
        return events

    def _group_prefill(self, reqs: List[Request]) -> List[TokenEvent]:
        """Whole-prompt batch prefill, one call per distinct length."""
        events: List[TokenEvent] = []
        by_len: Dict[int, List[Request]] = {}
        for r in reqs:
            by_len.setdefault(int(r.prompt.size), []).append(r)
        for grp in sorted(by_len.values(), key=lambda g: g[0].arrival):
            t0 = self.obs.now() if self._observe else 0.0
            first = self.backend.prefill_group(grp)
            if self._observe:
                self.obs.prefill((self.obs.now() - t0) * 1e3,
                                 sum(int(r.prompt.size) for r in grp))
            for i, req in enumerate(grp):
                self.ingesting.remove(req)
                req.ingested = req.prompt.size
                self.positions[req.slot] = req.prompt.size
                self.stats["prefill_requests"] += 1
                events.append(self._record(req, int(first[i])))
        return events

    def _ingest_tick(self, req: Request) -> List[TokenEvent]:
        """Ingest the next chunk of ``req``'s sequence, preempting under
        cache pressure.  Emits the first generated token when ingestion
        completes (suppressed on a post-preemption replay: the re-derived
        token was already streamed)."""
        if req not in self.ingesting:      # preempted earlier this round
            return []
        seq = req.seq
        start = req.ingested
        end = len(seq) if self.chunk is None \
            else min(len(seq), start + self.chunk)
        while True:
            try:
                t0 = self.obs.now() if self._observe else 0.0
                tok = self.backend.ingest(req, seq, start, end)
                if self._observe:
                    self.obs.chunk(req, start, end,
                                   (self.obs.now() - t0) * 1e3)
                break
            except CachePressure:
                if self._observe:
                    self.obs.pressure(req)
                victim = self._pick_victim()
                self._preempt(victim)
                if victim is req:
                    return []
        if self.chunk is not None and (end < len(seq)
                                       or start > req.prefix_len):
            self.stats["chunked_prefill_ticks"] += 1
        req.ingested = end
        if end < len(seq):
            # Mid-ingest slots are outside the decode mask, but a decode
            # step still WRITES at positions[slot] for every row (row ops
            # are row-independent, not row-skipping).  Keeping the
            # position at the ingest frontier makes that stray write
            # harmless: the slot layout overwrites the frontier with the
            # next chunk, and the paged layout's frontier page is not in
            # the block table yet, so the write routes to trash block 0.
            self.positions[req.slot] = end
            return []
        self.ingesting.remove(req)
        self.positions[req.slot] = len(seq)
        self.stats["prefill_requests"] += 1
        if req.tokens:
            # replay after preemption: `tok` re-derives the request's
            # last already-emitted token (deterministic greedy decode),
            # so it is not a new event.  A mismatch means the
            # determinism contract is broken (a bug, or a backend whose
            # reduction order varies with batch shape) — continuing
            # would silently stream tokens inconsistent with what the
            # client already received, so fail loudly instead (explicit
            # raise: an assert would vanish under `python -O`).
            if tok != req.tokens[-1]:
                raise RuntimeError(
                    f"request {req.id!r}: replay after preemption "
                    f"re-derived token {tok} where {req.tokens[-1]} was "
                    f"already streamed — determinism contract broken")
            self.last_tokens[req.slot] = req.tokens[-1]
            self.stats["replayed_tokens"] += len(req.tokens)
            if self._observe:
                self.obs.replayed(req, len(req.tokens))
            return []
        return [self._record(req, int(tok))]

    # -- one decode step over the slot mask -------------------------------
    def _decoding(self) -> List[Request]:
        return [r for r in self.slots
                if r is not None and r not in self.ingesting]

    def step(self) -> List[TokenEvent]:
        if not self._decoding():
            return []
        drafts = self._make_drafts()
        # back every write position with memory, preempting if needed;
        # a speculating row backs its whole kept window [pos, pos+|draft|]
        # (the +1 bonus token is emitted but not written this tick)
        for req in list(self._decoding()):
            if req.slot < 0 or self.slots[req.slot] is not req:
                continue                    # preempted by an earlier grow
            lo = int(self.positions[req.slot])
            for p in range(lo, lo + drafts.get(req, _EMPTY_DRAFT).size + 1):
                while (req.slot >= 0 and self.slots[req.slot] is req
                       and not self.backend.grow(req, p)):
                    self._preempt(self._pick_victim())
                if req.slot < 0 or self.slots[req.slot] is not req:
                    break
        active = np.zeros(self.num_slots, bool)
        for req in self._decoding():
            active[req.slot] = True
        if not active.any():
            return []
        drafts = {r: d for r, d in drafts.items()
                  if r.slot >= 0 and self.slots[r.slot] is r}
        if drafts:
            return self._verify_tick(drafts, active)
        t0 = self.obs.now() if self._observe else 0.0
        next_tok = self.backend.decode(self.last_tokens, self.positions,
                                       active)
        if self._observe:
            self.obs.decode_tick((self.obs.now() - t0) * 1e3,
                                 int(active.sum()))
        self.stats["decode_steps"] += 1
        events = []
        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            self.positions[slot] += 1
            events.append(self._record(req, int(next_tok[slot])))
        return events

    # -- speculative decoding ---------------------------------------------
    def _make_drafts(self) -> Dict[Request, np.ndarray]:
        """Draft continuation tokens for every speculating decode row.
        Empty dict = plain decode tick (nobody speculates, nobody pays)."""
        decoding = self._decoding()
        if not any(r.speculate_k > 0 for r in decoding):
            return {}
        # The verify window writes at EVERY occupied slot's frontier
        # (row ops are row-independent, not row-skipping), so the batch
        # window must stay inside every row's cache bounds — clamp the
        # draft budget to the most-advanced frontier.  Free slots sit at
        # position 0 and cannot bind tighter.
        frontier = max(int(self.positions[r.slot]) for r in self.slots
                       if r is not None)
        # the backend owns the clamp: cache geometry everywhere, plus the
        # state/hybrid layouts' spec_window (their verify materializes a
        # per-position state stack — the window is a memory budget)
        cap = self.backend.spec_window_cap(frontier)
        drafts: Dict[Request, np.ndarray] = {}
        for r in decoding:
            # remaining - 1: the window emits at most |draft| + 1 tokens,
            # which must not overshoot the request's max_new_tokens
            k = min(r.speculate_k,
                    r.max_new_tokens - len(r.tokens) - 1, cap)
            if k <= 0:
                continue
            ctx = np.concatenate([r.prompt,
                                  np.asarray(r.tokens, np.int32)])
            d = np.asarray(self.draft_fn(ctx, k), np.int32).reshape(-1)
            if d.size:
                drafts[r] = d[:k]
        return drafts

    def _verify_tick(self, drafts: Dict[Request, np.ndarray],
                     active: np.ndarray) -> List[TokenEvent]:
        """One speculative decode tick: score every row's window (last
        emitted token ++ draft, padded to the batch-wide width) in one
        forward pass, accept each row's longest drafted prefix matching
        the greedy argmax chain, emit ``accepted + 1`` tokens per row,
        and roll back the rejected tail (rewind ``positions``; paged
        backends also free now-empty tail blocks via ``truncate``)."""
        K = max(d.size for d in drafts.values())
        window = np.full((self.num_slots, K + 1), self.pad_id, np.int32)
        window[:, 0] = self.last_tokens
        for r, d in drafts.items():
            window[r.slot, 1:1 + d.size] = d
        t0 = self.obs.now() if self._observe else 0.0
        guess = self.backend.verify(window, self.positions, active)
        if self._observe:
            self.obs.verify_tick((self.obs.now() - t0) * 1e3,
                                 int(active.sum()))
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        events: List[TokenEvent] = []
        drafted = accepted = emitted = 0
        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            d = drafts.get(req, _EMPTY_DRAFT)
            g = guess[slot]
            a = 0
            while a < d.size and int(d[a]) == int(g[a]):
                a += 1
            drafted += int(d.size)
            accepted += a
            req.spec_drafted += int(d.size)
            req.spec_accepted += a
            if self._observe:
                self.obs.verified(req, a, int(d.size), len(req.tokens))
            pos0 = int(self.positions[slot])
            # g[i] is the greedy token after ...··t0·d[0..i-1]; emitting
            # g[0..a] therefore reproduces exactly what a+1 plain decode
            # steps would have emitted (g[i] == d[i] for i < a)
            for i in range(a + 1):
                events.append(self._record(req, int(g[i])))
                emitted += 1
                if req.finished:        # EOS / length: drop the rest
                    break
            if req.finished:
                continue                # _evict released slot + memory
            self.positions[slot] = pos0 + a + 1
            self.backend.truncate(req, pos0 + a + 1)
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        self.stats["spec_emitted"] += emitted
        if drafted:
            self._trace("spec.acceptance_pct",
                        int(round(100 * accepted / drafted)))
        self._trace("spec.tokens_per_tick", emitted)
        return events

    # -- preemption -------------------------------------------------------
    def _pick_victim(self) -> Request:
        """Lowest priority first, youngest arrival as tie-break: the
        oldest/most-important requests keep their blocks, which
        guarantees forward progress."""
        candidates = [r for r in self.slots if r is not None]
        return min(candidates, key=lambda r: (r.priority, -r.arrival))

    def _preempt(self, victim: Request) -> None:
        """Evict ``victim`` and requeue it: its blocks are freed, its
        cache is gone, and readmission recomputes ``victim.seq`` through
        the normal (chunked) ingest path — deterministic greedy decode
        makes the recomputation bit-identical, so its output stream just
        pauses and resumes."""
        self.preempt(victim)

    def preempt(self, victim: Request) -> None:
        """Public for tests/tools: force-preempt an in-flight request."""
        if victim.slot < 0 or self.slots[victim.slot] is not victim:
            raise ValueError(f"request {victim.id!r} holds no slot")
        slot = victim.slot
        self.backend.release(victim)
        self.slots[slot] = None
        self.free.append(slot)
        self.positions[slot] = 0
        self.last_tokens[slot] = self.pad_id
        victim.slot = -1
        victim.ingested = 0
        victim.preemptions += 1
        self.stats["preemptions"] += 1
        if self._observe:
            self.obs.preempted(victim)
        if victim in self.ingesting:
            self.ingesting.remove(victim)
        bisect.insort(self.waiting, victim, key=Request.sort_key)

    # -- bookkeeping ------------------------------------------------------
    def _record(self, req: Request, token: int) -> TokenEvent:
        req.tokens.append(token)
        self.last_tokens[req.slot] = token
        index = len(req.tokens) - 1
        if req.first_token_at is None:
            req.first_token_at = self.clock()
            ttft_ms = (req.first_token_at - req.submitted_at) * 1e3
            self._trace("serve.ttft_ms", int(ttft_ms))
            if self._observe:
                req.last_token_at = req.first_token_at
                self.obs.first_token(req, ttft_ms, index)
        elif self._observe:
            now = self.clock()
            prev = req.last_token_at if req.last_token_at is not None \
                else req.first_token_at
            self.obs.token(req, index, (now - prev) * 1e3)
            req.last_token_at = now
        if req.eos_id is not None and token == req.eos_id:
            req.finished, req.finish_reason = True, "eos"
            self.stats["evictions_eos"] += 1
        elif len(req.tokens) >= req.max_new_tokens:
            req.finished, req.finish_reason = True, "length"
            self.stats["evictions_length"] += 1
        if req.finished:
            self._evict(req)
            if self._observe:
                self.obs.finished(req, req.finish_reason)
        return TokenEvent(req, token, index, req.finished)

    def request_metrics(self, req: Request) -> Dict[str, Any]:
        """The final per-request metrics record (surfaced to streaming
        clients on the last TOKEN packet — docs/OBSERVABILITY.md)."""
        m: Dict[str, Any] = {
            "id": req.id, "finish_reason": req.finish_reason,
            "tokens": len(req.tokens),
            "prompt_tokens": int(req.prompt.size),
            "preemptions": req.preemptions,
            "spec_drafted": req.spec_drafted,
            "spec_accepted": req.spec_accepted,
            "ttft_ms": None, "queue_wait_ms": None,
        }
        if req.first_token_at is not None:
            m["ttft_ms"] = (req.first_token_at - req.submitted_at) * 1e3
        if req.admitted_at is not None:
            m["queue_wait_ms"] = \
                (req.admitted_at - req.submitted_at) * 1e3
        return m

    def debug_state(self) -> Dict[str, Any]:
        """Sanitized scheduler state for flight-recorder postmortems: no
        arrays, no backend handles — just the control-plane picture."""
        def info(r: Request) -> Dict[str, Any]:
            return {"id": str(r.id), "priority": r.priority,
                    "arrival": r.arrival, "slot": r.slot,
                    "prompt_len": int(r.prompt.size),
                    "ingested": r.ingested, "tokens": len(r.tokens),
                    "max_new_tokens": r.max_new_tokens,
                    "preemptions": r.preemptions,
                    "cancelled": r.cancelled, "finished": r.finished,
                    "finish_reason": r.finish_reason}
        return {
            "slots": [None if r is None else info(r) for r in self.slots],
            "waiting": [info(r) for r in self.waiting],
            "ingesting": [str(r.id) for r in self.ingesting],
            "free": sorted(self.free),
            "positions": [int(p) for p in self.positions],
            "stats": dict(self.stats),
            "mesh": self.engine.mesh_desc,
        }

    def _evict(self, req: Request) -> None:
        """Free the request's slot and backend resources.  Slot cache
        rows are left as-is: a later insert overwrites the whole row, and
        inactive rows cannot perturb active ones (row-independent
        decode)."""
        slot = req.slot
        self.backend.release(req)
        self.slots[slot] = None
        self.positions[slot] = 0
        self.last_tokens[slot] = self.pad_id
        self.free.append(slot)
        req.slot = -1
        self.stats["completed"] += 1
