"""AsyncFrontend — the asyncio front door on :class:`GraphServer`.

The paper's framework stops at the graph boundary: packets in, packets
out.  A production serving system additionally needs an *ingress* — the
layer that speaks the client's language (async streams, disconnects,
deadlines, retries) and translates it into graph traffic.  This module
is that layer:

* **per-token streaming** — :meth:`AsyncFrontend.stream` is an async
  generator yielding token ids as the engine emits them.  Events cross
  from the server's dispatcher thread into the event loop via
  ``loop.call_soon_threadsafe`` (no polling thread per request, no
  blocking reads abandoned on an executor).
* **disconnect → cancellation** — when the consumer of a stream goes
  away (``aclose()``, task cancellation, an HTTP client hanging up),
  the async generator's teardown fires :meth:`GraphServer.cancel`,
  which rides the graph's ``control`` stream past the flow limiter into
  the :class:`~repro_torch.serving.batching.Scheduler`: the slot is evicted,
  blocks freed, trie refs dropped, a mid-speculation verify window
  abandoned.  Nothing keeps generating for a client that left.
* **deadlines** — ``deadline_ms`` / ``ttft_ms`` pass through to the
  scheduler's SLO machinery (absolute-time payloads; see
  ``GraphServer.submit``).  An already-expired budget raises
  :class:`~repro_torch.serving.batching.DeadlineExceeded` before anything
  enters the graph.
* **retry/timeout policy** — :class:`Policy` bounds every await
  (``timeout_ms``) and retries failures that happen *before the first
  token* (``retries`` × ``retry_backoff_ms``).  Mid-stream failures are
  never retried: the client already consumed tokens, and a resubmission
  would replay them (the determinism contract makes the replay
  bit-identical, but the stream contract is each-token-once).

Quickstart::

    engine = LLMEngine(cfg, max_len=128)
    with GraphServer(engine, num_slots=4) as server:
        front = AsyncFrontend(server, policy=Policy(timeout_ms=30_000))

        async def client():
            async for tok in front.stream([1, 2, 3], max_new_tokens=8,
                                          ttft_ms=500):
                ...

Every await inside this module is bounded (the policy timeout, default
120 s), so a stuck stream fails with :class:`RequestTimeout` instead of
hanging a test past its ``pytest-timeout`` budget.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

import numpy as np

from .server import GraphServer, RequestHandle


class RequestTimeout(TimeoutError):
    """The frontend's policy timeout elapsed before the request
    finished.  The underlying request has already been cancelled (its
    cache memory is released) by the time this propagates."""


@dataclasses.dataclass(frozen=True)
class Policy:
    """Retry/timeout policy applied by the frontend to every request.

    ``timeout_ms`` is the whole-request wall-clock budget, enforced on
    the client side of the graph (every await is bounded by what
    remains of it).  It complements — not replaces — the scheduler-side
    ``deadline_ms``: the scheduler deadline frees server resources even
    if no client is waiting; the policy timeout frees the *client* even
    if the server stalls.

    ``retries`` resubmissions are attempted (after ``retry_backoff_ms``
    each) only when the request failed or timed out before yielding its
    first token — a half-consumed stream is never retried.
    """
    timeout_ms: float = 120_000.0
    retries: int = 0
    retry_backoff_ms: float = 0.0

    def __post_init__(self):
        if self.timeout_ms <= 0:
            raise ValueError(f"timeout_ms must be > 0, "
                             f"got {self.timeout_ms:g}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")


class AsyncFrontend:
    """Asyncio serving surface over a running :class:`GraphServer`.

    One frontend serves any number of concurrent ``stream``/``generate``
    calls; it holds no per-request threads and does not own the server
    (closing the frontend does not close the server).
    """

    def __init__(self, server: GraphServer, *,
                 policy: Optional[Policy] = None):
        self.server = server
        self.policy = policy if policy is not None else Policy()

    # -- internals ------------------------------------------------------
    def _attach(self, handle: RequestHandle,
                loop: asyncio.AbstractEventLoop) -> "asyncio.Queue":
        """Bridge the handle's dispatcher-thread events into an asyncio
        queue on ``loop``.  The listener replays anything that arrived
        before attachment, so no token is ever lost to the race between
        ``submit`` returning and the listener registering."""
        q: "asyncio.Queue" = asyncio.Queue()

        def on_event(token, finished, reason):
            try:
                loop.call_soon_threadsafe(q.put_nowait,
                                          (token, finished, reason))
            except RuntimeError:
                # the event loop is gone (client code already returned):
                # there is nobody left to deliver to — the request was
                # (or is being) cancelled on the way out
                pass

        handle.add_listener(on_event)
        return q

    # -- client API -----------------------------------------------------
    @staticmethod
    def _final_metrics(handle: RequestHandle, submit_t: float,
                       stamps: List[float]) -> Dict[str, Any]:
        """The per-request metrics record surfaced on completion:
        client-side TTFT / ITL percentiles from this coroutine's own
        arrival stamps, merged with the scheduler-side record that rode
        in on the final token packet (docs/OBSERVABILITY.md)."""
        sched = dict(handle.metrics) if handle.metrics else {}
        itls = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
        return {
            "id": handle.id,
            "finish_reason": handle.finish_reason,
            "tokens": sched.get("tokens", len(stamps)),
            "ttft_ms": (stamps[0] - submit_t) * 1e3 if stamps else None,
            "itl_ms": {"p50": itls[len(itls) // 2], "max": itls[-1]}
            if itls else None,
            "preemptions": sched.get("preemptions", 0),
            "spec_drafted": sched.get("spec_drafted", 0),
            "spec_accepted": sched.get("spec_accepted", 0),
            "scheduler": sched,       # ttft_ms/queue_wait_ms server-side
        }

    async def stream(self, tokens, *, request_id: Any = None,
                     on_handle: Optional[Callable[[RequestHandle],
                                                  None]] = None,
                     on_metrics: Optional[Callable[[Dict[str, Any]],
                                                   None]] = None,
                     **submit_kw) -> AsyncIterator[int]:
        """Async-stream generated token ids for one request.

        ``submit_kw`` passes through to :meth:`GraphServer.submit`
        (``max_new_tokens``, ``eos_id``, ``priority``, ``speculate_k``,
        ``deadline_ms``, ``ttft_ms``).  ``on_handle`` is called with
        each attempt's :class:`RequestHandle` as soon as it exists —
        the hook for callers who need the finish reason or out-of-band
        cancellation.  ``on_metrics`` is called once, when the request
        completes (any reason), with the final per-request metrics
        record: client-side TTFT and ITL p50/max measured by this
        coroutine, plus the scheduler-side record (queue wait,
        accepted/drafted, preemptions) from the final token packet.

        Abandoning the stream — ``aclose()``, breaking out of
        ``async for``, task cancellation — cancels the request
        server-side: its memory is released, its slot returns to the
        batch, and nothing keeps generating for a client that left.

        The stream ending without an exception does NOT by itself mean
        normal completion (a server-side cancel or missed deadline also
        just ends it, after the tokens streamed so far) — consult the
        handle's ``finish_reason`` when it matters.  Each retry attempt
        gets a fresh policy-timeout budget; retries happen only before
        the first token and never on client disconnect."""
        attempt = 0
        loop = asyncio.get_running_loop()
        while True:
            rid = request_id if (request_id is None or attempt == 0) \
                else f"{request_id}~retry{attempt}"
            handle = self.server.submit(tokens, request_id=rid,
                                        **submit_kw)
            if on_handle is not None:
                on_handle(handle)
            q = self._attach(handle, loop)
            submit_t = loop.time()
            deadline = submit_t + self.policy.timeout_ms / 1e3
            started = False
            stamps: List[float] = []
            try:
                while True:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        raise RequestTimeout(
                            f"request {handle.id!r} exceeded the policy "
                            f"timeout ({self.policy.timeout_ms:g} ms)")
                    try:
                        token, finished, reason = await asyncio.wait_for(
                            q.get(), timeout=remaining)
                    except asyncio.TimeoutError:
                        raise RequestTimeout(
                            f"request {handle.id!r} exceeded the policy "
                            f"timeout ({self.policy.timeout_ms:g} ms)"
                        ) from None
                    if reason == "error" and handle._error is not None:
                        raise RuntimeError(f"request {handle.id!r} "
                                           f"failed") from handle._error
                    if token is not None:
                        started = True
                        stamps.append(loop.time())
                        yield token
                    if finished:
                        if on_metrics is not None:
                            on_metrics(self._final_metrics(
                                handle, submit_t, stamps))
                        return
            except (asyncio.CancelledError, GeneratorExit):
                # client disconnect: stop the engine's work on this
                # request, then propagate — never retry on behalf of a
                # client that left
                if not handle.done():
                    handle.cancel()
                raise
            except (RequestTimeout, RuntimeError):
                if not handle.done():
                    handle.cancel()
                if started or attempt >= self.policy.retries:
                    raise
                attempt += 1
                if self.policy.retry_backoff_ms:
                    await asyncio.sleep(
                        self.policy.retry_backoff_ms / 1e3)

    async def generate(self, tokens, *, request_id: Any = None,
                       on_handle: Optional[Callable[[RequestHandle],
                                                    None]] = None,
                       on_metrics: Optional[Callable[[Dict[str, Any]],
                                                     None]] = None,
                       **submit_kw) -> np.ndarray:
        """Submit and await the full generation; returns [n] int32.
        Same policy semantics as :meth:`stream` (which it consumes)."""
        out = []
        async for tok in self.stream(tokens, request_id=request_id,
                                     on_handle=on_handle,
                                     on_metrics=on_metrics, **submit_kw):
            out.append(tok)
        return np.asarray(out, np.int32)

    def metrics(self) -> Dict[str, Any]:
        """Aggregate metrics snapshot from the underlying server's
        merged registries (see :meth:`GraphServer.metrics`)."""
        return self.server.metrics()

    @property
    def mesh_desc(self) -> Dict[str, Any]:
        """Serving-mesh shape of the underlying engine — the frontend
        adds nothing mesh-specific: sharding lives entirely below the
        GraphServer seam (docs/SHARDING.md), so async streaming,
        cancellation and SLO policies work unchanged on a mesh."""
        return self.server.engine.mesh_desc

    async def cancel(self, request_id: Any) -> bool:
        """Cancel a request by id (see :meth:`GraphServer.cancel`)."""
        return self.server.cancel(request_id)
