"""The port's serving front door on the CPU at reduced f32 sizes: its
``GraphServer`` and ``AsyncFrontend`` (``repro_torch.serving``) against
the JAX package's ``GraphServer`` on the same weights (one JAX engine for
the file, its weights carried over by ``params_from_jax``), and the
invariants of ``tests/test_frontend.py`` held inside the port.

* Per request, the port's tokens equal the JAX server's on the slot and
  paged layouts, whole and chunked prefill, with and without speculation,
  and equal the port's own ``generate`` bitwise; the fixed-batch graph
  (``build_serving_graph``) likewise.
* Cancelling at any lifecycle point frees every resource the request
  held and leaves every survivor bit-identical; deadlines and TTFT
  targets terminate requests without perturbing survivors; the asyncio
  frontend propagates disconnects and bounds every await.

Every port ``GraphServer`` closed here passes the leak check imported
from ``test_torch_graph.py`` (``tests/conftest.py`` wraps only the JAX
package's server).
"""
import asyncio
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.calculators  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import Graph as JaxGraph  # noqa: E402
from repro.serving import GraphServer as JaxServer  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import build_serving_graph as jax_serving_graph  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Graph, GraphError  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.serving import (AsyncFrontend, DeadlineExceeded,  # noqa: E402
                                 GraphServer, LLMEngine, PagedBackend,
                                 Policy, RequestTimeout, Scheduler,
                                 SlotBackend, build_serving_graph)
from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401


def small_cfgs():
    kw = dict(num_layers=2, d_model=128, vocab_size=512)
    return (dataclasses.replace(get_config("minicpm_2b").reduced(), **kw),
            dataclasses.replace(jax_get_config("minicpm_2b").reduced(),
                                **kw))


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(small_cfgs()[1], max_len=64, seed=7)


@pytest.fixture(scope="module")
def engine(jax_engine):
    """The port's engine on the JAX engine's weights."""
    cfg = small_cfgs()[0]
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.params),
                             cfg)
    return LLMEngine(cfg, params, max_len=64, device="cpu")


def make_prompts(rng, lengths):
    return [rng.randint(0, 512, size=L).astype(np.int32) for L in lengths]


def make_backend(engine, kind, num_slots, **kw):
    if kind == "paged":
        kw.setdefault("num_blocks", 65)
        kw.setdefault("block_size", 8)
        return PagedBackend(engine, num_slots, **kw)
    return SlotBackend(engine, num_slots)


def drain(sched, got=None, reasons=None):
    got = {} if got is None else got
    while sched.has_work():
        for ev in sched.admit() + sched.step():
            if ev.finished:
                got[ev.request.id] = np.asarray(ev.request.tokens,
                                                np.int32)
                if reasons is not None:
                    reasons[ev.request.id] = ev.request.finish_reason
    return got


def assert_baseline(sched):
    """The no-leak oracle: slots, blocks, reservations and trie refs all
    back where they started."""
    assert sorted(sched.free) == list(range(sched.num_slots))
    if sched.pool is not None:
        sched.pool.check_invariants()
        assert sched.pool.blocks_in_use == 0
        assert sched.pool.reserved_blocks == 0
    if sched.prefix is not None:
        assert len(sched.prefix) == 0


# ---------------------------------------------------------------------------
# against the JAX GraphServer on the same weights
# ---------------------------------------------------------------------------

SERVER_MODES = {
    "whole": {},
    "chunked_spec": {"chunk_size": 8, "speculate_k": 3},
}


@pytest.mark.parametrize("mode", list(SERVER_MODES))
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_graphserver_matches_jax_graphserver(jax_engine, engine, kind,
                                             mode):
    """The same requests through the JAX ``GraphServer`` and through the
    port's, the port's streamed by ``AsyncFrontend``: per request the
    same tokens, and the port's own ``generate``'s, bitwise."""
    prompts = make_prompts(np.random.RandomState(30), [5, 19, 7, 26, 11])
    kw = dict(num_slots=2, max_new_tokens=6, backend=kind,
              **SERVER_MODES[mode])
    if kind == "paged":
        kw.update(num_blocks=33, block_size=8)
    with JaxServer(jax_engine, **kw) as srv:
        want = [h.result(timeout=120)
                for h in [srv.submit(p) for p in prompts]]
    with GraphServer(engine, **kw) as srv:
        front = AsyncFrontend(srv, policy=Policy(timeout_ms=120_000))

        async def main():
            return await asyncio.gather(*[front.generate(p)
                                          for p in prompts])

        got = asyncio.run(main())
        stats = srv.stats()["scheduler"]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(
            got[i], engine.generate(p[None], max_new_tokens=6)[0],
            err_msg=f"request {i} against generate")
    assert stats["completed"] == len(prompts)
    if mode == "chunked_spec":
        assert stats["chunked_prefill_ticks"] > 0


def _run_fixed_batch(graph_cls, cfg, engine, prompts, max_new):
    g = graph_cls(cfg, side_packets={"engine": engine})
    out = {}
    g.observe_output_stream("responses", lambda p: out.__setitem__(
        p.payload["id"], np.asarray(p.payload["tokens"])))
    g.start_run()
    for t, p in enumerate(prompts):
        g.add_packet_to_input_stream(
            "requests", {"tokens": p, "id": t, "max_new_tokens": max_new},
            t)
    g.close_all_input_streams()
    g.wait_until_done(timeout=120)
    return out


def test_fixed_batch_graph_matches_jax(jax_engine, engine):
    """``build_serving_graph`` (batcher -> ``engine.generate`` ->
    unbatch) in both packages: two full batches and a short one flushed
    at close, every response equal to the JAX graph's and to the port's
    ``generate`` of its batch row."""
    prompts = make_prompts(np.random.RandomState(31), [6] * 10)
    want = _run_fixed_batch(JaxGraph, jax_serving_graph(batch_size=4),
                            jax_engine, prompts, 5)
    got = _run_fixed_batch(Graph, build_serving_graph(batch_size=4),
                           engine, prompts, 5)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(
            got[i], engine.generate(p[None], max_new_tokens=5)[0])


# ---------------------------------------------------------------------------
# the invariants of tests/test_frontend.py, inside the port
# ---------------------------------------------------------------------------

class TestCancellationPoints:
    """Cancel at every lifecycle point, on both backends; survivors
    bit-identical, arena back to baseline."""

    @pytest.mark.parametrize("kind", ["slot", "paged"])
    def test_cancel_while_queued(self, engine, kind):
        rng = np.random.RandomState(10)
        keep, victim = make_prompts(rng, [7, 9])
        ref = engine.generate(keep[None], max_new_tokens=6)[0]
        sched = Scheduler(make_backend(engine, kind, 1), max_new_tokens=6)
        sched.submit({"tokens": keep, "id": "keep"})
        sched.submit({"tokens": victim, "id": "victim"})
        sched.admit()                       # keep takes the only slot
        assert sched.waiting and sched.waiting[0].id == "victim"
        evs = sched.cancel("victim")
        assert [(e.request.id, e.token, e.finished) for e in evs] == \
            [("victim", None, True)]
        assert evs[0].request.finish_reason == "cancelled"
        got = drain(sched)
        np.testing.assert_array_equal(got["keep"], ref)
        assert sched.stats["requests_cancelled"] == 1
        assert sched.stats["completed"] == 2
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["slot", "paged"])
    def test_cancel_mid_chunked_prefill(self, engine, kind):
        rng = np.random.RandomState(11)
        victim, keep = make_prompts(rng, [30, 8])
        ref = engine.generate(keep[None], max_new_tokens=5)[0]
        sched = Scheduler(make_backend(engine, kind, 2), max_new_tokens=5,
                          chunk_size=8)
        sched.submit({"tokens": victim, "id": "victim"})
        sched.submit({"tokens": keep, "id": "keep"})
        sched.admit()                       # one chunk each
        vreq = next(r for r in sched.ingesting if r.id == "victim")
        assert 0 < vreq.ingested < victim.size
        sched.cancel("victim")
        assert vreq.finished and vreq.finish_reason == "cancelled"
        assert vreq not in sched.ingesting and vreq.slot == -1
        got = drain(sched)
        np.testing.assert_array_equal(got["keep"], ref)
        assert sched.stats["requests_cancelled"] == 1
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["slot", "paged"])
    def test_cancel_mid_decode_keeps_streamed_prefix(self, engine, kind):
        rng = np.random.RandomState(12)
        victim, keep = make_prompts(rng, [6, 11])
        ref_v = engine.generate(victim[None], max_new_tokens=8)[0]
        ref_k = engine.generate(keep[None], max_new_tokens=8)[0]
        sched = Scheduler(make_backend(engine, kind, 2), max_new_tokens=8)
        vreq = sched.submit({"tokens": victim, "id": "victim"})
        sched.submit({"tokens": keep, "id": "keep"})
        sched.admit()
        sched.step()
        sched.step()                        # victim mid-decode, 3 tokens
        assert vreq.slot >= 0 and not vreq.finished
        n_streamed = len(vreq.tokens)
        evs = sched.cancel(vreq)
        got = {e.request.id: np.asarray(e.request.tokens, np.int32)
               for e in evs if e.finished}
        drain(sched, got)
        np.testing.assert_array_equal(got["victim"], ref_v[:n_streamed])
        np.testing.assert_array_equal(got["keep"], ref_k)
        assert sched.stats["requests_cancelled"] == 1
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["slot", "paged"])
    def test_cancel_mid_verify_window(self, engine, kind):
        """Cancel between speculative verify ticks: the abandoned window
        must not perturb the surviving speculating request."""
        rng = np.random.RandomState(13)
        victim, keep = make_prompts(rng, [16, 15])
        ref_k = engine.generate(keep[None], max_new_tokens=10)[0]
        sched = Scheduler(make_backend(engine, kind, 2),
                          max_new_tokens=10, speculate_k=4,
                          draft_fn=lambda ctx, k: (ctx[-k:] + 1) % 512)
        vreq = sched.submit({"tokens": victim, "id": "victim"})
        sched.submit({"tokens": keep, "id": "keep"})
        sched.admit()
        sched.step()                        # one verify tick done
        assert sched.stats["spec_steps"] >= 1
        assert not vreq.finished            # a mid-verify cancel point
        sched.cancel("victim")
        got = drain(sched)
        np.testing.assert_array_equal(got["keep"], ref_k)
        assert sched.stats["requests_cancelled"] == 1
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["slot", "paged"])
    def test_cancel_post_eos_race(self, engine, kind):
        """A cancel that loses the race against normal completion is a
        no-op: no double completion, no stat pollution."""
        rng = np.random.RandomState(14)
        p = make_prompts(rng, [9])[0]
        ref = engine.generate(p[None], max_new_tokens=4)[0]
        sched = Scheduler(make_backend(engine, kind, 2), max_new_tokens=4)
        sched.submit({"tokens": p, "id": "r"})
        got = drain(sched)
        np.testing.assert_array_equal(got["r"], ref)
        completed = sched.stats["completed"]
        assert sched.cancel("r") == []
        assert sched.stats["requests_cancelled"] == 0
        assert sched.stats["completed"] == completed
        assert_baseline(sched)

    def test_cancel_overtaking_its_request(self, engine):
        """A cancel that arrives before its own request still lands: the
        request dies at admission."""
        sched = Scheduler(make_backend(engine, "paged", 2),
                          max_new_tokens=4)
        assert sched.cancel("early") == []
        req = sched.submit({"tokens": [1, 2, 3], "id": "early"})
        assert req.cancelled
        evs = sched.admit()
        assert req.finished and req.finish_reason == "cancelled"
        assert any(e.request.id == "early" and e.finished for e in evs)
        assert sched.stats["requests_cancelled"] == 1
        assert_baseline(sched)

    def test_cancel_backlog_is_bounded(self, engine):
        from repro_torch.serving.batching import _CANCEL_BACKLOG
        sched = Scheduler(make_backend(engine, "slot", 2))
        for i in range(_CANCEL_BACKLOG + 100):
            sched.cancel(f"ghost-{i}")
        assert len(sched._cancelled_ids) == _CANCEL_BACKLOG
        assert "ghost-0" not in sched._cancelled_ids
        assert f"ghost-{_CANCEL_BACKLOG + 99}" in sched._cancelled_ids

    def test_preempted_then_cancelled_not_double_counted(self, engine):
        rng = np.random.RandomState(15)
        victim, keep = make_prompts(rng, [8, 8])
        ref = engine.generate(keep[None], max_new_tokens=6)[0]
        sched = Scheduler(make_backend(engine, "paged", 2),
                          max_new_tokens=6)
        vreq = sched.submit({"tokens": victim, "id": "victim"})
        sched.submit({"tokens": keep, "id": "keep"})
        sched.admit()
        sched.step()
        sched.preempt(vreq)
        assert sched.stats["preemptions"] == 1 and vreq.slot == -1
        sched.cancel("victim")
        got = drain(sched)
        np.testing.assert_array_equal(got["keep"], ref)
        assert sched.stats["preemptions"] == 1
        assert sched.stats["requests_cancelled"] == 1
        assert sched.stats["completed"] == 2
        assert_baseline(sched)


class TestDeadlines:
    """SLO scheduling on an injected fake clock."""

    def _sched(self, engine, num_slots=1, **kw):
        t = [0.0]
        sched = Scheduler(make_backend(engine, "paged", num_slots),
                          max_new_tokens=6, clock=lambda: t[0], **kw)
        return sched, t

    def test_expired_relative_deadline_rejected_typed(self, engine):
        sched, _ = self._sched(engine)
        for field in ("deadline_ms", "ttft_ms"):
            with pytest.raises(DeadlineExceeded):
                sched.submit({"tokens": [1, 2], "id": "x", field: 0})
            with pytest.raises(DeadlineExceeded):
                sched.submit({"tokens": [1, 2], "id": "x", field: -3.5})
        assert sched.stats["submitted"] == 0
        assert issubclass(DeadlineExceeded, ValueError)

    def test_tight_ttft_preempts_lower_priority_decoder(self, engine):
        rng = np.random.RandomState(16)
        lo_p, hi_p = make_prompts(rng, [6, 7])
        sched, _ = self._sched(engine, num_slots=1)
        lo = sched.submit({"tokens": lo_p, "id": "lo", "priority": 0})
        sched.admit()
        sched.step()                        # lo is mid-decode
        hi = sched.submit({"tokens": hi_p, "id": "hi", "priority": 2,
                           "ttft_ms": 10_000})
        sched.admit()
        assert hi.slot >= 0
        assert lo.slot == -1 and lo.preemptions == 1
        assert sched.stats["preemptions"] == 1
        got, reasons = {}, {}
        drain(sched, got, reasons)
        np.testing.assert_array_equal(
            got["lo"], engine.generate(lo_p[None], max_new_tokens=6)[0])
        np.testing.assert_array_equal(
            got["hi"], engine.generate(hi_p[None], max_new_tokens=6)[0])
        assert reasons == {"lo": "length", "hi": "length"}
        assert_baseline(sched)

    def test_ttft_without_higher_priority_does_not_preempt(self, engine):
        rng = np.random.RandomState(17)
        a_p, b_p = make_prompts(rng, [6, 7])
        sched, _ = self._sched(engine, num_slots=1)
        a = sched.submit({"tokens": a_p, "id": "a", "priority": 1})
        sched.admit()
        sched.step()
        b = sched.submit({"tokens": b_p, "id": "b", "priority": 1,
                          "ttft_ms": 10_000})
        sched.admit()
        assert a.slot >= 0 and b.slot == -1
        assert sched.stats["preemptions"] == 0
        drain(sched)
        assert_baseline(sched)

    def test_waiting_request_deadline_expires(self, engine):
        rng = np.random.RandomState(18)
        busy_p, late_p = make_prompts(rng, [6, 7])
        sched, t = self._sched(engine, num_slots=1)
        sched.submit({"tokens": busy_p, "id": "busy"})
        sched.admit()
        late = sched.submit({"tokens": late_p, "id": "late",
                             "deadline_ms": 50})
        t[0] = 0.2
        evs = sched.admit()
        assert late.finished and late.finish_reason == "deadline"
        assert any(e.request.id == "late" and e.token is None
                   for e in evs)
        assert sched.stats["deadline_missed"] == 1
        drain(sched)
        assert_baseline(sched)

    def test_active_deadline_expires_mid_decode(self, engine):
        rng = np.random.RandomState(19)
        p = make_prompts(rng, [6])[0]
        ref = engine.generate(p[None], max_new_tokens=6)[0]
        sched, t = self._sched(engine, num_slots=1)
        req = sched.submit({"tokens": p, "id": "r", "deadline_ms": 100})
        sched.admit()
        sched.step()
        streamed = len(req.tokens)
        assert 0 < streamed < 6
        t[0] = 0.5
        sched.admit()                       # sweep kills it
        assert req.finished and req.finish_reason == "deadline"
        np.testing.assert_array_equal(np.asarray(req.tokens, np.int32),
                                      ref[:streamed])
        assert sched.stats["deadline_missed"] == 1
        assert_baseline(sched)

    def test_ttft_target_met_is_forgotten(self, engine):
        rng = np.random.RandomState(20)
        p = make_prompts(rng, [6])[0]
        sched, t = self._sched(engine, num_slots=1)
        req = sched.submit({"tokens": p, "id": "r", "ttft_ms": 100})
        sched.admit()
        assert req.first_token_at is not None
        t[0] = 10.0
        got, reasons = {}, {}
        drain(sched, got, reasons)
        assert reasons["r"] == "length"
        assert len(got["r"]) == 6
        assert sched.stats["deadline_missed"] == 0
        assert_baseline(sched)


class TestGraphFrontDoor:
    """Cancellation and deadlines through the port's whole graph."""

    def test_cancel_mid_stream_survivor_bit_identical(self, engine):
        rng = np.random.RandomState(21)
        v_p, k_p = make_prompts(rng, [8, 12])
        ref_k = engine.generate(k_p[None], max_new_tokens=10)[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=10,
                         paged=True, num_blocks=33, block_size=8) as srv:
            hv = srv.submit(v_p, max_new_tokens=48, request_id="victim")
            hk = srv.submit(k_p, request_id="keep")
            it = hv.stream(timeout=60.0)
            got_before = [next(it), next(it)]
            assert hv.cancel()
            leftover = list(it)
            np.testing.assert_array_equal(hk.result(timeout=120), ref_k)
            assert hv.result(timeout=120).tolist() == \
                got_before + leftover
            assert hv.finish_reason == "cancelled"
            stats = srv.stats()["scheduler"]
            assert stats["requests_cancelled"] == 1
            assert stats["preemptions"] == 0

    def test_cancel_unknown_id_is_noop(self, engine):
        rng = np.random.RandomState(22)
        p = make_prompts(rng, [7])[0]
        ref = engine.generate(p[None], max_new_tokens=5)[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=5) as srv:
            assert srv.cancel("never-submitted") is False
            np.testing.assert_array_equal(srv.generate(p), ref)

    def test_expired_deadline_rejected_client_side(self, engine):
        with GraphServer(engine, num_slots=2) as srv:
            with pytest.raises(DeadlineExceeded):
                srv.submit([1, 2, 3], deadline_ms=0)
            with pytest.raises(DeadlineExceeded):
                srv.submit([1, 2, 3], ttft_ms=-1)
        assert srv.close()["scheduler"]["submitted"] == 0

    def test_deadline_missed_inside_graph(self, engine):
        rng = np.random.RandomState(23)
        doomed_p, keep_p = make_prompts(rng, [8, 9])
        ref = engine.generate(keep_p[None], max_new_tokens=6)[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=6) as srv:
            doomed = srv.submit(doomed_p, ttft_ms=1e-6,
                                request_id="doomed")
            keep = srv.submit(keep_p, request_id="keep")
            assert doomed.result(timeout=120).size == 0
            assert doomed.finish_reason == "deadline"
            np.testing.assert_array_equal(keep.result(timeout=120), ref)
            assert srv.stats()["scheduler"]["deadline_missed"] == 1

    def test_unported_layouts_raise_to_the_caller(self, engine):
        """The state and hybrid layouts are served since ROADMAP Queue 1
        item 7.  What the engine still refuses while the server is being
        constructed reaches the caller: a hybrid arena whose block size
        does not divide the engine's ``max_len``, and an unknown
        layout."""
        with pytest.raises(GraphError, match="multiple of block_size"):
            GraphServer(engine, num_slots=2, backend="hybrid",
                        num_blocks=17, block_size=24)
        with pytest.raises(GraphError, match="unknown backend kind"):
            GraphServer(engine, num_slots=2, backend="ring")

    def test_sliding_window_names_its_own_item(self):
        """Sliding-window attention came with its own ROADMAP item (12):
        the engine serves it, and the server refuses what JAX refuses of
        it (the paged arena, speculation) while it is being constructed,
        in the caller's thread."""
        cfg = dataclasses.replace(small_cfgs()[0], sliding_window=16)
        engine = LLMEngine(cfg, max_len=16, device="cpu")
        with pytest.raises(GraphError, match="sliding-window attention "
                                             "is not supported"):
            GraphServer(engine, num_slots=2, backend="paged",
                        num_blocks=9, block_size=8)
        with pytest.raises(ValueError, match="sliding-window"):
            GraphServer(engine, num_slots=2, speculate_k=2)


class TestAsyncFrontend:
    """The asyncio surface; every await is policy-bounded."""

    def test_stream_matches_reference(self, engine):
        rng = np.random.RandomState(24)
        prompts = make_prompts(rng, [6, 9, 6, 11])
        refs = [engine.generate(p[None], max_new_tokens=6)[0]
                for p in prompts]
        with GraphServer(engine, num_slots=2, max_new_tokens=6) as srv:
            front = AsyncFrontend(srv, policy=Policy(timeout_ms=120_000))

            async def main():
                return await asyncio.gather(
                    *[front.generate(p) for p in prompts])

            outs = asyncio.run(main())
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)

    def test_disconnect_cancels_server_side(self, engine):
        rng = np.random.RandomState(25)
        v_p, k_p = make_prompts(rng, [8, 10])
        ref_k = engine.generate(k_p[None], max_new_tokens=10)[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=10,
                         paged=True, num_blocks=33, block_size=8) as srv:
            front = AsyncFrontend(srv)

            async def main():
                handles = []
                got = []
                agen = front.stream(v_p, max_new_tokens=48,
                                    on_handle=handles.append)
                async for tok in agen:
                    got.append(tok)
                    if len(got) == 2:
                        break               # client hangs up
                await agen.aclose()
                keep = await front.generate(k_p)
                return handles[0], got, keep

            handle, got, keep = asyncio.run(main())
            assert handle.result(timeout=120) is not None
            assert handle.finish_reason == "cancelled"
            assert handle.result().tolist()[:2] == got
            np.testing.assert_array_equal(keep, ref_k)
            assert srv.stats()["scheduler"]["requests_cancelled"] == 1

    def test_policy_timeout_raises_and_cancels(self, engine):
        rng = np.random.RandomState(26)
        p = make_prompts(rng, [8])[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=16) as srv:
            front = AsyncFrontend(srv, policy=Policy(timeout_ms=0.05))

            async def main():
                handles = []
                with pytest.raises(RequestTimeout):
                    await front.generate(p, on_handle=handles.append)
                return handles

            handles = asyncio.run(main())
            assert len(handles) == 1
            handles[0].result(timeout=120)
            assert handles[0].finish_reason == "cancelled"

    def test_policy_retries_before_first_token(self, engine):
        rng = np.random.RandomState(27)
        p = make_prompts(rng, [8])[0]
        with GraphServer(engine, num_slots=2, max_new_tokens=16) as srv:
            front = AsyncFrontend(
                srv, policy=Policy(timeout_ms=0.05, retries=2))

            async def main():
                handles = []
                with pytest.raises(RequestTimeout):
                    await front.generate(p, request_id="flaky",
                                         on_handle=handles.append)
                return handles

            handles = asyncio.run(main())
            assert [h.id for h in handles] == \
                ["flaky", "flaky~retry1", "flaky~retry2"]
            for h in handles:
                h.result(timeout=120)
                assert h.finish_reason == "cancelled"

    def test_expired_deadline_raises_before_submission(self, engine):
        with GraphServer(engine, num_slots=2) as srv:
            front = AsyncFrontend(srv)

            async def main():
                with pytest.raises(DeadlineExceeded):
                    await front.generate([1, 2, 3], ttft_ms=0)

            asyncio.run(main())
            assert srv.stats()["scheduler"]["submitted"] == 0

    def test_failed_run_fails_streams_at_once(self, engine, monkeypatch):
        """A run that fails mid-decode (the engine raises on its third
        decode tick) fails every pending handle and every
        ``AsyncFrontend`` stream with the run's error within seconds,
        not on the policy's timeout (ROADMAP Hazard 6, repaired in the
        port's ``GraphServer._pump``)."""
        real, ticks = engine.decode, []

        def decode(*args, **kw):
            ticks.append(1)
            if len(ticks) == 3:
                raise RuntimeError("engine failed mid-run")
            return real(*args, **kw)

        monkeypatch.setattr(engine, "decode", decode)
        prompts = make_prompts(np.random.RandomState(28), [6, 9, 7])
        srv = GraphServer(engine, num_slots=2, max_new_tokens=8)
        front = AsyncFrontend(srv, policy=Policy(timeout_ms=300_000))
        handles = []

        async def one(p):
            return [t async for t in front.stream(
                p, on_handle=handles.append)]

        async def main():
            return await asyncio.gather(*[one(p) for p in prompts],
                                        return_exceptions=True)

        t0 = time.monotonic()
        outs = asyncio.run(main())
        waited = time.monotonic() - t0
        try:
            assert waited < 30, f"streams ended after {waited:.1f} s"
            assert len(handles) == len(prompts)
            for out in outs:
                assert isinstance(out, RuntimeError), out
                assert "engine failed mid-run" in repr(out.__cause__)
            for h in handles:
                with pytest.raises(RuntimeError) as err:
                    h.result(timeout=1)
                assert "engine failed mid-run" in repr(err.value.__cause__)
        finally:
            with pytest.raises(GraphError, match="engine failed mid-run"):
                srv.close()

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError):
            Policy(timeout_ms=0)
        with pytest.raises(ValueError):
            Policy(retries=-1)


class TestDeterministicFuzz:
    """Seeded cancellation x preemption x speculation sweep.  Oracles:
    pool invariants after every tick, arena baseline at the end,
    survivors bit-identical, cancelled/expired requests' streamed tokens
    exact prefixes of their references."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_cancel_preempt_spec_interleavings(self, engine, seed):
        rng = np.random.RandomState(100 + seed)
        n_req = 8
        max_new = 5
        prompts = make_prompts(rng, rng.randint(4, 24, size=n_req))
        refs = [engine.generate(p[None], max_new_tokens=max_new)[0]
                for p in prompts]
        t = [0.0]
        sched = Scheduler(
            make_backend(engine, "paged", 3, num_blocks=22, block_size=8),
            max_new_tokens=max_new, chunk_size=8,
            speculate_k=int(rng.randint(0, 4)), clock=lambda: t[0])
        pending = list(range(n_req))
        got, reasons = {}, {}

        def flush(evs):
            for ev in evs:
                if ev.finished:
                    got[ev.request.id] = np.asarray(ev.request.tokens,
                                                    np.int32)
                    reasons[ev.request.id] = ev.request.finish_reason

        for _ in range(400):
            if not (sched.has_work() or pending):
                break
            op = rng.randint(0, 10)
            if op <= 3 and pending:
                i = pending.pop(0)
                payload = {"tokens": prompts[i], "id": i,
                           "priority": int(rng.randint(0, 3))}
                if rng.rand() < 0.3:
                    payload["deadline_ms"] = float(rng.randint(1, 400))
                sched.submit(payload)
            elif op == 4:
                live = [r.id for r in sched.slots if r is not None] + \
                       [r.id for r in sched.waiting]
                target = (live[rng.randint(len(live))] if live
                          and rng.rand() < 0.8 else f"bogus-{op}")
                flush(sched.cancel(target))
            elif op == 5:
                holders = [r for r in sched.slots if r is not None]
                if holders:
                    sched.preempt(holders[rng.randint(len(holders))])
            elif op == 6 and rng.rand() < 0.5:
                t[0] += float(rng.rand()) * 0.2
            else:
                flush(sched.admit())
                flush(sched.step())
            sched.pool.check_invariants()
        for i in pending:
            sched.submit({"tokens": prompts[i], "id": i})
        flush(drain(sched))

        assert len(got) == n_req
        for i in range(n_req):
            if reasons[i] == "length":
                np.testing.assert_array_equal(got[i], refs[i])
            else:
                assert reasons[i] in ("cancelled", "deadline")
                np.testing.assert_array_equal(
                    got[i], refs[i][:len(got[i])])
        assert sched.stats["completed"] == n_req
        assert_baseline(sched)
