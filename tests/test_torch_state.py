"""StateBackend and HybridBackend inside the port, on the CPU at f32:
every case of ``tests/test_state_backend.py`` on its two configurations
(reduced xLSTM with one mLSTM and one sLSTM layer on ``StateBackend``;
reduced Jamba — attention + dense FFN, Mamba + MoE FFN — on
``HybridBackend``), served through the port's unchanged ``Scheduler``
and ``GraphServer`` bitwise equal to the port's sequential ``generate``
under chunked prefill, preemption replay, and adversarial and oracle
drafts; and the port against the JAX engine and Scheduler on the same
weights (``params_from_jax``): the same greedy tokens, and the same
Scheduler tokens on both backends.

A replay of a preempted request runs its streamed tokens through the
masked decode step, or through the verify window and the rewind of its
row (``CacheBackend._replay``), so these runs also cover the port's
route for ROADMAP Hazard 5 on the state layouts.  Every port
``GraphServer`` passes the leak check of ``test_torch_graph.py``, which
also counts held state slabs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro_torch.calculators  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serving import HybridBackend as JaxHybrid  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving import StateBackend as JaxState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import GraphError  # noqa: E402
from repro_torch.models.params import flatten, params_from_jax  # noqa: E402
from repro_torch.runtime.graphs import (CapturedStep, StepGraphs,  # noqa: E402
                                        addresses)
from repro_torch.serving import (GraphServer, HybridBackend,  # noqa: E402
                                 LLMEngine, PagedBackend, Scheduler,
                                 StateBackend, make_backend)
from test_state_backend import (MAX_LEN, VOCAB, Oracle,  # noqa: E402
                                assert_baseline, chaotic_draft_fn, drain,
                                make_prompts)
from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401


def _cfgs(name, **kw):
    return (dataclasses.replace(get_config(name).reduced(), **kw),
            dataclasses.replace(jax_get_config(name).reduced(), **kw))


def recurrent_cfgs():
    # the stock reduced pattern is all-mLSTM at 2 layers; force one of
    # each so the sLSTM state path is covered too
    return _cfgs("xlstm_1_3b", num_layers=2, d_model=64, vocab_size=VOCAB,
                 block_pattern=("mlstm", "slstm"))


def mixed_cfgs():
    return _cfgs("jamba_1_5_large_398b", d_model=64, vocab_size=VOCAB)


class EnginePair:
    """The JAX engine of ``test_state_backend.py`` (its seed) and the
    port's engine on the same weights."""

    def __init__(self, cfgs, seed):
        self.cfg, self.jcfg = cfgs
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=seed)
        self.port = LLMEngine(
            self.cfg, params_from_jax(jax.tree.map(np.asarray,
                                                   self.jax.params),
                                      self.cfg),
            max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {"state": EnginePair(recurrent_cfgs(), 7),
            "hybrid": EnginePair(mixed_cfgs(), 3)}


@pytest.fixture(scope="module")
def engines(pairs):
    return {k: p.port for k, p in pairs.items()}


@pytest.fixture(scope="module")
def xlstm_engine(engines):
    return engines["state"]


def build_backend(engines, kind, num_slots, **kw):
    if kind == "hybrid":
        kw.setdefault("num_blocks", 33)
        kw.setdefault("block_size", 8)
        return HybridBackend(engines["hybrid"], num_slots, **kw)
    return StateBackend(engines["state"], num_slots, **kw)


class TestBitIdentity:
    """Chunked prefill x preemption replay x speculative verify on state
    slabs == sequential greedy decode."""

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_plain_decode_matches_sequential(self, engines, kind):
        rng = np.random.RandomState(0)
        prompts = make_prompts(rng, [5, 9, 5, 13, 7])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=6)[0]
                for p in prompts]
        sched = Scheduler(build_backend(engines, kind, 3),
                          max_new_tokens=6)
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        got = drain(sched)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_chunked_prefill_checkpoints_state(self, engines, kind):
        rng = np.random.RandomState(1)
        long_p, short_p = make_prompts(rng, [37, 6])
        eng = engines[kind]
        ref_long = eng.generate(long_p[None], max_new_tokens=5)[0]
        ref_short = eng.generate(short_p[None], max_new_tokens=5)[0]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=5, chunk_size=8)
        sched.submit({"tokens": long_p, "id": "long"})
        sched.submit({"tokens": short_p, "id": "short"})
        got = drain(sched)
        np.testing.assert_array_equal(got["long"], ref_long)
        np.testing.assert_array_equal(got["short"], ref_short)
        assert sched.stats["chunked_prefill_ticks"] >= 4
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_preemption_replays_state_exactly(self, engines, kind):
        rng = np.random.RandomState(2)
        prompts = make_prompts(rng, [5, 9])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=6)[0]
                for p in prompts]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=6)
        r0 = sched.submit({"tokens": prompts[0], "id": 0})
        sched.submit({"tokens": prompts[1], "id": 1})
        sched.admit()
        sched.step()
        sched.step()
        held_before = sched.backend.slabs_in_use
        sched.preempt(r0)
        assert sched.backend.slabs_in_use == held_before - 1
        got = drain(sched, {})
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert r0.preemptions == 1
        assert sched.stats["replay_steps"] > 0
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_random_schedule_sweep_bit_identical(self, engines, kind):
        rng = np.random.RandomState(15)
        eng = engines[kind]
        for trial in range(4):
            lengths = rng.randint(3, 30, size=rng.randint(3, 6))
            prompts = make_prompts(rng, lengths)
            max_new = int(rng.randint(2, 8))
            refs = [eng.generate(p[None], max_new_tokens=max_new)[0]
                    for p in prompts]
            chunk = (None, 8)[trial % 2]
            spec = (0, 3)[(trial // 2) % 2]
            sched = Scheduler(
                build_backend(engines, kind, int(rng.randint(2, 4))),
                max_new_tokens=max_new, chunk_size=chunk,
                speculate_k=spec)
            got = {}
            pending = list(enumerate(prompts))
            while sched.has_work() or pending:
                if pending and rng.rand() < 0.6:
                    i, p = pending.pop(0)
                    sched.submit({"tokens": p, "id": i,
                                  "priority": int(rng.randint(0, 3))})
                for ev in sched.admit() + sched.step():
                    if ev.finished:
                        got[ev.request.id] = np.asarray(
                            ev.request.tokens, np.int32)
                holders = [r for r in sched.slots if r is not None]
                if holders and rng.rand() < 0.15:
                    sched.preempt(holders[rng.randint(len(holders))])
                if sched.pool is not None:
                    sched.pool.check_invariants()
            for i, ref in enumerate(refs):
                np.testing.assert_array_equal(got[i], ref)
            assert_baseline(sched)


class TestSpeculativeRewind:
    """Snapshot-at-verify + rewind-on-truncate."""

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_adversarial_drafts_stay_exact(self, engines, kind):
        rng = np.random.RandomState(4)
        prompts = make_prompts(rng, [5, 9, 13])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=8)[0]
                for p in prompts]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=8, chunk_size=8, speculate_k=4,
                          draft_fn=chaotic_draft_fn(42))
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        got = drain(sched)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert sched.stats["spec_drafted"] > 0
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_oracle_drafts_accept_fully(self, engines, kind):
        rng = np.random.RandomState(5)
        prompts = make_prompts(rng, [5, 9, 13])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=8)[0]
                for p in prompts]
        sched = Scheduler(build_backend(engines, kind, 3),
                          max_new_tokens=8, speculate_k=4,
                          draft_fn=Oracle(prompts, refs))
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        got = drain(sched)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert sched.stats["spec_drafted"] > 0
        assert sched.stats["spec_accepted"] == sched.stats["spec_drafted"]
        assert_baseline(sched)

    def test_spec_window_caps_draft_length(self, engines):
        be = StateBackend(engines["state"], 2, spec_window=2)
        assert be.spec_window_cap(10) == 2
        assert be.spec_window_cap(MAX_LEN - 2) == 1
        assert be.spec_window_cap(MAX_LEN - 1) == 0

        rng = np.random.RandomState(6)
        prompts = make_prompts(rng, [5, 9])
        eng = engines["state"]
        refs = [eng.generate(p[None], max_new_tokens=8)[0]
                for p in prompts]
        sched = Scheduler(be, max_new_tokens=8, speculate_k=6,
                          draft_fn=Oracle(prompts, refs))
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        got = drain(sched)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert sched.stats["spec_drafted"] <= \
            2 * len(prompts) * sched.stats["spec_steps"]
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_preempted_speculating_request_replays_through_verify(
            self, engines, kind):
        """A request preempted while it speculates replays its streamed
        tokens through verify windows with the rewind of its row: the
        others' slabs are untouched, and every token is generate's."""
        rng = np.random.RandomState(11)
        prompts = make_prompts(rng, [6, 10])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=12)[0]
                for p in prompts]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=12, speculate_k=3,
                          draft_fn=chaotic_draft_fn(3))
        r0 = sched.submit({"tokens": prompts[0], "id": 0})
        sched.submit({"tokens": prompts[1], "id": 1})
        sched.admit()
        for _ in range(3):
            sched.step()
        assert len(r0.tokens) >= 3
        sched.preempt(r0)
        got = drain(sched, {})
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert sched.stats["replay_steps"] > 0
        assert_baseline(sched)


class TestLifecycle:
    """Cancellation, deadline expiry and leak-to-baseline hold on the
    new backends."""

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_cancel_mid_flight_frees_slab(self, engines, kind):
        rng = np.random.RandomState(7)
        prompts = make_prompts(rng, [6, 8])
        eng = engines[kind]
        ref1 = eng.generate(prompts[1][None], max_new_tokens=8)[0]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=8, chunk_size=8, speculate_k=3,
                          draft_fn=chaotic_draft_fn(9))
        r0 = sched.submit({"tokens": prompts[0], "id": 0})
        sched.submit({"tokens": prompts[1], "id": 1})
        sched.admit()
        sched.step()
        evs = sched.cancel(r0.id)
        assert any(ev.finished and ev.request.id == 0 for ev in evs)
        assert r0.finish_reason == "cancelled"
        got = drain(sched)
        np.testing.assert_array_equal(got[1], ref1)
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_deadline_expiry_frees_slab(self, engines, kind):
        rng = np.random.RandomState(8)
        prompts = make_prompts(rng, [6, 8])
        eng = engines[kind]
        ref1 = eng.generate(prompts[1][None], max_new_tokens=8)[0]
        t = [0.0]
        sched = Scheduler(build_backend(engines, kind, 2),
                          max_new_tokens=8, clock=lambda: t[0])
        r0 = sched.submit({"tokens": prompts[0], "id": 0,
                           "deadline_ms": 100.0})
        sched.submit({"tokens": prompts[1], "id": 1})
        sched.admit()
        sched.step()
        t[0] += 1.0
        got = drain(sched)
        assert r0.finish_reason == "deadline"
        np.testing.assert_array_equal(got[1], ref1)
        assert_baseline(sched)

    def test_hybrid_pressure_frees_blocks_and_slabs(self, engines):
        rng = np.random.RandomState(9)
        prompts = make_prompts(rng, [6] * 6)
        eng = engines["hybrid"]
        refs = [eng.generate(p[None], max_new_tokens=12)[0]
                for p in prompts]
        sched = Scheduler(
            build_backend(engines, "hybrid", 6, num_blocks=9,
                          block_size=4),
            max_new_tokens=12)
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        got = {}
        while sched.has_work():
            for ev in sched.admit() + sched.step():
                if ev.finished:
                    got[ev.request.id] = np.asarray(ev.request.tokens,
                                                    np.int32)
            sched.pool.check_invariants()
            assert sched.backend.slabs_in_use == \
                sum(r is not None for r in sched.slots)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref)
        assert sched.stats["preemptions"] > 0
        assert_baseline(sched)

    @pytest.mark.parametrize("kind", ["state", "hybrid"])
    def test_graphserver_close_is_leak_free(self, engines, kind):
        """GraphServer end to end on both backends (the xLSTM case is
        ``test_state_backend.py``'s); the leak check counts slabs at
        close."""
        rng = np.random.RandomState(10)
        prompts = make_prompts(rng, [5, 9, 7])
        eng = engines[kind]
        refs = [eng.generate(p[None], max_new_tokens=6)[0]
                for p in prompts]
        extra = {"num_blocks": 33, "block_size": 8} \
            if kind == "hybrid" else {}
        with GraphServer(eng, num_slots=2, backend=kind, chunk_size=8,
                         speculate_k=3, max_new_tokens=6, **extra) as srv:
            handles = [srv.submit(p) for p in prompts]
            results = [h.result(timeout=180) for h in handles]
            stats = srv.stats()
        for got, ref in zip(results, refs):
            np.testing.assert_array_equal(got, ref)
        assert stats["scheduler"]["state_slabs_in_use"] == 0
        assert stats["scheduler"]["state_slabs_peak"] == 2


def test_stack_buffer_widens_and_drops_the_graphs_bound_to_it(
        engines, monkeypatch):
    """``LLMEngine._stack_views``: windows of every width a tick takes
    share one stack buffer per (layout, slots); a wider window replaces
    it and ``StepGraphs.drop_bound_to`` forgets the captured steps bound
    to the old buffer (and only those).  The graphs are stand-ins: a
    ``StepGraphs`` holding ``CapturedStep`` records, nothing captured."""
    engine = engines["state"]
    backend = StateBackend(engine, 2)
    cache = engine.new_cache(backend)
    graphs = StepGraphs.__new__(StepGraphs)
    graphs.steps = {}
    monkeypatch.setattr(engine, "graphs", graphs)
    monkeypatch.setattr(engine, "_stacks", {})

    def bind(name, *trees):
        graphs.steps[(name,)] = CapturedStep(None, (), None, {},
                                             addresses(trees))

    wide = engine._stack_views("state", cache, 2, 4)
    narrow = engine._stack_views("state", cache, 2, 2)
    leaves = lambda tree: [a for a in flatten(tree).values() if a.numel()]
    for a, b in zip(leaves(wide), leaves(narrow)):
        assert a.data_ptr() == b.data_ptr() and b.shape[2] == 2
    bind("verify", cache, wide)
    bind("decode", cache)
    wider = engine._stack_views("state", cache, 2, 6)
    assert set(graphs.steps) == {("decode",)}
    assert all(a.shape[2] == 6 for a in leaves(wider))
    assert not addresses(wider) & addresses(cache)


class TestCapacityAndGates:
    """Honest capacity reporting and the engine support gates."""

    def test_state_capacity_is_max_len_only(self, engines):
        be = StateBackend(engines["state"], 2)
        assert be.max_request_tokens() == MAX_LEN
        assert "max_len" in be.capacity_desc()
        sched = Scheduler(be)
        with pytest.raises(ValueError, match="max_len"):
            sched.submit({"tokens": np.zeros(60, np.int32), "id": 0,
                          "max_new_tokens": 16})

    def test_paged_still_rejects_recurrent(self, engines):
        for eng in (engines["state"], engines["hybrid"]):
            with pytest.raises(ValueError, match="recurrent"):
                Scheduler(PagedBackend(eng, 2, num_blocks=17,
                                       block_size=8))

    def test_hybrid_requires_divisible_max_len(self, engines):
        with pytest.raises(ValueError, match="max_len"):
            Scheduler(HybridBackend(engines["hybrid"], 2, num_blocks=17,
                                    block_size=7))

    def test_hybrid_disables_prefix_sharing(self, engines):
        be = HybridBackend(engines["hybrid"], 2, num_blocks=17,
                           block_size=8)
        assert be.prefix is None

    def test_make_backend_builds_both(self, engines):
        be = make_backend(engines["state"], backend="state", num_slots=3,
                          spec_window=5)
        assert isinstance(be, StateBackend) and be.spec_window == 5
        be = make_backend(engines["hybrid"], backend="hybrid", num_slots=2,
                          num_blocks=17, block_size=8)
        assert isinstance(be, HybridBackend) and be.num_blocks == 17

    def test_verify_of_a_state_layout_refuses_the_plain_window(
            self, engines):
        """``LLMEngine.verify`` would commit every row's state over the
        whole window; the state layouts verify through
        ``verify_window``."""
        be = StateBackend(engines["state"], 2)
        Scheduler(be)
        with pytest.raises(ValueError, match="verify_window"):
            engines["state"].verify(be, be.cache, np.zeros((2, 3), np.int32),
                                    np.zeros(2, np.int32),
                                    np.ones(2, bool))

    def test_hybrid_graph_error_reaches_the_caller(self, engines):
        with pytest.raises(GraphError, match="multiple of block_size"):
            GraphServer(engines["hybrid"], num_slots=2, backend="hybrid",
                        num_blocks=17, block_size=7)


# ---------------------------------------------------------------------------
# the port against the JAX engine and Scheduler, on the same weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["state", "hybrid"])
def test_generate_matches_jax(pairs, kind):
    pair = pairs[kind]
    prompts = np.random.RandomState(12).randint(0, VOCAB, (2, 9)).astype(
        np.int32)
    np.testing.assert_array_equal(pair.port.generate(prompts, 8),
                                  pair.jax.generate(prompts, 8))


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("kind", ["state", "hybrid"])
def test_scheduler_matches_jax_scheduler(pairs, kind, spec):
    """The same requests through the JAX Scheduler and the port's, on
    the same backend kind and schedule (chunks of 8; speculation off and
    on with the same chaotic drafts; one preemption): the same tokens."""
    pair = pairs[kind]
    prompts = make_prompts(np.random.RandomState(13), [5, 17, 9, 12])
    runs = []
    for eng, state_cls, hybrid_cls, sched_cls in (
            (pair.jax, JaxState, JaxHybrid, JaxScheduler),
            (pair.port, StateBackend, HybridBackend, Scheduler)):
        be = hybrid_cls(eng, 2, num_blocks=33, block_size=8) \
            if kind == "hybrid" else state_cls(eng, 2)
        sched = sched_cls(be, max_new_tokens=7, chunk_size=8,
                          speculate_k=spec, draft_fn=chaotic_draft_fn(5))
        reqs = [sched.submit({"tokens": p, "id": i})
                for i, p in enumerate(prompts)]
        sched.admit()
        sched.step()
        sched.step()
        sched.preempt(reqs[0])
        runs.append(drain(sched))
        assert_baseline(sched)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(runs[1][i], runs[0][i])
