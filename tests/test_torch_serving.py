"""The port's Scheduler (repro_torch.serving) on the CPU at reduced f32
sizes: against the JAX Scheduler's tokens on the same weights, and
against the port's own ``generate``, bitwise, under every schedule the
serving invariants cover — slot | paged x whole | chunked prefill,
lookup and adversarial speculative drafts, forced and pressure
preemption with replay, prefix sharing with truncate, and cancellation
— with the engine's kernel flags on the fused (K2), split-K (K4),
paged-kernel (K5) and gather arms.

Bit-identity rests on the port's width rule (``models.layers.linear``
multiplies a single row as two) and on plain attention versions whose
row arithmetic does not depend on the batch, the query count or the
key length (``kernels.ref``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import PagedBackend as JaxPaged  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving import SlotBackend as JaxSlot  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.serving import (LLMEngine, PagedBackend,  # noqa: E402
                                 Scheduler, SlotBackend, make_backend)
from test_torch_engine import one_torch_thread  # noqa: E402,F401

FLAGS = {
    "fused": RuntimeFlags(),
    "splitk": RuntimeFlags(fused_split_k=True),
    "paged_kernel": RuntimeFlags(use_fused_decode=False,
                                 use_paged_kernel=True),
    "gather": RuntimeFlags(use_fused_decode=False, use_flash=False),
}


def small_cfg(name="minicpm_2b", **kw):
    base = dict(num_layers=2, d_model=128, vocab_size=512)
    base.update(kw)
    return dataclasses.replace(get_config(name).reduced(), **base)


@pytest.fixture(scope="module")
def engines():
    """One port engine per flag set, all on the same random weights."""
    first = LLMEngine(small_cfg(), max_len=64, seed=7, device="cpu")
    out = {"fused": first}
    params = dict(first.model.named_parameters())
    for name, flags in FLAGS.items():
        if name not in out:
            out[name] = LLMEngine(small_cfg(), params, max_len=64,
                                  flags=flags, device="cpu")
    return out


@pytest.fixture(scope="module")
def engine(engines):
    return engines["fused"]


@pytest.fixture(scope="module")
def loop_engine():
    """Tiny-vocab engine whose greedy decode settles into repetition
    loops — the regime honest prompt-lookup drafting exploits."""
    return LLMEngine(small_cfg(vocab_size=4, num_layers=1, d_model=64),
                     max_len=128, seed=0, device="cpu")


def make_prompts(rng, lengths, vocab=512):
    return [rng.randint(0, vocab, size=L).astype(np.int32)
            for L in lengths]


def backend(engine, kind, num_slots, **kw):
    if kind == "paged":
        kw.setdefault("num_blocks", 65)
        kw.setdefault("block_size", 8)
        return PagedBackend(engine, num_slots, **kw)
    return SlotBackend(engine, num_slots)


def drain(sched, got=None):
    got = {} if got is None else got
    while sched.has_work():
        for ev in sched.admit() + sched.step():
            if ev.finished:
                got[ev.request.id] = np.asarray(ev.request.tokens,
                                                np.int32)
        if sched.pool is not None:
            sched.pool.check_invariants()
    return got


def assert_baseline(sched):
    """Slots, blocks, reservations and trie refs back where they
    started."""
    assert sorted(sched.free) == list(range(sched.num_slots))
    if sched.pool is not None:
        assert sched.pool.blocks_in_use == 0
        assert sched.pool.reserved_blocks == 0
        assert len(sched.prefix) == 0


def serve(engine, kind, prompts, max_new, **kw):
    sched = Scheduler(backend(engine, kind, kw.pop("num_slots", 3),
                              **kw.pop("backend_kw", {})),
                      max_new_tokens=max_new, **kw)
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    return sched, drain(sched)


def assert_generate(engine, prompts, max_new, got):
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], engine.generate(p[None], max_new_tokens=max_new)[0],
            err_msg=f"request {i}")


def oracle_draft_fn(engine, prompts, max_new, error_every=0, rng=None):
    """A drafter that knows each request's true continuation and
    optionally corrupts draft positions: acceptance patterns from
    full-accept to instant-reject."""
    paths = [np.concatenate([p, engine.generate(p[None], max_new)[0]])
             .astype(np.int32) for p in prompts]

    def draft(context, k):
        n = context.size
        for full in paths:
            if n < full.size and np.array_equal(full[:n], context):
                d = full[n:n + k].copy()
                if error_every and d.size:
                    bad = rng.rand(d.size) < 1.0 / error_every
                    d[bad] = (d[bad] + 1 + rng.randint(
                        0, 500, size=int(bad.sum()))) % 512
                return d
        return np.zeros(0, np.int32)

    return draft


# ---------------------------------------------------------------------------
# against the JAX Scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_scheduler_matches_jax_scheduler(kind):
    cfg = small_cfg()
    jcfg = dataclasses.replace(jax_get_config("minicpm_2b").reduced(),
                               num_layers=2, d_model=128, vocab_size=512)
    jax_engine = JaxEngine(jcfg, max_len=64, seed=7)
    port = LLMEngine(cfg, params_from_jax(
        jax.tree.map(np.asarray, jax_engine.params), cfg), max_len=64,
        device="cpu")
    prompts = make_prompts(np.random.RandomState(20), [5, 19, 7, 26])
    runs = {}
    for name, eng, slot_cls, paged_cls, sched_cls in (
            ("jax", jax_engine, JaxSlot, JaxPaged, JaxScheduler),
            ("port", port, SlotBackend, PagedBackend, Scheduler)):
        be = paged_cls(eng, 2, num_blocks=33, block_size=8) \
            if kind == "paged" else slot_cls(eng, 2)
        sched = sched_cls(be, max_new_tokens=6, chunk_size=8,
                          speculate_k=2)
        for i, p in enumerate(prompts):
            sched.submit({"tokens": p, "id": i})
        runs[name] = drain(sched)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(runs["port"][i], runs["jax"][i],
                                      err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# against the port's own generate, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_continuous_batching_matches_generate(engines, kind, chunk, flags):
    engine = engines[flags]
    prompts = make_prompts(np.random.RandomState(0), [5, 9, 5, 13, 7, 37])
    sched, got = serve(engine, kind, prompts, 6, chunk_size=chunk)
    assert_generate(engine, prompts, 6, got)
    if chunk:
        assert sched.stats["chunked_prefill_ticks"] >= 4
    assert_baseline(sched)


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_lookup_speculation_matches_generate(loop_engine, kind, chunk):
    prompts = make_prompts(np.random.RandomState(0), [5, 9, 6, 7, 5],
                           vocab=4)
    sched, got = serve(loop_engine, kind, prompts, 24, chunk_size=chunk,
                       speculate_k=4)
    assert_generate(loop_engine, prompts, 24, got)
    assert sched.stats["spec_accepted"] > 0
    assert sched.stats["decode_steps"] < 24 * len(prompts)
    assert_baseline(sched)


@pytest.mark.parametrize("flags", ["fused", "splitk", "gather"])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_adversarial_drafts_bit_identical(engines, kind, flags):
    """Drafts that flip from right to wrong at random positions: every
    acceptance length 0..k is exercised, the stream must not care."""
    engine = engines[flags]
    prompts = make_prompts(np.random.RandomState(1), [5, 9, 5, 13, 7])
    for error_every in (0, 2, 1):
        draft = oracle_draft_fn(engine, prompts, 10, error_every,
                                np.random.RandomState(2))
        sched, got = serve(engine, kind, prompts, 10, speculate_k=4,
                           draft_fn=draft)
        assert_generate(engine, prompts, 10, got)
        if error_every == 0:
            st = sched.stats
            assert st["spec_accepted"] == st["spec_drafted"] > 0
        assert_baseline(sched)


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_forced_preemption_mid_decode_replays(engine, kind):
    """Preempt a request that already streamed tokens: the replay
    re-derives (and suppresses) them, then continues identically."""
    prompts = make_prompts(np.random.RandomState(14), [5, 9])
    sched = Scheduler(backend(engine, kind, 2), max_new_tokens=6)
    r0 = sched.submit({"tokens": prompts[0], "id": 0})
    sched.submit({"tokens": prompts[1], "id": 1})
    sched.admit()
    sched.step()
    sched.step()
    streamed = list(r0.tokens)
    sched.preempt(r0)
    got = drain(sched)
    assert_generate(engine, prompts, 6, got)
    np.testing.assert_array_equal(got[0][:len(streamed)], streamed)
    assert r0.preemptions == 1
    assert sched.stats["replayed_tokens"] == len(streamed)
    assert_baseline(sched)


@pytest.mark.parametrize("spec", [0, 3])
def test_pressure_preempts_and_replays_exactly(engine, spec):
    """8 usable blocks of 4 tokens for 6 requests that each grow to 5
    pages: optimistic admission over-admits, pool pressure preempts
    (during speculation too), and every replay is exact."""
    prompts = make_prompts(np.random.RandomState(12), [6] * 6)
    draft = oracle_draft_fn(engine, prompts, 12, 2,
                            np.random.RandomState(3)) if spec else None
    sched, got = serve(engine, "paged", prompts, 12, num_slots=6,
                       backend_kw={"num_blocks": 9, "block_size": 4},
                       speculate_k=spec, draft_fn=draft)
    assert_generate(engine, prompts, 12, got)
    assert sched.stats["preemptions"] > 0
    assert_baseline(sched)


def test_prefix_sharing_with_truncate(engine):
    """Speculation on requests sharing prompt-prefix blocks never frees
    or unregisters the shared blocks; the suffixes extend against them
    and every stream matches generate."""
    rng = np.random.RandomState(12)
    prefix = rng.randint(0, 512, size=16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, 512, size=3 + i)
                               .astype(np.int32)]) for i in range(3)]
    draft = oracle_draft_fn(engine, prompts, 6, 2, np.random.RandomState(13))
    sched, got = serve(engine, "paged", prompts, 6, speculate_k=3,
                       draft_fn=draft,
                       backend_kw={"num_blocks": 40, "block_size": 8})
    assert_generate(engine, prompts, 6, got)
    assert sched.stats["shared_block_hits"] > 0
    assert sched.stats["extend_prefills"] > 0
    assert_baseline(sched)


@pytest.mark.parametrize("point", ["queued", "mid_prefill", "mid_decode"])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_cancel_keeps_survivors_exact(engine, kind, point):
    rng = np.random.RandomState(11)
    victim, keep = make_prompts(rng, [30, 8])
    slots = 1 if point == "queued" else 2
    sched = Scheduler(backend(engine, kind, slots), max_new_tokens=5,
                      chunk_size=8 if point == "mid_prefill" else None)
    if point == "queued":
        sched.submit({"tokens": keep, "id": "keep"})
        vreq = sched.submit({"tokens": victim, "id": "victim"})
        sched.admit()
        assert vreq in sched.waiting
    else:
        vreq = sched.submit({"tokens": victim, "id": "victim"})
        sched.submit({"tokens": keep, "id": "keep"})
        sched.admit()
        if point == "mid_prefill":
            assert 0 < vreq.ingested < victim.size
        else:
            sched.step()
            assert vreq.slot >= 0 and len(vreq.tokens) == 2
    streamed = list(vreq.tokens)
    evs = sched.cancel("victim")
    assert [(e.request.id, e.finished) for e in evs] == [("victim", True)]
    assert vreq.finish_reason == "cancelled"
    got = drain(sched)
    np.testing.assert_array_equal(
        got["keep"], engine.generate(keep[None], max_new_tokens=5)[0])
    np.testing.assert_array_equal(
        streamed, engine.generate(victim[None], max_new_tokens=5)[0][
            :len(streamed)])
    assert sched.stats["requests_cancelled"] == 1
    assert_baseline(sched)


# ---------------------------------------------------------------------------
# replay after a mid-decode preemption: through the decode step
# ---------------------------------------------------------------------------

def _runner_up(fn):
    """``fn`` with each row's top logit pushed below the others, so that
    its greedy token is the runner-up."""
    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        logits = logits.clone()
        logits.scatter_(-1, logits.argmax(-1, keepdim=True), float("-inf"))
        return logits, cache

    return wrapped


@pytest.fixture(scope="module")
def skewed(engine):
    """The engine's weights behind a prefill and an extend that derive
    their token otherwise than decode does (the runner-up): a stand-in
    for the card, where in bf16 prefill rounds the last hidden row
    otherwise than a decode step and need not give its token.  Its
    ``generate`` takes the first token from prefill and the rest from
    decode steps, as serving does."""
    eng = LLMEngine(small_cfg(), dict(engine.model.named_parameters()),
                    max_len=64, device="cpu")
    eng.model.prefill = _runner_up(eng.model.prefill)
    eng.model.prefill_extend = _runner_up(eng.model.prefill_extend)
    return eng


def _preempt_mid_decode(sched, req, tokens):
    """Drive ``sched`` until ``req`` has streamed ``tokens`` tokens, then
    preempt it."""
    while len(req.tokens) < tokens:
        sched.admit()
        sched.step()
    sched.preempt(req)


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_prefill_replay_of_decode_tokens_raises(skewed, kind):
    """The reference's replay (``prompt ++ tokens[:-1]`` through prefill)
    cannot re-derive a token that a decode step made where the two round
    differently: the scheduler's determinism check raises."""
    prompts = make_prompts(np.random.RandomState(40), [9, 13])
    be = backend(skewed, kind, 2)
    # every position through prefill and extend, the streamed tokens too
    be._prompt_end = lambda req, start, end: end
    sched = Scheduler(be, max_new_tokens=10, chunk_size=8)
    r0 = sched.submit({"tokens": prompts[0], "id": 0})
    sched.submit({"tokens": prompts[1], "id": 1})
    _preempt_mid_decode(sched, r0, 4)
    with pytest.raises(RuntimeError, match="re-derived token .* already "
                                           "streamed"):
        drain(sched)


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_decode_replay_gives_generate_tokens(skewed, kind, chunk, spec):
    """The same preemptions replayed through the decode step (verify
    windows of 1 + k where the request speculates): every request ends
    with ``generate``'s tokens, the replay made decode steps, and the
    streamed tokens are counted as replayed."""
    prompts = make_prompts(np.random.RandomState(41), [9, 13, 6])
    draft = oracle_draft_fn(skewed, prompts, 12, 2,
                            np.random.RandomState(5)) if spec else None
    sched = Scheduler(backend(skewed, kind, 2), max_new_tokens=12,
                      chunk_size=chunk, speculate_k=spec, draft_fn=draft)
    reqs = [sched.submit({"tokens": p, "id": i})
            for i, p in enumerate(prompts)]
    _preempt_mid_decode(sched, reqs[0], 4)
    streamed = len(reqs[0].tokens)
    got = {}
    while reqs[1].slot < 0 or len(reqs[1].tokens) < 6:
        for ev in sched.admit() + sched.step():
            if ev.finished:
                got[ev.request.id] = np.asarray(ev.request.tokens, np.int32)
    if not reqs[1].finished:
        sched.preempt(reqs[1])
    got = drain(sched, got)
    assert_generate(skewed, prompts, 12, got)
    assert reqs[0].preemptions == 1
    assert sched.stats["replayed_tokens"] >= streamed
    assert sched.stats["replay_steps"] > 0
    assert_baseline(sched)


def _row_kv(sched, req, n):
    """Positions ``[0, n)`` of ``req``'s K/V, every layer, read through
    its slot row or its block table."""
    be = sched.backend
    out = []
    for leaf in (be.cache["blocks"]["l0"]["mixer"][k] for k in "kv"):
        if be.kind == "paged":
            pages = torch.as_tensor(be.tables[req.slot]).long()
            row = leaf[:, pages].reshape(leaf.shape[0], -1,
                                         *leaf.shape[3:])
        else:
            row = leaf[:, req.slot]
        out.append(row[:, :n].clone())
    return out


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_replay_restores_kv_bitwise(engine, kind, spec):
    """After the replay of a request preempted mid-decode, its K/V at
    every position it held equal bitwise what it held before, read
    through its (new) slot row or block table."""
    prompts = make_prompts(np.random.RandomState(42), [11, 7])
    draft = oracle_draft_fn(engine, prompts, 12, 2,
                            np.random.RandomState(6)) if spec else None
    sched = Scheduler(backend(engine, kind, 2), max_new_tokens=12,
                      chunk_size=8, speculate_k=spec, draft_fn=draft)
    r0 = sched.submit({"tokens": prompts[0], "id": 0})
    sched.submit({"tokens": prompts[1], "id": 1})
    while len(r0.tokens) < 5:
        sched.admit()
        sched.step()
    held = int(sched.positions[r0.slot])
    before = _row_kv(sched, r0, held)
    sched.preempt(r0)
    while r0.slot < 0 or r0 in sched.ingesting:
        sched.admit()
    assert int(sched.positions[r0.slot]) == held
    for a, b in zip(before, _row_kv(sched, r0, held)):
        assert torch.equal(a, b)
    assert_generate(engine, prompts, 12, drain(sched))
    assert_baseline(sched)


def test_replay_keeps_prefix_chunk_boundaries(engine):
    """A request that computed its prompt itself is preempted while
    another request still holds three of its prompt blocks.  Its replay
    shares only as many of them as keep its chunk boundaries where they
    were (two, with chunks of two blocks), so that its prompt is
    recomputed in the same pieces."""
    rng = np.random.RandomState(43)
    a = rng.randint(0, 512, size=20).astype(np.int32)
    b = np.concatenate([a[:12], rng.randint(0, 512, size=6)
                        .astype(np.int32)])
    be = backend(engine, "paged", 2, num_blocks=33, block_size=4)
    calls = []
    real = be.ingest

    def ingest(req, seq, start, end):
        calls.append((req.id, start, end))
        return real(req, seq, start, end)

    be.ingest = ingest
    sched = Scheduler(be, max_new_tokens=8, chunk_size=8)
    ra = sched.submit({"tokens": a, "id": "a"})
    while ra in sched.ingesting or ra.slot < 0:
        sched.admit()
    sched.submit({"tokens": b, "id": "b"})
    sched.admit()
    assert sched.stats["shared_block_hits"] == 3
    _preempt_mid_decode(sched, ra, 4)
    first = [(s, min(e, a.size)) for rid, s, e in calls if rid == "a"]
    del calls[:]
    got = drain(sched)
    again = [(s, min(e, a.size)) for rid, s, e in calls
             if rid == "a" and s < a.size]
    assert again == [c for c in first if c[0] >= 8] and again[0][0] == 8
    assert_generate(engine, [a, b], 8, {0: got["a"], 1: got["b"]})
    assert_baseline(sched)


# ---------------------------------------------------------------------------
# what the engine refuses
# ---------------------------------------------------------------------------

def test_unported_layouts_and_k5_verify_raise(engines):
    """The state and hybrid layouts are built since ROADMAP Queue 1 item
    7; an unknown layout, a window through the single-query paged kernel
    and a block size that does not divide ``max_len`` stay refused."""
    from repro_torch.serving import HybridBackend, StateBackend
    assert isinstance(make_backend(engines["fused"], backend="state"),
                      StateBackend)
    assert isinstance(make_backend(engines["fused"], backend="hybrid",
                                   num_blocks=9), HybridBackend)
    with pytest.raises(ValueError, match="unknown backend kind"):
        make_backend(engines["fused"], backend="ring")
    # the single-query paged kernel cannot verify a window (as in JAX)
    with pytest.raises(ValueError, match="use_paged_kernel"):
        Scheduler(backend(engines["paged_kernel"], "paged", 2),
                  speculate_k=2)
    with pytest.raises(ValueError, match="multiple of block_size"):
        Scheduler(PagedBackend(engines["fused"], 2, num_blocks=9,
                               block_size=24))
