"""MLA on the state and hybrid layouts (ROADMAP item 15): reduced
deepseek_v3_671b (a dense head layer, then a MoE layer; MLA with q/kv
lora 32) served on the layouts of the recurrent stacks, against the JAX
engine on the CPU at f32 on the same weights (``params_from_jax``).

As JAX's ``abstract_hybrid_cache`` does, the hybrid layout pages MLA's
latents (``abstract_paged_mla_cache``) and decodes them through
``mla.paged_decode``; the state layout keeps them in slot rows.  A stack
with no recurrent layer has no state to stack, so speculation on these
layouts is the verify window with its (empty) stacks and rewind, as in
JAX's ``check_spec_support``.

* The caches have JAX's shapes on both layouts.
* The Scheduler (2 slots, chunks of 8, speculation 3, one forced
  preemption; the hybrid arena tight enough that pressure preempts)
  streams each request's tokens bitwise the port's ``generate`` of it
  alone, bitwise the port's slot and paged layouts' tokens, and equal
  to the JAX Scheduler's on the same layout.  Every MoE call keeps
  ``moe.capacity(cfg, N) >= N`` (ROADMAP Hazard 7), asserted by the
  ``calls`` fixture of ``test_torch_mla.py``.
* The engine's serving sequence (prefill, insert, decode, the verify
  window and its rewind) gives JAX's tokens on both layouts.
* ``GraphServer`` serves both layouts; ``use_paged_kernel`` stays
  refused with MLA on a paged arena, as in JAX.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving.kvcache import (HybridBackend as JaxHybrid,  # noqa: E402
                                   StateBackend as JaxState)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.serving import (GraphServer, HybridBackend,  # noqa: E402
                                 LLMEngine, StateBackend)
from test_torch_engine import MAX_LEN, one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401
from test_torch_mla import (MAX_NEW, _cfgs, _preempt_one_mid_decode,  # noqa: E402
                            _requests, _sched, calls, pair)  # noqa: F401
from test_torch_serving import drain, oracle_draft_fn  # noqa: E402

#: the layouts of this slice: (port backend, JAX backend, the port's
#: layout of the same cache geometry)
LAYOUTS = {"state": (StateBackend, JaxState, "slot"),
           "hybrid": (HybridBackend, JaxHybrid, "paged")}


def _backend(kind, port=True):
    cls = LAYOUTS[kind][0 if port else 1]
    return {"slot_cls": cls} if kind == "state" else {"paged_cls": cls}


def _layout_of(kind):
    """``_sched``'s kind: its slot arm or its paged arm."""
    return "slot" if kind == "state" else "paged"


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_cache_shapes_match_jax(kind):
    """State: slot rows of latents; hybrid: a paged latent arena per
    layer, as JAX's ``abstract_hybrid_cache`` builds it."""
    cfg, jcfg = _cfgs()
    if kind == "state":
        want = jax_tf.abstract_cache(jcfg, 2, MAX_LEN)
        got = tf.abstract_cache(cfg, 2, MAX_LEN)
    else:
        want = jax_tf.abstract_hybrid_cache(jcfg, 2, 9, 4)
        got = tf.abstract_hybrid_cache(cfg, 2, 9, 4)
    want = {k: a.shape for k, a in flatten(jax.tree.map(
        lambda s: np.zeros(s.shape, np.int8), want)).items()}
    got = {k: tuple(a.shape) for k, a in flatten(got).items()}
    assert got == want
    assert {k.rsplit(".", 1)[-1] for k in got} == {"c_kv", "k_rope"}


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_scheduler_matches_generate_and_jax(pair, calls, kind):
    port = pair.port
    prompts = _requests(pair.cfg)
    draft = oracle_draft_fn(port, prompts, MAX_NEW, 2,
                            np.random.RandomState(3))
    sched = _sched(port, _layout_of(kind), draft, **_backend(kind))
    assert sched.backend.kind == kind
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(sched)
    got = drain(sched)
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["replayed_tokens"] > 0
    assert sched.stats["spec_accepted"] > 0
    assert sched.stats["chunked_prefill_ticks"] > 0
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], port.generate(p[None], MAX_NEW)[0],
            err_msg=f"request {i} against generate")

    # the port's layout of the same geometry, on the same schedule
    twin = _sched(port, _layout_of(kind), draft)
    assert twin.backend.kind == LAYOUTS[kind][2]
    for i, p in enumerate(prompts):
        twin.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(twin)
    same = drain(twin)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], same[i],
                                      err_msg=f"request {i} against "
                                              f"{LAYOUTS[kind][2]}")

    # the JAX Scheduler on the same layout, weights and schedule
    jsched = _sched(pair.jax, _layout_of(kind), draft,
                    sched_cls=JaxScheduler, **_backend(kind, port=False))
    for i, p in enumerate(prompts):
        jsched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(jsched)
    want = drain(jsched)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"request {i} against JAX")


def _sequence(engine, kind, backend_cls):
    """prefill -> insert (two requests) -> 3 decode ticks -> a verify
    window of 3 -> the rewind of row 0 to its second position -> a
    decode tick; returns every step's tokens."""
    kw = {} if kind == "state" else {"num_blocks": 1 + 2 * (MAX_LEN // 4),
                                     "block_size": 4}
    be = backend_cls(engine, 2, **kw)
    be.cache = engine.new_cache(be)
    toks = np.random.RandomState(5).randint(
        0, engine.cfg.vocab_size, (2, 8)).astype(np.int32)
    log = []
    first, rows = engine.prefill(toks)
    log.append(first)
    pages = np.arange(1, 1 + 2 * (MAX_LEN // 4), dtype=np.int32).reshape(
        2, -1)
    tables = np.zeros((2, MAX_LEN // 4), np.int32)
    for r in range(2):
        if kind == "state":
            be.cache = engine.insert(be, be.cache, rows, r, r)
        else:
            ids = pages[r].copy()
            ids[2:] = 0                      # the prompt's two pages
            be.cache = engine.insert(be, be.cache, rows, r, (ids, r))
            tables[r] = pages[r]
    tb = {} if kind == "state" else {"block_tables": tables}
    pos = np.full(2, 8, np.int32)
    last = first
    active = np.ones(2, bool)
    for _ in range(3):
        last, be.cache = engine.decode(be, be.cache, last, pos, active, **tb)
        log.append(last)
        pos = pos + 1
    window = np.stack([last, (last + 1) % 256, (last + 2) % 256], axis=1
                      ).astype(np.int32)
    guess, be.cache, stacks = engine.verify_window(be, be.cache, window, pos,
                                                   active, **tb)
    log.append(guess)
    be.cache = engine.state_rewind(be.cache, stacks, 0, 1)
    pos = pos + np.array([2, 3], np.int32)
    last = np.array([guess[0, 1], guess[1, 2]], np.int32)
    last, be.cache = engine.decode(be, be.cache, last, pos, active, **tb)
    log.append(last)
    return log


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_serving_sequence_matches_jax(pair, calls, kind):
    port_cls, jax_cls, _ = LAYOUTS[kind]
    want = _sequence(pair.jax, kind, jax_cls)
    got = _sequence(pair.port, kind, port_cls)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"step {i}")


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_graphserver_serves_the_layout(pair, calls, kind):
    """The port's ``GraphServer`` on the layout (chunks of 8,
    speculation 2) gives ``generate``'s tokens."""
    prompts = _requests(pair.cfg)[:4]
    kw = dict(num_slots=2, max_new_tokens=6, backend=kind, chunk_size=8,
              speculate_k=2)
    if kind == "hybrid":
        kw.update(num_blocks=33, block_size=8)
    with GraphServer(pair.port, **kw) as srv:
        got = [h.result(timeout=120)
               for h in [srv.submit(p) for p in prompts]]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], pair.port.generate(p[None], 6)[0],
            err_msg=f"request {i} against generate")


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_support_checks(kind):
    """Extend and speculation are supported on both layouts; the paged
    kernel (K5) reads GQA K/V only, so ``use_paged_kernel`` is refused
    with MLA on the hybrid arena, as in JAX."""
    cfg, _ = _cfgs()
    engine = LLMEngine(cfg, max_len=16, device="cpu")
    engine.check_extend_support(kind)
    engine.check_spec_support(kind)
    kernel = LLMEngine(cfg, max_len=16, device="cpu",
                       flags=RuntimeFlags(use_paged_kernel=True))
    backend = types.SimpleNamespace(kind=kind, num_slots=2, num_blocks=9,
                                    block_size=4)
    if kind == "hybrid":
        with pytest.raises(ValueError, match="use_paged_kernel covers"):
            kernel.new_cache(backend)
    else:
        assert kernel.new_cache(backend)["head_layers"]["layer0"][
            "mixer"]["c_kv"].shape == (2, 16, cfg.kv_lora_rank)
