"""The port's encoder-decoder and modality stubs against the JAX package
on the CPU at f32, on the same weights (``params_from_jax``) and
numpy-seeded inputs: reduced seamless_m4t_large_v2 (2 encoder and 2
decoder layers, each decoder layer with a cross-attention block) and
reduced phi_3_vision_4_2b (a decoder behind 8 stub patch embeddings).

* The pieces: ``encode`` (the bidirectional encoder over stub frame
  embeddings, two layers and the final norm) within 1e-4, ``cross_kv``
  and ``_cross_attention`` within 1e-5 of their scale.
* The whole model: ``prefill`` with ``enc_embeds`` (seamless) and with
  ``prefix_embeds`` (phi_3_vision) against JAX ``Model.prefill``: the
  last-token logits within 1e-4, every cache leaf (``cross`` included)
  within 1e-4 of its scale, and 4 greedy decode steps' tokens equal,
  their logits within 1e-4 of their scale (after the stub inputs both
  packages sit up to 1e-4 from an f64 run of the port at a logit scale
  of 3.6-3.8); ``generate`` (tokens only, as in JAX) equal to the JAX
  engine's; the cross leaves through every walker of the cache tree
  (JAX's cache shapes, the slot insert, ``layer_kind_of_path``,
  ``cache_key``, ``_slot_max_len``).
* Serving phi_3_vision, which JAX refuses nowhere: the Scheduler on
  slot rows and on a paged arena (chunked prefill, prefix sharing,
  speculation, a preemption) bitwise the port's ``generate`` and equal
  to the JAX Scheduler's, the state and hybrid layouts against
  ``generate``, and the port's ``GraphServer``.
* The refusals of an encoder-decoder, where JAX raises them and with
  JAX's exception and message: the paged and hybrid arenas, extend,
  speculation and the Scheduler.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import PagedBackend as JaxPaged  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving import SlotBackend as JaxSlot  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import paging  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (flatten, params_from_jax,  # noqa: E402
                                       tree_map)
from repro_torch.serving import (GraphServer, HybridBackend,  # noqa: E402
                                 LLMEngine, PagedBackend, Scheduler,
                                 SlotBackend, StateBackend)
from test_torch_engine import (MAX_LEN, assert_tokens,  # noqa: E402
                               one_torch_thread)  # noqa: F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401
from test_torch_serving import drain, oracle_draft_fn  # noqa: E402

SEAMLESS = "seamless_m4t_large_v2"
PHI = "phi_3_vision_4_2b"
#: the logits' limit, and the pieces' and caches' relative to their scale
LOGITS_TOL = 1e-4
TOL = 1e-5
CACHE_TOL = 1e-4
#: frames of the stub encoder input
ENC_LEN = 12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    return np.abs(want - got).max() / np.abs(want).max()


def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _embeds(cfg, B, seed):
    """The stub inputs as ``data/pipeline.py`` draws them: frame
    embeddings of unit scale for an encoder-decoder, patch embeddings
    x 0.02 before the prompt otherwise."""
    rng = np.random.RandomState(seed)
    if cfg.is_encoder_decoder:
        return {"enc_embeds": rng.randn(B, ENC_LEN, cfg.d_model).astype(
            np.float32)}
    return {"prefix_embeds": (rng.randn(
        B, cfg.num_prefix_embeddings, cfg.d_model) * 0.02).astype(
            np.float32)}


class Pair:
    """A JAX engine and the port's engine holding the same weights."""

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_get_config(arch).reduced()
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=0)
        self.np_params = jax.tree.map(np.asarray, self.jax.params)
        self.port = LLMEngine(self.cfg, params_from_jax(self.np_params,
                                                        self.cfg),
                              max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {arch: Pair(arch) for arch in (SEAMLESS, PHI)}


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

def test_params_round_trip_encoder_and_cross_paths(pairs):
    """``params_from_jax`` carries the encoder and the decoder layers'
    cross blocks under the reference's paths, bit-exact, and the port's
    ``state_dict`` loads back into a model with the same tree."""
    pair = pairs[SEAMLESS]
    cfg = pair.cfg
    sd = pair.port.model.state_dict()
    assert set(sd) == set(flatten(pair.np_params))
    E, R, d = cfg.num_encoder_layers, cfg.num_layers, cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for path, shape in (("encoder.blocks.mixer.wq", (E, d, H, hd)),
                        ("encoder.blocks.ffn.w_down", (E, cfg.d_ff, d)),
                        ("encoder.final_norm.scale", (d,)),
                        ("blocks.l0.cross_norm.scale", (R, d)),
                        ("blocks.l0.cross.wk", (R, d, KV, hd)),
                        ("blocks.l0.cross.wo", (R, H, hd, d))):
        assert tuple(sd[path].shape) == shape, path
    assert not any("q_norm" in p for p in sd if ".cross." in p)
    for path, a in flatten(pair.np_params).items():
        assert np.array_equal(sd[path].numpy(), a), path
    again = Model(cfg, device="cpu", params=dict(sd))
    for path, a in again.state_dict().items():
        assert torch.equal(a, sd[path]), path


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_encode_matches_jax(pairs):
    pair = pairs[SEAMLESS]
    enc = _embeds(pair.cfg, 2, 0)["enc_embeds"]
    want = jax_tf.encode(pair.jax.params, pair.jcfg, jnp.asarray(enc),
                         jax_tf.RuntimeFlags())
    got = tf.encode(pair.port.model.params, pair.cfg, _t(enc))
    assert got.shape == (2, ENC_LEN, pair.cfg.d_model)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= LOGITS_TOL


def test_cross_kv_and_cross_attention_match_jax(pairs):
    """Group 1's decoder layer: the memory K/V, and 5 queries attending
    over them (more keys than queries, no mask)."""
    pair = pairs[SEAMLESS]
    cfg = pair.cfg
    rng = np.random.RandomState(1)
    memory = rng.randn(2, ENC_LEN, cfg.d_model).astype(np.float32)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], pair.jax.params["blocks"]["l0"][
        "cross"])
    tp = tree_map(lambda a: a[1], pair.port.model.params["blocks"]["l0"][
        "cross"])
    jkv = jax_tf.cross_kv(jp, jnp.asarray(memory))
    tkv = tf.cross_kv(tp, _t(memory))
    for k in ("k", "v"):
        assert tkv[k].shape == (2, ENC_LEN, cfg.num_kv_heads, cfg.head_dim)
        assert _rel(jkv[k], tkv[k].numpy()) <= TOL
    want = jax_tf._cross_attention(jp, pair.jcfg, jnp.asarray(x), jkv, None)
    got = tf._cross_attention(tp, _t(x), tkv)
    assert _rel(want, got.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the whole reduced model
# ---------------------------------------------------------------------------

def _close(jl, tl, cfg):
    real = slice(0, cfg.vocab_size)
    return np.abs(np.asarray(jl)[..., real] - tl[..., real].numpy()).max()


@pytest.mark.parametrize("arch", [SEAMLESS, PHI])
def test_prefill_with_embeddings_matches_jax(pairs, arch):
    """``prefill`` with the stub inputs, then 4 greedy decode steps
    (the decoder reads its cross caches): the prefill's logits within
    1e-4, every cache leaf within 1e-4 of its scale, the steps' logits
    within 1e-4 of their scale, greedy tokens equal."""
    pair = pairs[arch]
    cfg, je, model = pair.cfg, pair.jax, pair.port.model
    toks = _prompts(cfg, 2, 7, 2)
    kw = _embeds(cfg, 2, 3)
    jl, jc = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc = model.prefill(torch.as_tensor(toks).long(), MAX_LEN,
                           **{k: _t(v) for k, v in kw.items()})
    assert _close(jl, tl, cfg) <= LOGITS_TOL
    jflat = flatten(jax.tree.map(np.asarray, jc))
    tflat = flatten(tc)
    assert set(jflat) == set(tflat)
    assert any(".cross." in p for p in tflat) == cfg.is_encoder_decoder
    for path, a in jflat.items():
        assert _rel(a, tflat[path].numpy()) <= CACHE_TOL, path
    S = toks.shape[1] + (0 if cfg.is_encoder_decoder
                         else cfg.num_prefix_embeddings)
    want, got, steps = [], [], []
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    for i in range(4):
        want.append(np.asarray(jtok))
        got.append(ttok.numpy())
        steps.append(tl)
        pos = np.full(2, S + i, np.int32)
        jl, jc = je.model.decode_step(je.params, jtok[:, None], jc,
                                      jnp.asarray(pos))
        tl, tc = model.decode_step(ttok[:, None], tc, _t(pos))
        assert _close(jl, tl, cfg) <= LOGITS_TOL * np.abs(
            np.asarray(jl)[:, :cfg.vocab_size]).max()
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    assert_tokens(np.stack(want, 1), np.stack(got, 1),
                  torch.stack(steps, dim=1))
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    for path in tflat:
        if ".cross." in path:                # read, never written
            assert torch.equal(flatten(tc)[path], tflat[path]), path


def test_cache_walkers_carry_the_cross_leaves(pairs):
    """The cross leaves ride through every walker of the cache tree:
    ``Model.new_cache(..., enc_len)`` gives JAX's ``abstract_cache``
    shapes, the slot insert copies a prefilled row's cross K/V,
    ``layer_kind_of_path`` maps them to attention, ``cache_key`` keys
    them, ``_slot_max_len`` reads the self-attention rows alone, and a
    decode step on the inserted rows gives the prefill cache's logits
    bitwise."""
    from repro_torch.runtime.graphs import cache_key
    from repro_torch.runtime.steps import make_slot_insert
    pair = pairs[SEAMLESS]
    cfg, model = pair.cfg, pair.port.model
    want = flatten(jax.tree.map(
        lambda a: a.shape, jax_tf.abstract_cache(pair.jcfg, 3, MAX_LEN,
                                                 ENC_LEN)))
    cache = model.new_cache(3, MAX_LEN, enc_len=ENC_LEN)
    assert {p: tuple(a.shape) for p, a in flatten(cache).items()} == want
    toks = _prompts(cfg, 2, 6, 5)
    enc = _t(_embeds(cfg, 2, 6)["enc_embeds"])
    logits, rows = model.prefill(torch.as_tensor(toks).long(), MAX_LEN,
                                 enc_embeds=enc)
    insert = make_slot_insert()
    for r, slot in ((0, 2), (1, 0)):
        insert(cache, rows, r, slot)
    for path, a in flatten(rows).items():
        assert torch.equal(flatten(cache)[path][:, [2, 0]], a), path
        assert model.layer_kind_of_path(path) == "attn"
    assert len(cache_key(cache)) == len(flatten(cache)) == 4
    assert tf._slot_max_len(cfg, cache) == MAX_LEN
    tok = torch.argmax(logits, -1)
    pos = torch.full((2,), toks.shape[1], dtype=torch.int32)
    want_l, _ = model.decode_step(tok[:, None], rows, pos)
    got_l, _ = model.decode_step(tok[[1, 0, 0]][:, None], cache,
                                 torch.full((3,), toks.shape[1],
                                            dtype=torch.int32))
    assert torch.equal(got_l[[2, 0]], want_l)


@pytest.mark.parametrize("arch", [SEAMLESS, PHI])
def test_generate_matches_jax(pairs, arch):
    pair = pairs[arch]
    toks = _prompts(pair.cfg, 2, 6, 4)
    np.testing.assert_array_equal(pair.port.generate(toks, 8),
                                  pair.jax.generate(toks, 8))


# ---------------------------------------------------------------------------
# serving phi_3_vision on every layout
# ---------------------------------------------------------------------------

#: prompt lengths of the served requests, each starting with the same
#: 8 tokens (two blocks of 4 for prefix sharing)
LENGTHS = [14, 5, 16, 13, 8, 15]
SHARED = 8
SLOTS = 2
SPEC = 3
MAX_NEW = 10


def _requests(cfg):
    rng = np.random.RandomState(40)
    prefix = rng.randint(0, cfg.vocab_size, SHARED)
    return [np.concatenate([prefix, rng.randint(0, cfg.vocab_size,
                                                n - SHARED)])
            .astype(np.int32) if n > SHARED else prefix[:n].astype(np.int32)
            for n in LENGTHS]


def _backend(engine, kind, slot_cls=SlotBackend, paged_cls=PagedBackend):
    """2 slots; the paged arena (blocks of 4, prefix sharing) tight
    enough that pressure preempts."""
    if kind == "paged":
        return paged_cls(engine, SLOTS, num_blocks=12, block_size=4)
    if kind == "state":
        return StateBackend(engine, SLOTS)
    if kind == "hybrid":
        return HybridBackend(engine, SLOTS, num_blocks=12, block_size=4)
    return slot_cls(engine, SLOTS)


def _preempt_one_mid_decode(sched):
    """Step until a request has streamed 3 tokens, then preempt it."""
    while True:
        sched.admit()
        sched.step()
        for req in sched.slots:
            if req is not None and len(req.tokens) >= 3 \
                    and req not in sched.ingesting:
                sched.preempt(req)
                return


def _serve(backend, draft, sched_cls, prompts):
    sched = sched_cls(backend, max_new_tokens=MAX_NEW, chunk_size=8,
                      speculate_k=SPEC, draft_fn=draft)
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(sched)
    return sched, drain(sched)


@pytest.mark.parametrize("kind", ["slot", "paged", "state", "hybrid"])
def test_scheduler_serves_phi_like_generate(pairs, kind):
    """Chunked prefill, speculation and a preemption on every layout:
    each request's tokens bitwise ``generate``'s; on the slot and paged
    layouts also the JAX Scheduler's on the same schedule."""
    pair = pairs[PHI]
    port = pair.port
    prompts = _requests(pair.cfg)
    draft = oracle_draft_fn(port, prompts, MAX_NEW, 2,
                            np.random.RandomState(3))
    sched, got = _serve(_backend(port, kind), draft, Scheduler, prompts)
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["spec_accepted"] > 0
    assert sched.stats["chunked_prefill_ticks"] > 0
    if kind == "paged":
        assert sched.stats["shared_block_hits"] > 0
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], port.generate(p[None], MAX_NEW)[0],
            err_msg=f"request {i} against generate")
    if kind not in ("slot", "paged"):
        return
    _, want = _serve(_backend(pair.jax, kind, JaxSlot, JaxPaged), draft,
                     JaxScheduler, prompts)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"request {i} against JAX")


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_graphserver_serves_phi_like_generate(pairs, backend):
    pair = pairs[PHI]
    prompts = _requests(pair.cfg)[:4]
    kw = dict(num_slots=2, max_new_tokens=6, backend=backend,
              chunk_size=8, speculate_k=2)
    if backend == "paged":
        kw.update(num_blocks=33, block_size=8)
    with GraphServer(pair.port, **kw) as srv:
        got = [h.result(timeout=120)
               for h in [srv.submit(p) for p in prompts]]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], pair.port.generate(p[None], 6)[0],
            err_msg=f"request {i} against generate")


# ---------------------------------------------------------------------------
# the refusals of an encoder-decoder
# ---------------------------------------------------------------------------

def _arena(kind):
    return types.SimpleNamespace(kind=kind, num_slots=2, num_blocks=9,
                                 block_size=4)


def _raised(fn):
    try:
        fn()
    except Exception as e:                       # noqa: BLE001
        return type(e), str(e)
    pytest.fail("no refusal")


@pytest.mark.parametrize("case", [
    "paged_cache", "hybrid_cache", "extend_slot", "extend_paged",
    "extend_state", "extend_hybrid", "spec_slot", "spec_paged",
    "scheduler", "prefill_extend"])
def test_encoder_decoder_refused_as_in_jax(pairs, case):
    """Each refusal raises JAX's exception type with JAX's message."""
    pair = pairs[SEAMLESS]
    toks = _prompts(pair.cfg, 1, 4, 0)

    def run(engine, slot_cls, sched_cls, jax_side):
        what, _, kind = case.partition("_")
        if what in ("paged", "hybrid"):
            return engine.new_cache(_arena(what))
        if what == "extend":
            return engine.check_extend_support(kind)
        if what == "spec":
            return engine.check_spec_support(kind)
        if what == "scheduler":
            return sched_cls(slot_cls(engine, 2))
        # the model's own prefill_extend on a slot prefix
        _, cache = engine.prefill(toks)
        if jax_side:
            from repro.models import paging as jax_paging
            return engine.model.prefill_extend(
                engine.params, jnp.asarray(toks[:, 2:]), cache,
                jax_paging.SlotPrefix(slots=jnp.zeros(1, jnp.int32)), 2,
                MAX_LEN)
        return engine.model.prefill_extend(
            torch.as_tensor(toks[:, 2:]).long(), cache,
            paging.SlotPrefix(slots=torch.zeros(1, dtype=torch.long)), 2,
            MAX_LEN)

    want = _raised(lambda: run(pair.jax, JaxSlot, JaxScheduler, True))
    got = _raised(lambda: run(pair.port, SlotBackend, Scheduler, False))
    assert want[0] is ValueError and "encoder-decoder" in want[1], want
    assert got == want


def test_phi_is_refused_nowhere(pairs):
    """A modality stub alone (phi_3_vision) is a dense MHA decoder to
    every layout: extend and speculation pass on each."""
    engine = pairs[PHI].port
    for kind in ("slot", "paged", "state", "hybrid"):
        engine.check_extend_support(kind)
        engine.check_spec_support(kind)
        assert engine.new_cache(_arena(kind))
