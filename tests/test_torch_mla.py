"""The port's MLA (repro_torch.models.mla), its blockwise attention
(repro_torch.models.chunked_attention) and the architecture they make
servable, deepseek_v3_671b (reduced: a dense head layer, then a MoE
layer of 4 experts top-2 with a shared expert, MLA with q/kv lora 32,
nope 32, rope 16, v 32, and a multi-token prediction head), against the
JAX package on the CPU at f32, on the same weights (``params_from_jax``)
and numpy-seeded inputs.

* The MLA layer's pieces: the projections within 1e-6 of their scale,
  ``chunked_attention`` (value head dim apart from the qk one, a
  ``q_offset``), the prefill arm, the slot and paged decode at S' = 1
  and 5, the extend and the prefill into a cache within 1e-5 of their
  scale, and the caches they write.
* The port's laws: the weight-absorbed decode equals attention over
  materialised K/V; a row alone is bitwise its row of the batch; an
  extend's suffix rows are bitwise a cold prefill's; paged decode is
  bitwise slot decode.
* The whole reduced model: prefill, decode, verify, extend and MTP
  logits within 1e-4 of JAX's; greedy tokens equal to JAX's; the
  engine's serving sequences on both layouts with JAX's tokens and
  caches at the f32 floor; the Scheduler on slot rows and on a paged
  arena (chunked prefill, prefix sharing, speculation, a preemption)
  bitwise the port's ``generate`` and equal to the JAX Scheduler's;
  the port's ``GraphServer`` and launcher.  Every MoE call keeps
  ``moe.capacity(cfg, N) >= N`` (ROADMAP Hazard 7: reduced calls of
  9-12 tokens can drop), asserted by the ``calls`` fixture.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import chunked_attention as jax_chunked  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import paging as jax_paging  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import PagedBackend as JaxPaged  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving import SlotBackend as JaxSlot  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import mla, moe, paging  # noqa: E402
from repro_torch.models.chunked_attention import (  # noqa: E402
    chunked_attention, sequence_parallel_attention)
from repro_torch.models.params import (flatten, params_from_jax,  # noqa: E402
                                       tree_map)
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.runtime.steps import kernel_path  # noqa: E402
from repro_torch.serving import (GraphServer, LLMEngine,  # noqa: E402
                                 PagedBackend, Scheduler, SlotBackend,
                                 StateBackend)
from test_torch_engine import (MAX_LEN, _serve, assert_cache_close,  # noqa: E402
                               assert_tokens, one_torch_thread)  # noqa: F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401
from test_torch_paged import _serve_paged  # noqa: E402
from test_torch_serving import drain, oracle_draft_fn  # noqa: E402

ARCH = "deepseek_v3_671b"
FLAGS = RuntimeFlags()
#: the layer-level limit, relative to the output's scale
TOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(get_config(ARCH).reduced(), **kw),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **kw))


def _tensors(np_tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in np_tree.items()}


@pytest.fixture(scope="module")
def layer():
    """(port cfg, JAX cfg, JAX params, port params) of one MLA layer."""
    cfg, jcfg = _cfgs()
    jp = jax_init(jax_mla.mla_template(jcfg), jax.random.PRNGKey(3),
                  "float32")
    return cfg, jcfg, jp, _tensors(jax.tree.map(np.asarray, jp))


def _x(cfg, B, S, seed):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(start + np.arange(S, dtype=np.int32), (B, S))


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    return np.abs(want - got).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the layer's pieces against JAX
# ---------------------------------------------------------------------------

def test_projections_match_jax(layer):
    cfg, jcfg, jp, tp = layer
    x, pos = _x(cfg, 2, 7, 0), _pos(2, 7, 3)
    jn, jr = jax_mla._project_q(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tn, tr = mla._project_q(tp, cfg, _t(x), _t(pos), FLAGS)
    jc, jk = jax_mla._project_kv_latent(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos))
    tc, tk = mla._project_kv_latent(tp, cfg, _t(x), _t(pos), FLAGS)
    for want, got in ((jn, tn), (jr, tr), (jc, tc), (jk, tk)):
        assert _rel(want, got.numpy()) <= 1e-6


@pytest.mark.parametrize("S,T,q_offset", [(1, 9, 8), (6, 6, 0),
                                          (5, 140, 135), (70, 200, 130)])
def test_chunked_attention_matches_jax(S, T, q_offset):
    """vd != hd, GQA grouping, a q_offset, key blocks past the first."""
    rng = np.random.RandomState(S + T)
    q = rng.randn(2, S, 4, 48).astype(np.float32)
    k = rng.randn(2, T, 2, 48).astype(np.float32)
    v = rng.randn(2, T, 2, 32).astype(np.float32)
    want = jax_chunked.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=64, kv_chunk=64, q_offset=jnp.asarray(q_offset, jnp.int32))
    got = chunked_attention(_t(q), _t(k), _t(v), causal=True,
                            q_offset=q_offset)
    assert got.shape == (2, S, 4, 32)
    assert _rel(want, got.numpy()) <= TOL


def test_sequence_parallel_attention_refused(layer):
    """``sequence_parallel_attention`` is ported (ROADMAP item 11c-i):
    without a training group it is ``chunked_attention``.  MLA's
    sequence-parallel branch is ported too (item 11c-ii): on a training
    rank whose model line is one rank, ``mla.mesh_forward`` takes the
    whole arm and is ``mla_forward``'s output bitwise, and JAX's
    ``mla_apply`` within the layer limit."""
    from repro_torch.models import chunked_attention as ca
    from repro_torch.sharding.group import Line
    rng = np.random.RandomState(5)
    q, k, v = (torch.as_tensor(rng.randn(2, 24, 4, 16), dtype=torch.float32)
               for _ in range(3))
    assert torch.equal(
        sequence_parallel_attention(q, k, v, causal=True, window=0,
                                    flags=None),
        chunked_attention(q, k, v, causal=True))
    cfg, jcfg, jp, tp = layer
    x, pos = _x(cfg, 2, 11, 2), _pos(2, 11)
    one = Line("model", [0], 0, None, None)
    flags = dataclasses.replace(FLAGS, train=types.SimpleNamespace(model=one))
    ca.ARMS.clear()
    got = mla.mesh_forward(tp, cfg, _t(x), _t(pos), flags)
    assert dict(ca.ARMS) == {"whole": 1}
    assert torch.equal(got, mla.mla_forward(tp, cfg, _t(x), _t(pos),
                                            FLAGS)[0])
    jy, _ = jax_mla.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    assert _rel(jy, got.numpy()) <= TOL


def test_prefill_matches_jax(layer):
    """``mla_apply`` without a cache, and ``mla_prefill_into_cache``: the
    output and the latents written at [0, S), zero beyond."""
    cfg, jcfg, jp, tp = layer
    x, pos = _x(cfg, 2, 11, 1), _pos(2, 11)
    jy, _ = jax_mla.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, _, _ = mla.mla_forward(tp, cfg, _t(x), _t(pos), FLAGS)
    assert _rel(jy, ty.numpy()) <= TOL
    jy2, jc = jax_mla.mla_prefill_into_cache(jp, jcfg, jnp.asarray(x),
                                             jnp.asarray(pos), 16)
    cache = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype),
                     mla.abstract_mla_cache(cfg, 2, 16))
    ty2 = mla.prefill_into_cache(tp, cfg, _t(x), _t(pos), cache, FLAGS)
    assert _rel(jy2, ty2.numpy()) <= TOL
    for key in ("c_kv", "k_rope"):
        assert _rel(jc[key], cache[key].numpy()) <= 1e-6
        assert not cache[key][:, 11:].any()


def _slot_cache(cfg, B, T, seed):
    """A slot latent cache [B, T, ...] of random values."""
    rng = np.random.RandomState(seed)
    return {"c_kv": rng.randn(B, T, cfg.kv_lora_rank).astype(np.float32),
            "k_rope": rng.randn(B, T, cfg.qk_rope_head_dim).astype(
                np.float32)}


@pytest.mark.parametrize("Sq", [1, 5])
def test_slot_decode_matches_jax(layer, Sq):
    cfg, jcfg, jp, tp = layer
    B, T = 3, 16
    pos = np.array([4, 9, 0], np.int32)
    x = _x(cfg, B, Sq, 2 + Sq)
    c0 = _slot_cache(cfg, B, T, 4)
    positions = pos[:, None] + np.arange(Sq, dtype=np.int32)
    jy, jc = jax_mla.mla_apply(jp, jcfg, jnp.asarray(x),
                               jnp.asarray(positions),
                               jax.tree.map(jnp.asarray, c0),
                               jnp.asarray(pos))
    tc = _tensors(c0)
    ty = mla.slot_decode(tp, cfg, _t(x), tc, _t(pos), FLAGS)
    assert _rel(jy, ty.numpy()) <= TOL
    for key in c0:
        assert _rel(jc[key], tc[key].numpy()) <= 1e-6


def _paged(cfg, c0, bs):
    """The slot cache ``c0`` [B, T, ...] as a paged arena with a shuffled
    table (trash block 0 holding noise): (arena, tables)."""
    B, T = c0["c_kv"].shape[:2]
    P = T // bs
    order = 1 + np.random.RandomState(7).permutation(B * P)
    tables = order.reshape(B, P).astype(np.int32)
    arena = {}
    for key, a in c0.items():
        blocks = np.random.RandomState(8).randn(
            1 + B * P, bs, a.shape[-1]).astype(np.float32)
        blocks[tables.reshape(-1)] = a.reshape(B * P, bs, -1)
        arena[key] = blocks
    return arena, tables


@pytest.mark.parametrize("Sq", [1, 5])
def test_paged_decode_matches_jax_and_slot(layer, Sq):
    """``_mla_paged_decode`` against JAX's, and bitwise the port's slot
    decode on the same rows; the arena's blocks hold the slot rows."""
    cfg, jcfg, jp, tp = layer
    B, T, bs = 3, 16, 4
    pos = np.array([4, 9, 0], np.int32)
    x = _x(cfg, B, Sq, 5 + Sq)
    c0 = _slot_cache(cfg, B, T, 6)
    arena, tables = _paged(cfg, c0, bs)
    positions = pos[:, None] + np.arange(Sq, dtype=np.int32)
    jy, ja = jax_mla.mla_apply(jp, jcfg, jnp.asarray(x),
                               jnp.asarray(positions),
                               jax.tree.map(jnp.asarray, arena),
                               jnp.asarray(pos),
                               block_tables=jnp.asarray(tables))
    ta = _tensors(arena)
    ty = mla.paged_decode(tp, cfg, _t(x), ta, _t(pos), _t(tables), FLAGS)
    assert _rel(jy, ty.numpy()) <= TOL
    for key in arena:
        assert _rel(ja[key], ta[key].numpy()) <= 1e-6
    ts = _tensors(c0)
    ys = mla.slot_decode(tp, cfg, _t(x), ts, _t(pos), FLAGS)
    assert torch.equal(ty, ys)
    for key in c0:
        assert torch.equal(paging.gather_pages(ta[key], _t(tables)),
                           ts[key])


def test_extend_matches_jax_and_cold_prefill(layer):
    """``mla_prefill_extend`` against JAX's; the suffix's outputs and
    latents are bitwise the cold prefill's rows."""
    cfg, jcfg, jp, tp = layer
    S, P = 13, 5
    x, pos = _x(cfg, 2, S, 9), _pos(2, S)
    cold, c_kv, k_rope = mla.mla_forward(tp, cfg, _t(x), _t(pos), FLAGS)
    prefix = {"c_kv": c_kv[:, :P], "k_rope": k_rope[:, :P]}
    jy, jc = jax_mla.mla_prefill_extend(
        jp, jcfg, jnp.asarray(x[:, P:]), jnp.asarray(pos[:, P:]),
        {k: jnp.asarray(v.numpy()) for k, v in prefix.items()}, P, 16)
    ty, tc = mla.prefill_extend_into_cache(tp, cfg, _t(x[:, P:]),
                                           _t(pos[:, P:]), prefix, P, FLAGS)
    assert _rel(jy, ty.numpy()) <= TOL
    assert _rel(np.asarray(jc["c_kv"])[:, :S - P], tc["c_kv"].numpy()) \
        <= 1e-6
    assert torch.equal(ty, cold[:, P:])
    assert torch.equal(tc["c_kv"], c_kv[:, P:])
    assert torch.equal(tc["k_rope"], k_rope[:, P:])


@pytest.mark.parametrize("Sq", [1, 5])
def test_absorbed_decode_equals_materialised(layer, Sq):
    """The weight-absorbed decode over latents computes the attention
    of the materialised per-head K/V: a window decoded after a prefix
    equals the prefill's rows at those positions."""
    cfg, _, _, tp = layer
    S = 12
    x, pos = _x(cfg, 2, S, 11), _pos(2, S)
    want, c_kv, k_rope = mla.mla_forward(tp, cfg, _t(x), _t(pos), FLAGS)
    start = S - Sq
    cache = {"c_kv": torch.zeros(2, 16, cfg.kv_lora_rank),
             "k_rope": torch.zeros(2, 16, cfg.qk_rope_head_dim)}
    cache["c_kv"][:, :start] = c_kv[:, :start]
    cache["k_rope"][:, :start] = k_rope[:, :start]
    got = mla.slot_decode(tp, cfg, _t(x[:, start:]), cache,
                          torch.full((2,), start, dtype=torch.int32), FLAGS)
    assert _rel(want[:, start:].numpy(), got.numpy()) <= TOL


@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_row_alone_bitwise_its_row_of_the_batch(layer, kind, Sq):
    cfg, _, _, tp = layer
    B, T, bs = 3, 16, 4
    pos = np.array([4, 9, 2], np.int32)
    x = _x(cfg, B, Sq, 12)
    c0 = _slot_cache(cfg, B, T, 13)

    def run(rows):
        c = {k: v[rows] for k, v in c0.items()}
        if kind == "slot":
            return mla.slot_decode(tp, cfg, _t(x[rows]), _tensors(c),
                                   _t(pos[rows]), FLAGS)
        arena, tables = _paged(cfg, c, bs)
        return mla.paged_decode(tp, cfg, _t(x[rows]), _tensors(arena),
                                _t(pos[rows]), _t(tables), FLAGS)

    batch = run(np.arange(B))
    for b in range(B):
        assert torch.equal(run(np.array([b])), batch[b:b + 1]), b


# ---------------------------------------------------------------------------
# the whole reduced model against JAX
# ---------------------------------------------------------------------------

class DeepseekPair:
    """A JAX engine and the port's engine holding the same weights, and
    the port's plain path in f64 on them."""

    def __init__(self):
        self.cfg, self.jcfg = _cfgs()
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=0)
        self.np_params = jax.tree.map(np.asarray, self.jax.params)
        self.port = LLMEngine(self.cfg, params_from_jax(self.np_params,
                                                        self.cfg),
                              max_len=MAX_LEN, device="cpu")
        cfg64 = dataclasses.replace(self.cfg, dtype="float64")
        self.exact = LLMEngine(
            cfg64, params_from_jax(jax.tree.map(
                lambda a: a.astype(np.float64), self.np_params), cfg64),
            max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return DeepseekPair()


def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(jl, tl, cfg):
    real = slice(0, cfg.vocab_size)
    return np.abs(np.asarray(jl)[..., real] - tl[..., real].numpy()).max()


def test_params_carry_head_layers_and_mtp(pair):
    """``params_from_jax`` carries the dense head, the MoE block and the
    MTP head under the reference's paths."""
    sd = pair.port.model.state_dict()
    assert set(sd) == set(flatten(pair.np_params))
    cfg = pair.cfg
    assert tuple(sd["head_layers.layer0.mixer.wq_b"].shape) == (
        cfg.q_lora_rank, cfg.num_heads,
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    assert tuple(sd["head_layers.layer0.ffn.w_gate"].shape) == (
        cfg.d_model, cfg.dense_d_ff)
    assert tuple(sd["blocks.l0.ffn.w_gate"].shape)[:2] == (
        1, moe.padded_experts(cfg))
    assert "blocks.l0.ffn.shared.w_gate" in sd
    assert tuple(sd["mtp.proj"].shape) == (2 * cfg.d_model, cfg.d_model)
    for path, a in flatten(pair.np_params).items():
        assert np.array_equal(sd[path].numpy(), a), path


def test_logits_match_jax(pair):
    """Prefill, decode (S' = 1), verify (S' = 3) and a slot-prefix extend
    of the same two prompts: logits within 1e-4 of JAX's."""
    cfg, je, model = pair.cfg, pair.jax, pair.port.model
    toks = _prompts(cfg, 2, 8, 0)
    jl, jc = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN)
    tl, tc = model.prefill(torch.as_tensor(toks).long(), MAX_LEN)
    assert _close(jl, tl, cfg) <= 1e-4
    pos = np.full(2, 8, np.int32)
    for width in (1, 3):
        win = _prompts(cfg, 2, width, 1)
        jw, _ = je.model.decode_step(je.params, jnp.asarray(win), jc,
                                     jnp.asarray(pos), all_logits=True)
        tw, _ = model.decode_step(torch.as_tensor(win).long(),
                                  tree_map(lambda a: a.clone(), tc),
                                  torch.as_tensor(pos), all_logits=True)
        assert tw.shape == (2, width, cfg.padded_vocab)
        assert _close(jw, tw, cfg) <= 1e-4
    suffix = toks[:, 4:]
    jx, _ = je.model.prefill_extend(
        je.params, jnp.asarray(suffix), jc,
        jax_paging.SlotPrefix(slots=jnp.arange(2, dtype=jnp.int32)), 4,
        MAX_LEN)
    tx, _ = model.prefill_extend(
        torch.as_tensor(suffix).long(), tc,
        paging.SlotPrefix(slots=torch.arange(2)), 4, MAX_LEN)
    assert _close(jx, tx, cfg) <= 1e-4
    assert torch.equal(tx, tl)          # the suffix ends the prompt


def test_mtp_logits_match_jax(pair):
    cfg = pair.cfg
    toks = _prompts(cfg, 2, 8, 2)
    hidden = np.random.RandomState(3).randn(2, 8, cfg.d_model).astype(
        np.float32)
    want = jax_tf.mtp_logits(pair.jax.params, pair.jcfg, jnp.asarray(hidden),
                             jnp.asarray(toks))
    got = pair.port.model.mtp_logits(_t(hidden), torch.as_tensor(toks).long())
    assert got.shape == (2, 8, cfg.padded_vocab)
    assert _close(want, got, cfg) <= 1e-4


def test_generate_matches_jax(pair):
    toks = _prompts(pair.cfg, 2, 7, 4)
    n = 8
    want = pair.jax.generate(toks, n)
    got = pair.port.generate(toks, n)
    model = pair.port.model
    logits, cache = model.prefill(torch.as_tensor(toks).long(), MAX_LEN)
    steps = [logits]
    for i in range(n - 1):
        pos = torch.full((2,), toks.shape[1] + i, dtype=torch.int32)
        logits, cache = model.decode_step(
            torch.as_tensor(want[:, i:i + 1]).long(), cache, pos)
        steps.append(logits)
    assert_tokens(want, got, torch.stack(steps, dim=1))
    np.testing.assert_array_equal(got, want)


def _mla_arena(cache, to_numpy):
    """A paged cache without trash block 0 (its content is unspecified):
    axis 0 of a head layer's leaf, axis 1 of a stacked one."""
    return {path: to_numpy(a)[:, 1:] if path.startswith("blocks.")
            else to_numpy(a)[1:] for path, a in flatten(cache).items()}


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_serving_sequence_matches_jax(pair, layout):
    """prefill -> insert (-> extend on the paged arena) -> decode ->
    verify through the engines: JAX's tokens, caches at the f32 floor."""
    run = _serve if layout == "slot" else _serve_paged
    jlog, tlog, xlog = [], [], []
    jcache = run(pair.jax, pair.jcfg, jlog)
    tcache = run(pair.port, pair.cfg, tlog)
    xcache = run(pair.exact, pair.cfg, xlog)
    assert [k for k, _ in jlog] == [k for k, _ in tlog]
    for (kind, want), (_, got) in zip(jlog, tlog):
        if not np.array_equal(want, got):
            pytest.fail(f"{kind}: port tokens {got} != JAX tokens {want}")
    if layout == "paged":
        jcache, tcache, xcache = (
            _mla_arena(jax.tree.map(np.asarray, jcache), np.asarray),
            _mla_arena(tcache, lambda t: t), _mla_arena(xcache, lambda t: t))
    assert_cache_close(jcache, tcache, xcache)


# ---------------------------------------------------------------------------
# serving with no call that can drop: exact against generate
# ---------------------------------------------------------------------------

#: prompt lengths of the served requests, each starting with the same
#: 8 tokens (two blocks of 4 for prefix sharing): every prefill (chunks
#: of 8, or a whole prompt in ``generate``) has 1-8 or 13-16 tokens, and
#: 2 slots' verify windows of up to 1 + SPEC tokens hold at most 8
LENGTHS = [14, 5, 16, 13, 8, 15]
SHARED = 8
SLOTS = 2
SPEC = 3
MAX_NEW = 10


@pytest.fixture
def calls(monkeypatch):
    """The token counts of the ``moe_apply`` calls made while the test
    ran; the test holds each to a capacity that no expert can overflow."""
    seen = set()
    apply = moe.moe_apply

    def recorded(params, cfg, x, flags=None):
        seen.add(x.shape[0] * x.shape[1])
        return apply(params, cfg, x, flags)

    monkeypatch.setattr(moe, "moe_apply", recorded)
    yield seen
    cfg = get_config(ARCH).reduced()
    assert seen and all(moe.capacity(cfg, n) >= n for n in seen), seen


def _requests(cfg):
    rng = np.random.RandomState(40)
    prefix = rng.randint(0, cfg.vocab_size, SHARED)
    return [np.concatenate([prefix, rng.randint(0, cfg.vocab_size,
                                                n - SHARED)])
            .astype(np.int32) if n > SHARED else prefix[:n].astype(np.int32)
            for n in LENGTHS]


def _sched(engine, kind, draft_fn, slot_cls=SlotBackend,
           paged_cls=PagedBackend, sched_cls=Scheduler):
    """2 slots, chunks of 8, speculate 3; the paged arena (blocks of 4,
    prefix sharing) tight enough that pressure preempts."""
    be = paged_cls(engine, SLOTS, num_blocks=12, block_size=4) \
        if kind == "paged" else slot_cls(engine, SLOTS)
    return sched_cls(be, max_new_tokens=MAX_NEW, chunk_size=8,
                     speculate_k=SPEC, draft_fn=draft_fn)


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


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_scheduler_matches_generate_and_jax(pair, calls, kind):
    port = pair.port
    prompts = _requests(pair.cfg)
    draft = oracle_draft_fn(port, prompts, MAX_NEW, 2,
                            np.random.RandomState(3))
    sched = _sched(port, kind, draft)
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(sched)
    got = drain(sched)
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["replayed_tokens"] > 0
    assert sched.stats["spec_accepted"] > 0
    assert sched.stats["chunked_prefill_ticks"] > 0
    if kind == "paged":
        assert sched.stats["shared_block_hits"] > 0
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], port.generate(p[None], MAX_NEW)[0],
            err_msg=f"request {i} against generate")

    # the JAX Scheduler on the same weights and schedule
    jsched = _sched(pair.jax, kind, draft, JaxSlot, JaxPaged, JaxScheduler)
    for i, p in enumerate(prompts):
        jsched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(jsched)
    want = drain(jsched)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"request {i} against JAX")


def test_graphserver_matches_scheduler(pair, calls):
    """The port's ``GraphServer`` on a paged arena (chunks of 8,
    speculation, prefix sharing) gives ``generate``'s tokens, which the
    Scheduler gives (above)."""
    prompts = _requests(pair.cfg)[:4]
    kw = dict(num_slots=2, max_new_tokens=6, backend="paged",
              chunk_size=8, speculate_k=2, num_blocks=33, block_size=8)
    with GraphServer(pair.port, **kw) as srv:
        got = [h.result(timeout=120)
               for h in [srv.submit(p) for p in prompts]]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], pair.port.generate(p[None], 6)[0],
            err_msg=f"request {i} against generate")


@pytest.mark.parametrize("extra", [[], ["--paged", "--speculate", "2",
                                        "--chunk-size", "8"]],
                         ids=["slot", "paged_spec"])
def test_launcher_serves_deepseek(extra, capsys):
    argv = ["--device", "cpu", "--arch", ARCH, "--requests", "4",
            "--clients", "2", "--max-new-tokens", "4"]
    assert launcher.main(argv + extra) == 0
    assert "served 4/4 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the engine's MLA rules
# ---------------------------------------------------------------------------

def test_kernel_path_is_fallback_for_mla():
    cfg, _ = _cfgs()
    for flags in (RuntimeFlags(), RuntimeFlags(use_fused_decode=False)):
        assert kernel_path(cfg, flags) == "fallback"


def test_refusals():
    """As in JAX, ``use_paged_kernel`` with MLA is refused on a paged
    arena (the paged and hybrid layouts); MLA is served on the state and
    hybrid layouts since ROADMAP Queue 1 item 15
    (``test_torch_mla_layouts.py``); and the expert-parallel MoE stays
    refused."""
    cfg, _ = _cfgs()
    engine = LLMEngine(cfg, max_len=16, device="cpu",
                       flags=RuntimeFlags(use_paged_kernel=True))
    for kind in ("paged", "hybrid"):
        with pytest.raises(ValueError, match="use_paged_kernel covers"):
            engine.new_cache(types.SimpleNamespace(
                kind=kind, num_slots=2, num_blocks=9, block_size=4))
    engine = LLMEngine(cfg, max_len=16, device="cpu")
    assert Scheduler(StateBackend(engine, 2)).backend.kind == "state"
    for kind in ("state", "hybrid"):
        engine.check_extend_support(kind)
        engine.check_spec_support(kind)
        cache = engine.new_cache(types.SimpleNamespace(
            kind=kind, num_slots=2, num_blocks=9, block_size=4))
        assert cache["head_layers"]["layer0"]["mixer"]["c_kv"].shape[:2] \
            == ((2, 16) if kind == "state" else (9, 4))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        LLMEngine(cfg, max_len=16, device="cpu",
                  flags=RuntimeFlags(moe_impl="ep"))
