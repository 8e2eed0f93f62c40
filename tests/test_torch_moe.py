"""The port's MoE FFN (repro_torch.models.moe, the ``gather`` dispatch)
and the MoE decoder it makes servable (granite_moe_3b_a800m, reduced:
4 experts, top-2) against the JAX package on the CPU at f32, on the
same weights (``params_from_jax``) and numpy-seeded inputs.

* ``route`` and ``moe_apply`` at N = 1-64 tokens: gates within 1e-6,
  expert indices equal (ties to the lower index, as ``jax.lax.top_k``),
  output within 1e-5 of its scale, aux within 1e-6; with a shared
  expert, with capacity drops, and with a zeroed router (every
  probability tied).
* Hazard 7 in both packages: where an expert overflows its capacity, a
  token's output depends on the other tokens of its call, and the port's
  outputs differ where JAX's do.
* The whole reduced model: logits of prefill, decode, verify and extend
  within 1e-4 of JAX's; the engine's serving sequences on both layouts
  with JAX's tokens and caches at the f32 floor.
* Serving where no call of N tokens has a capacity below N (so no
  expert can overflow: on reduced granite ``capacity`` is 8 for N <= 12
  and 16 for N = 13-16, so calls of 9-12 tokens can drop and the runs
  keep out of them): the Scheduler on slot rows and on a
  paged arena (chunked, speculative, preempted) gives the port's own
  ``generate`` tokens bitwise and the JAX Scheduler's under the top-2
  gap rule; the port's ``GraphServer`` gives the JAX ``GraphServer``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import paging as jax_paging  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serving import GraphServer as JaxServer  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import PagedBackend as JaxPaged  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving import SlotBackend as JaxSlot  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe, paging  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.serving import (GraphServer, LLMEngine,  # noqa: E402
                                 PagedBackend, Scheduler, SlotBackend)
from test_torch_engine import (JAX_KERNEL_FLAGS, MAX_LEN,  # noqa: E402
                               Pair, _serve, assert_cache_close,
                               assert_tokens, one_torch_thread)  # noqa: F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401
from test_torch_paged import _arena, _serve_paged  # noqa: E402
from test_torch_serving import drain, oracle_draft_fn  # noqa: E402

ARCH = "granite_moe_3b_a800m"
#: token counts of one call: decode at 1 and 4 slots, 16 (capacity 16),
#: 4 slots' verify windows of 5 (capacity 16), and a prefill chunk
NS = (1, 4, 16, 20, 64)


def _cfgs(**kw):
    return (dataclasses.replace(get_config(ARCH).reduced(), **kw),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **kw))


def _tensors(np_tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in np_tree.items()
            if not isinstance(v, dict)} | {
        k: _tensors(v) for k, v in np_tree.items() if isinstance(v, dict)}


def _layer(variant, seed=0):
    """(port cfg, JAX cfg, JAX params, port params) of one MoE layer."""
    kw = {"shared": {"num_shared_experts": 1},
          "capacity": {"capacity_factor": 0.1}}.get(variant, {})
    cfg, jcfg = _cfgs(**kw)
    jp = jax_init(jax_moe.moe_template(jcfg), jax.random.PRNGKey(seed),
                  "float32")
    if variant == "zero_router":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return cfg, jcfg, jp, _tensors(jax.tree.map(np.asarray, jp))


def _x(cfg, N, seed):
    return np.random.RandomState(seed).randn(1, N, cfg.d_model).astype(
        np.float32)


# ---------------------------------------------------------------------------
# route and moe_apply against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("variant", ["plain", "shared", "capacity",
                                     "zero_router"])
def test_moe_matches_jax(variant, N):
    cfg, jcfg, jp, tp = _layer(variant)
    x = _x(cfg, N, N)
    jg, ji, ja = jax_moe.route(jp, jcfg, jnp.asarray(x[0]))
    tg, ti, ta = moe.route(tp, cfg, torch.from_numpy(x[0]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.abs(tg.numpy() - np.asarray(jg)).max() <= 1e-6
    assert abs(float(ta) - float(ja)) <= 1e-6
    jo, ja = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    to, ta = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    jo, to = np.asarray(jo), to.numpy()
    assert to.shape == jo.shape == x.shape
    # expert weights drawn at the JAX rule's std (1/sqrt(experts)) make
    # outputs of ~1e3, whose f32 ulp is ~6e-5: the bound is relative
    assert np.abs(to - jo).max() <= 1e-5 * np.abs(jo).max()
    assert abs(float(ta) - float(ja)) <= 1e-6
    E_pad = moe.padded_experts(cfg)
    dropped = moe.count_dropped(ti, E_pad, moe.capacity(cfg, N))
    if variant == "capacity":
        # the same rows dropped by every expert are exactly zero in both
        zero_j = np.abs(jo[0]).max(-1) == 0
        np.testing.assert_array_equal(np.abs(to[0]).max(-1) == 0, zero_j)
        if N >= 20:
            assert dropped > 0
        if N == 64:
            assert zero_j.any()
    elif moe.capacity(cfg, N) >= N:
        assert dropped == 0                  # no expert can overflow
    if variant == "zero_router":
        # every probability ties: top-2 picks experts 0 and 1 for every
        # token, as jax.lax.top_k does
        assert (ti.numpy() == np.arange(2)).all()


def test_count_dropped_reads_overflow():
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    assert moe.count_dropped(idx, 4, 8) == 0
    assert moe.count_dropped(idx, 4, 2) == 2       # expert 0 holds 4
    assert moe.count_dropped(idx, 4, 1) == 4


def test_ep_impl_refused():
    cfg, _, _, tp = _layer("plain")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        moe.moe_apply(tp, cfg, x, RuntimeFlags(moe_impl="ep"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        LLMEngine(cfg, max_len=16, device="cpu",
                  flags=RuntimeFlags(moe_impl="ep"))


def test_dense_head_layers_refused():
    """A MoE stack with dense head layers (``first_k_dense``) is refused,
    not served without them; deepseek_v3 stays refused for MLA first."""
    cfg, _ = _cfgs(first_k_dense=1)
    with pytest.raises(NotImplementedError, match="first_k_dense.*item 8"):
        LLMEngine(cfg, max_len=16, device="cpu")
    from repro_torch.models.config import ArchConfig
    v3 = ArchConfig(**dataclasses.asdict(
        jax_get_config("deepseek_v3_671b").reduced()))
    with pytest.raises(NotImplementedError, match="MLA: ROADMAP Queue 1 "
                                                  "item 8"):
        LLMEngine(v3, max_len=16, device="cpu")


def test_hazard7_token_output_depends_on_its_call():
    """At N = 64 with capacity_factor 0.5, experts overflow: a token run
    alone (no drop) differs from the same token in the batch wherever
    the batch dropped one of its choices, in JAX and in the port alike."""
    cfg, jcfg = _cfgs(capacity_factor=0.5)
    jp = jax_init(jax_moe.moe_template(jcfg), jax.random.PRNGKey(5),
                  "float32")
    tp = _tensors(jax.tree.map(np.asarray, jp))
    x = _x(cfg, 64, 9)
    _, ti, _ = moe.route(tp, cfg, torch.from_numpy(x[0]))
    assert moe.count_dropped(ti, moe.padded_experts(cfg),
                             moe.capacity(cfg, 64)) > 0
    diff = {}
    for name, apply in (
            ("jax", lambda a: np.asarray(jax_moe.moe_apply(
                jp, jcfg, jnp.asarray(a))[0])),
            ("port", lambda a: moe.moe_apply(
                tp, cfg, torch.from_numpy(a))[0].numpy())):
        batch = apply(x)[0]
        alone = np.stack([apply(x[:, i:i + 1])[0, 0] for i in range(64)])
        diff[name] = np.abs(batch - alone).max(-1) > 1e-3 * np.abs(
            alone).max()
    assert diff["jax"].any()
    np.testing.assert_array_equal(diff["port"], diff["jax"])


# ---------------------------------------------------------------------------
# the whole reduced model against JAX
# ---------------------------------------------------------------------------

class GranitePair(Pair):
    """``test_torch_engine.Pair`` on reduced granite_moe_3b_a800m."""

    def __init__(self):
        self.cfg, self.jcfg = _cfgs()
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=0)
        self.jax_kernels = JaxEngine(self.jcfg, self.jax.params,
                                     max_len=MAX_LEN,
                                     flags=JAX_KERNEL_FLAGS)
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
    return GranitePair()


def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(jl, tl, cfg):
    real = slice(0, cfg.vocab_size)
    return np.abs(np.asarray(jl)[..., real] - tl[..., real].numpy()).max()


def test_state_dict_keys_are_jax_paths(pair):
    sd = pair.port.model.state_dict()
    for leaf in ("router", "w_gate", "w_up", "w_down"):
        assert f"blocks.l0.ffn.{leaf}" in sd
    E = moe.padded_experts(pair.cfg)
    assert tuple(sd["blocks.l0.ffn.w_gate"].shape) == (
        pair.cfg.num_layers, E, pair.cfg.d_model, pair.cfg.d_ff)
    assert tuple(sd["blocks.l0.ffn.router"].shape) == (
        pair.cfg.num_layers, pair.cfg.d_model, E)


@pytest.mark.parametrize("flags", ["default", "kernels"])
def test_logits_match_jax(pair, flags):
    """Prefill, decode (S' = 1), verify (S' = 3) and a slot-prefix extend
    of the same two prompts: logits within 1e-4 of JAX's."""
    cfg = pair.cfg
    je = pair.jax if flags == "default" else pair.jax_kernels
    model = pair.port.model
    toks = _prompts(cfg, 2, 16, 0)
    jl, jc = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                              flags=je.flags)
    tl, tc = model.prefill(torch.as_tensor(toks).long(), MAX_LEN)
    assert _close(jl, tl, cfg) <= 1e-4
    pos = np.full(2, 16, np.int32)
    for width in (1, 3):
        win = _prompts(cfg, 2, width, 1)
        jw, _ = je.model.decode_step(je.params, jnp.asarray(win), jc,
                                     jnp.asarray(pos), flags=je.flags,
                                     all_logits=True)
        tw, _ = model.decode_step(torch.as_tensor(win).long(), tc,
                                  torch.as_tensor(pos), all_logits=True)
        assert tw.shape == (2, width, cfg.padded_vocab)
        assert _close(jw, tw, cfg) <= 1e-4
    # the prompts' last 8 tokens again, against their first 8 as prefix
    suffix = toks[:, 8:]
    jx, _ = je.model.prefill_extend(
        je.params, jnp.asarray(suffix), jc,
        jax_paging.SlotPrefix(slots=jnp.arange(2, dtype=jnp.int32)), 8,
        MAX_LEN, flags=je.flags)
    tx, _ = model.prefill_extend(
        torch.as_tensor(suffix).long(), tc,
        paging.SlotPrefix(slots=torch.arange(2)), 8, MAX_LEN)
    assert _close(jx, tx, cfg) <= 1e-4
    assert _close(jx, tl, cfg) <= 1e-4         # the suffix ends the prompt


def test_generate_matches_jax(pair):
    toks = _prompts(pair.cfg, 2, 11, 1)
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
        jcache, tcache, xcache = (_arena(jcache, np.asarray),
                                  _arena(tcache, lambda t: t),
                                  _arena(xcache, lambda t: t))
    assert_cache_close(jcache, tcache, xcache)


# ---------------------------------------------------------------------------
# serving with no call that can drop: exact against generate
# ---------------------------------------------------------------------------

#: prompt lengths of the served requests: each prefill (chunks of 8, or
#: a whole prompt in ``generate``) has 1-8 or 13-16 tokens, and 2 slots'
#: verify windows of up to 1 + SPEC tokens hold at most 8
LENGTHS = [5, 14, 16, 7, 13, 6]
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


def _sched(engine, kind, draft_fn, slot_cls=SlotBackend,
           paged_cls=PagedBackend, sched_cls=Scheduler):
    """2 slots, chunks of 8, speculate 3; the paged arena tight enough
    that pressure preempts."""
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
    prompts = [p[0] for p in (_prompts(pair.cfg, 1, n, 40 + i)
                              for i, n in enumerate(LENGTHS))]
    draft = oracle_draft_fn(port, prompts, MAX_NEW, 2,
                            np.random.RandomState(3))
    sched = _sched(port, kind, draft)
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    _preempt_one_mid_decode(sched)
    got = drain(sched)
    assert sched.stats["preemptions"] >= (2 if kind == "paged" else 1)
    assert sched.stats["replayed_tokens"] > 0
    assert sched.stats["spec_accepted"] > 0
    assert sched.stats["chunked_prefill_ticks"] > 0
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
        # the port's logits along the JAX tokens (teacher forcing)
        logits, cache = port.model.prefill(torch.as_tensor(p[None]).long(),
                                           MAX_LEN)
        steps = [logits]
        for j in range(MAX_NEW - 1):
            pos = torch.full((1,), p.size + j, dtype=torch.int32)
            logits, cache = port.model.decode_step(
                torch.as_tensor(want[i][None, j:j + 1]).long(), cache, pos)
            steps.append(logits)
        assert_tokens(want[i][None], got[i][None],
                      torch.stack(steps, dim=1))


def test_graphserver_matches_jax_graphserver(pair, calls):
    prompts = [p[0] for p in (_prompts(pair.cfg, 1, n, 60 + i)
                              for i, n in enumerate((5, 14, 8, 16)))]
    kw = dict(num_slots=2, max_new_tokens=6, backend="paged",
              chunk_size=8, speculate_k=2, num_blocks=33, block_size=8)
    with JaxServer(pair.jax, **kw) as srv:
        want = [h.result(timeout=120)
                for h in [srv.submit(p) for p in prompts]]
    with GraphServer(pair.port, **kw) as srv:
        got = [h.result(timeout=120)
               for h in [srv.submit(p) for p in prompts]]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(
            got[i], pair.port.generate(p[None], 6)[0],
            err_msg=f"request {i} against generate")
