"""Sliding-window attention in the port (ROADMAP item 12) against the JAX
package on the CPU at f32, on the same weights (``params_from_jax``) and
numpy-seeded inputs, one torch thread.

* The layers: the GQA and MLA windowed prefill caches (``min(max_len,
  window)`` slots, the prompt's last positions rotated to slot ``p %
  size``) equal JAX's rolled caches, and the windowed decode, stepped
  far past the window, matches JAX's gather path step by step (outputs
  and caches), within 1e-5 of their scale; a windowed row decoded alone
  is bitwise its row of the batch; a verify window over a window is
  refused with JAX's message.
* The engines, on every reduced architecture with attention layers at
  window 16: ``generate`` equals JAX's tokens with prompts that cross
  the window at prefill and during decode; the Scheduler on the slot
  layout (the state layout for jamba's hybrid stack), 2 slots and one
  forced preemption, streams tokens bitwise the port's own ``generate``
  of each request alone and equal to JAX's; the abstract caches have
  JAX's shapes.  What JAX refuses of a window (the paged and hybrid
  layouts, extend, speculation) the port refuses with the same
  exception type and message.
* Tensor parallelism: at tp 2 (tp 4 for the sequence arm) every arm,
  kv heads, head_dim, the sequence and MLA's lora cut, serves windowed
  requests through the Scheduler with JAX's unsharded tokens.  The
  ranks run in one subprocess, ``tests/_torch_window_battery.py``.
* Training: ``make_train_step`` with a window matches JAX's without a
  mesh (loss at 1e-4, the gradient norm at 1e-3).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.optim import make_schedule as jax_make_schedule  # noqa: E402
from repro.runtime.steps import make_train_step as jax_train_step  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro.serving import Scheduler as JaxScheduler  # noqa: E402
from repro.serving.kvcache import (HybridBackend as JaxHybrid,  # noqa: E402
                                   PagedBackend as JaxPaged,
                                   SlotBackend as JaxSlot)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (flatten, params_from_jax,  # noqa: E402
                                       tree_map)
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.optim import make_schedule  # noqa: E402
from repro_torch.runtime.steps import (kernel_path,  # noqa: E402
                                       make_train_step)
from repro_torch.serving import (HybridBackend, LLMEngine,  # noqa: E402
                                 PagedBackend, Scheduler, SlotBackend,
                                 StateBackend)
from repro_torch.serving.engine import check_tp_support  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_serving import drain  # noqa: E402
from _torch_window_battery import ARMS  # noqa: E402

FLAGS = RuntimeFlags()
#: the layer-level limit, relative to the output's scale
TOL = 1e-5
WINDOW = 16
MAX_LEN = 64
#: every architecture with attention layers (xlstm_1_3b has none)
ARCHS = ["minicpm_2b", "qwen3_32b", "stablelm_12b", "deepseek_7b",
         "granite_moe_3b_a800m", "deepseek_v3_671b", "phi_3_vision_4_2b",
         "jamba_1_5_large_398b", "seamless_m4t_large_v2"]


def _cfgs(name, **kw):
    kw.setdefault("sliding_window", WINDOW)
    return (dataclasses.replace(get_config(name).reduced(), **kw),
            dataclasses.replace(jax_get_config(name).reduced(), **kw))


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    return np.abs(want - got).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _tensors(np_tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in np_tree.items()}


# ---------------------------------------------------------------------------
# the layers against JAX
# ---------------------------------------------------------------------------

#: the layers' window (smaller than the prompts, so that prefill rotates)
LAYER_WINDOW = 8
LAYER_MAX_LEN = 30


def _layer(kind):
    """(port cfg, JAX cfg, JAX params, port params) of one attention
    (qwen3's GQA with qk-norm) or MLA layer at window 8."""
    arch = "qwen3_32b" if kind == "attn" else "deepseek_v3_671b"
    cfg, jcfg = _cfgs(arch, sliding_window=LAYER_WINDOW)
    tmpl = jax_attn.attention_template(jcfg) if kind == "attn" \
        else jax_mla.mla_template(jcfg)
    jp = jax_init(tmpl, jax.random.PRNGKey(7), "float32")
    return cfg, jcfg, jp, _tensors(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=["attn", "mla"])
def layer(request):
    return (request.param,) + _layer(request.param)


def _x(cfg, B, S, seed):
    return (np.random.RandomState(seed).randn(B, S, cfg.d_model) * 0.3
            ).astype(np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(start + np.arange(S, dtype=np.int32), (B, S))


def _port_cache(kind, cfg, B):
    if kind == "attn":
        shape = attn.kv_cache_shape(cfg, B, LAYER_MAX_LEN)
        return {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    return tree_map(lambda a: torch.zeros(a.shape),
                    mla.abstract_mla_cache(cfg, B, LAYER_MAX_LEN))


def _jax_prefill(kind, jp, jcfg, x, pos):
    if kind == "attn":
        return jax_attn.prefill_into_cache(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), LAYER_MAX_LEN)
    return jax_mla.mla_prefill_into_cache(jp, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), LAYER_MAX_LEN)


def _port_prefill(kind, tp, cfg, x, pos, cache):
    into = attn.prefill_into_cache if kind == "attn" \
        else mla.prefill_into_cache
    return into(tp, cfg, _t(x), _t(pos).long(), cache, FLAGS)


def _jax_decode(kind, jp, jcfg, x, pos, cache, cache_pos):
    apply = jax_attn.attention_apply if kind == "attn" else jax_mla.mla_apply
    return apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), cache,
                 jnp.asarray(cache_pos))


def _port_decode(kind, tp, cfg, x, cache, pos):
    if kind == "attn":
        return attn.window_decode(tp, cfg, _t(x), cache, _t(pos), FLAGS)
    return mla.slot_decode(tp, cfg, _t(x), cache, _t(pos), FLAGS)


@pytest.mark.parametrize("S", [5, 8, 23])
def test_prefill_cache_matches_jax_rolled(layer, S):
    """A prompt shorter than, equal to and longer than the window: the
    block's output and the cache (padded, or the last ``size``
    positions rolled) equal JAX's."""
    kind, cfg, jcfg, jp, tp = layer
    x, pos = _x(cfg, 2, S, S), _pos(2, S)
    jy, jc = _jax_prefill(kind, jp, jcfg, x, pos)
    cache = _port_cache(kind, cfg, 2)
    y = _port_prefill(kind, tp, cfg, x, pos, cache)
    assert _rel(jy, y) <= TOL
    for key, a in jc.items():
        assert tuple(cache[key].shape) == a.shape
        assert a.shape[1] == LAYER_WINDOW
        assert _rel(a, cache[key]) <= TOL, key
    if S > LAYER_WINDOW:          # position S - 1 sits in its slot
        key = "k" if kind == "attn" else "c_kv"
        assert cache[key][:, (S - 1) % LAYER_WINDOW].abs().max() > 0


def test_decode_wraps_like_jax(layer):
    """Rows at different positions (a 12-token prefill, then row 1 held
    back 3 steps) decode 22 steps each, far past the window: each step's
    output and the final cache equal JAX's gather path."""
    kind, cfg, jcfg, jp, tp = layer
    B, S0, total = 2, 12, 40
    x = _x(cfg, B, total, 3)
    jy, jc = _jax_prefill(kind, jp, jcfg, x[:, :S0], _pos(B, S0))
    cache = _port_cache(kind, cfg, B)
    _port_prefill(kind, tp, cfg, x[:, :S0], _pos(B, S0), cache)
    at = np.array([S0, S0], np.int32)
    for step in range(25):
        if step == 3:
            at[1] = S0                     # row 1 starts late
        xs = np.stack([x[b, at[b]:at[b] + 1] for b in range(B)])
        jout, jc = _jax_decode(kind, jp, jcfg, xs, at[:, None], jc, at)
        out = _port_decode(kind, tp, cfg, xs, cache, at)
        assert _rel(jout, out) <= TOL, (step, at)
        at = at + 1
    assert at.min() > LAYER_WINDOW + S0
    for key, a in jc.items():
        assert _rel(a, cache[key]) <= TOL, key


def test_decode_matches_full_forward(layer):
    """The windowed decode against JAX's full windowed forward (the
    naive mask for GQA, MLA's chunked prefill arm) at every position."""
    kind, cfg, jcfg, jp, tp = layer
    B, S0, total = 1, 10, 30
    x = _x(cfg, B, total, 5)
    pos = _pos(B, total)
    if kind == "attn":
        full, _ = jax_attn.attention_apply(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), impl="naive")
    else:
        full, _ = jax_mla.mla_apply(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))
    full = np.asarray(full)
    cache = _port_cache(kind, cfg, B)
    _port_prefill(kind, tp, cfg, x[:, :S0], pos[:, :S0], cache)
    for t in range(S0, total):
        out = _port_decode(kind, tp, cfg, x[:, t:t + 1], cache,
                           np.array([t], np.int32))
        assert np.abs(full[:, t:t + 1] - out.numpy()).max() <= \
            10 * TOL * np.abs(full).max(), t


def test_row_alone_bitwise_its_row_of_the_batch(layer):
    kind, cfg, jcfg, jp, tp = layer
    B, S0 = 3, 11
    x = _x(cfg, B, S0 + 1, 9)
    cache = _port_cache(kind, cfg, B)
    _port_prefill(kind, tp, cfg, x[:, :S0], _pos(B, S0), cache)
    at = np.array([S0, 4, S0], np.int32)
    base = tree_map(lambda a: a.clone(), cache)
    batch = _port_decode(kind, tp, cfg, x[:, S0:], cache, at)
    for b in range(B):
        alone = {k: a[b:b + 1].clone() for k, a in base.items()}
        out = _port_decode(kind, tp, cfg, x[b:b + 1, S0:], alone, at[b:b + 1])
        assert torch.equal(out, batch[b:b + 1]), b
        for k, a in alone.items():
            assert torch.equal(a, cache[k][b:b + 1]), (b, k)


def test_stray_row_writes_nothing(layer):
    """A row at position -1 (a replay call's stray row on a windowed
    engine, ``SlotBackend._stray_position``) leaves its slots as they
    were; the live row beside it decodes as it does alone."""
    kind, cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 21, 11)
    cache = _port_cache(kind, cfg, 2)
    _port_prefill(kind, tp, cfg, x[:, :20], _pos(2, 20), cache)
    before = tree_map(lambda a: a.clone(), cache)
    out = _port_decode(kind, tp, cfg, x[:, 20:], cache,
                       np.array([20, -1], np.int32))
    for k, a in cache.items():
        assert torch.equal(a[1], before[k][1]), k
    alone = {k: a[:1].clone() for k, a in before.items()}
    assert torch.equal(_port_decode(kind, tp, cfg, x[:1, 20:], alone,
                                    np.array([20], np.int32)), out[:1])


def test_verify_window_refused_as_in_jax(layer):
    kind, cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 3, 13)
    cache = _port_cache(kind, cfg, 2)
    at = np.array([4, 4], np.int32)
    with pytest.raises(ValueError) as port_err:
        _port_decode(kind, tp, cfg, x, cache, at)
    jc = jax.tree.map(lambda a: jnp.asarray(a.numpy()), cache)
    with pytest.raises(ValueError) as jax_err:
        _jax_decode(kind, jp, jcfg, x, at[:, None] + np.arange(3), jc, at)
    assert str(port_err.value) == str(jax_err.value) == attn.WINDOW_VERIFY


# ---------------------------------------------------------------------------
# the engines against JAX, on every reduced architecture with attention
# ---------------------------------------------------------------------------

class WindowPair:
    """A JAX engine and the port's engine on the same weights, window 16."""

    def __init__(self, name):
        self.cfg, self.jcfg = _cfgs(name)
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=0)
        self.np_params = jax.tree.map(np.asarray, self.jax.params)
        self.port = LLMEngine(self.cfg, params_from_jax(self.np_params,
                                                        self.cfg),
                              max_len=MAX_LEN, device="cpu")


_PAIRS = {}


def pair_of(name):
    if name not in _PAIRS:
        _PAIRS[name] = WindowPair(name)
    return _PAIRS[name]


def _prompts(cfg, lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_jax(name):
    """Prompts of 21 tokens (past the window at prefill) and of 9
    (crossing it during decode), 14 new tokens: JAX's tokens."""
    p = pair_of(name)
    for S, seed in ((21, 0), (9, 1)):
        toks = np.stack(_prompts(p.cfg, (S, S), seed))
        want = p.jax.generate(toks, 14)
        got = p.port.generate(toks, 14)
        np.testing.assert_array_equal(got, want, err_msg=f"S={S}")


@pytest.mark.parametrize("name", ARCHS)
def test_cache_shapes_match_jax(name):
    """The slot rows hold ``min(max_len, window)`` positions, as JAX's
    abstract cache; a window wider than ``max_len`` holds ``max_len``."""
    for max_len in (MAX_LEN, 12):
        cfg, jcfg = _cfgs(name)
        want = {k: a.shape for k, a in flatten(jax.tree.map(
            lambda s: np.zeros(s.shape, np.int8),
            jax_tf.abstract_cache(jcfg, 2, max_len,
                                  8 if jcfg.is_encoder_decoder else 0))
        ).items()}
        got = {k: tuple(a.shape) for k, a in flatten(tf.abstract_cache(
            cfg, 2, max_len, 8 if cfg.is_encoder_decoder else 0)).items()}
        assert got == want
        rows = [s[-3 if k.endswith((".k", ".v")) else -2]
                for k, s in got.items()
                if k.endswith((".mixer.k", ".mixer.c_kv"))]
        assert rows and set(rows) == {min(max_len, WINDOW)}


#: served request lengths: past the window at prefill (21, 30) and
#: crossing it during decode (9, 12); all different, so that no two
#: prefill as one group
LENGTHS = (21, 9, 30, 12)
MAX_NEW = 12


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


@pytest.mark.parametrize("name", [n for n in ARCHS
                                  if n != "seamless_m4t_large_v2"])
def test_scheduler_matches_generate_and_jax(name):
    """2 slots (the slot layout; the state layout for jamba's hybrid
    stack), no chunking, no speculation, one forced preemption that
    replays through the decode step with the other row live: each
    request's tokens are bitwise the port's ``generate`` of it alone,
    and JAX's."""
    p = pair_of(name)
    prompts = _prompts(p.cfg, LENGTHS, 20)
    recurrent = set(p.cfg.layer_kinds()) != {"attn"}
    be = (StateBackend if recurrent else SlotBackend)(p.port, 2)
    sched = Scheduler(be, max_new_tokens=MAX_NEW)
    for i, pr in enumerate(prompts):
        sched.submit({"tokens": pr, "id": i})
    _preempt_one_mid_decode(sched)
    got = drain(sched)
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["replayed_tokens"] > 0
    for i, pr in enumerate(prompts):
        np.testing.assert_array_equal(
            got[i], p.port.generate(pr[None], MAX_NEW)[0],
            err_msg=f"request {i} against generate")
        np.testing.assert_array_equal(
            got[i], p.jax.generate(pr[None], MAX_NEW)[0],
            err_msg=f"request {i} against JAX")


def _raised(fn):
    try:
        fn()
    except Exception as err:          # the exception is the result
        return type(err), str(err)
    return None


#: what each engine is asked that JAX refuses of a window
REFUSALS = ("paged", "hybrid", "extend_slot", "extend_state",
            "extend_paged", "spec_slot", "spec_state", "spec_hybrid",
            "chunked", "verify")


def _refusal(e, case, slot_cls, paged_cls, hybrid_cls, sched_cls):
    if case == "verify":
        slot = sched_cls(slot_cls(e, 2)).backend      # binds its cache
        return lambda: e.verify(slot, slot.cache, np.ones((2, 3), np.int32),
                                np.array([5, 7], np.int32), np.ones(2, bool))
    return {
        "paged": lambda: sched_cls(paged_cls(e, 2, num_blocks=9,
                                             block_size=8)),
        "hybrid": lambda: sched_cls(hybrid_cls(e, 2, num_blocks=9,
                                               block_size=8)),
        "extend_slot": lambda: e.check_extend_support("slot"),
        "extend_state": lambda: e.check_extend_support("state"),
        "extend_paged": lambda: e.check_extend_support("paged"),
        "spec_slot": lambda: e.check_spec_support("slot"),
        "spec_state": lambda: e.check_spec_support("state"),
        "spec_hybrid": lambda: e.check_spec_support("hybrid"),
        "chunked": lambda: sched_cls(slot_cls(e, 2), chunk_size=8),
    }[case]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_match_jax(case):
    """The port refuses what JAX refuses of a window, with the same
    exception type and message."""
    p = pair_of("minicpm_2b")
    want = _raised(_refusal(p.jax, case, JaxSlot, JaxPaged, JaxHybrid,
                            JaxScheduler))
    got = _raised(_refusal(p.port, case, SlotBackend, PagedBackend,
                           HybridBackend, Scheduler))
    assert want is not None and want[0] is ValueError, want
    assert got == want


def test_window_is_served_without_refusal():
    """The window is no longer refused at construction; the slot and
    state layouts build, the decode takes the plain path (as JAX's
    ``use_fused_decode`` keeps windows out of its kernel), and a tp
    mesh cuts a row's positions only where the window's length divides
    the ranks."""
    cfg, _ = _cfgs("minicpm_2b")
    engine = LLMEngine(cfg, max_len=MAX_LEN, device="cpu")
    for kind in ("slot", "state"):
        cache = engine.new_cache(types.SimpleNamespace(kind=kind,
                                                       num_slots=2))
        assert cache["blocks"]["l0"]["mixer"]["k"].shape[2] == WINDOW
    assert kernel_path(cfg, FLAGS) == "fallback"
    seq = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3, head_dim=6,
                              sliding_window=18)
    check_tp_support(seq, 2, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="slot rows of 18"):
        check_tp_support(seq, 4, max_len=MAX_LEN)
    check_tp_support(dataclasses.replace(seq, sliding_window=16), 4,
                     max_len=MAX_LEN)


# ---------------------------------------------------------------------------
# tensor parallelism: every arm against JAX's unsharded tokens
# ---------------------------------------------------------------------------

_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_window_battery.py")


@pytest.fixture(scope="module")
def battery():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, _BATTERY], capture_output=True,
                          text=True, env=env, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("BATTERY ")]
    assert lines, (f"battery produced no verdict (rc={proc.returncode}):\n"
                   f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BATTERY "):])


@pytest.mark.parametrize("arm", list(ARMS))
def test_tp_window_serving_matches_jax(battery, arm):
    assert arm in battery, f"battery never ran {arm}: {sorted(battery)}"
    verdict = battery[arm]
    assert verdict["ok"], f"{arm}: {verdict['detail']}"


# ---------------------------------------------------------------------------
# training with a window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,optimizer", [("minicpm_2b", "adamw"),
                                            ("deepseek_v3_671b",
                                             "adafactor")])
def test_train_step_matches_jax(name, optimizer):
    """One train step at window 8 over 32 tokens (the JAX step under a
    plain ``jax.jit``, ROADMAP Hazard 2): loss and aux at 1e-4, the
    gradient norm at 1e-3, the learning rate equal."""
    cfg, jcfg = _cfgs(name, sliding_window=8)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    b = {k: rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
    sched = dict(peak_lr=1e-3, warmup=2, total=10)
    step, init = jax_train_step(
        jmodel, schedule=jax_make_schedule(jcfg.lr_schedule, **sched),
        optimizer=optimizer)
    _, jm = jax.jit(step)(init(jparams), b)
    model = Model(cfg, device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg))
    pstep, pinit = make_train_step(
        model, schedule=make_schedule(cfg.lr_schedule, **sched),
        optimizer=optimizer)
    _, m = pstep(pinit(model.params),
                 {k: torch.as_tensor(v).long() for k, v in b.items()})
    for k, tol in (("loss", 1e-4), ("total_loss", 1e-4), ("aux", 1e-4),
                   ("grad_norm", 1e-3)):
        want, got = float(jm[k]), float(m[k])
        assert abs(got - want) <= tol * max(abs(want), 1e-30), (k, got,
                                                               want)
    assert float(m["lr"]) == float(jm["lr"])
