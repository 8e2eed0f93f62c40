"""The port's engine (repro_torch.serving.LLMEngine) against the JAX
package's on the same weights, on the CPU at reduced f32 sizes.

The weights cross through ``params_from_jax``; prompts are numpy-seeded.
Logits are held at 1e-4; greedy tokens must be equal wherever the port's
top-2 logit gap exceeds 1e-3 (a closer tie may flip under f32 reduction
order).  Caches are held at the f32 floor, read off an f64 run of the
port's plain path on the same weights (see ``assert_cache_close``).
"""
import ast
import dataclasses
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import RuntimeFlags as JaxFlags  # noqa: E402
from repro.serving import LLMEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import flatten, params_from_jax  # noqa: E402
from repro_torch.serving import LLMEngine  # noqa: E402

MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work: the suite runs
    several pytest workers side by side, and each torch process's own
    thread pool over every core slows the lot by an order of magnitude.
    The port's files that reuse this module's helpers import it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
GAP = 1e-3
JAX_KERNEL_FLAGS = JaxFlags(use_flash=True, fused_rmsnorm=True,
                            use_fused_decode=True)


def _small(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), **kw), \
        dataclasses.replace(jax_get_config(name).reduced(), **kw)


CONFIGS = {
    "minicpm": lambda: _small("minicpm_2b"),
    "qwen3": lambda: _small("qwen3_32b"),                 # qk-norm, GQA
    "minicpm_v1000": lambda: _small("minicpm_2b", vocab_size=1000),
}


class Pair:
    """A JAX engine (default or kernel flags) and the port's engine
    holding the same weights."""

    def __init__(self, name):
        self.cfg, self.jcfg = CONFIGS[name]()
        self.jax = JaxEngine(self.jcfg, max_len=MAX_LEN, seed=0)
        self.jax_kernels = JaxEngine(self.jcfg, self.jax.params,
                                     max_len=MAX_LEN,
                                     flags=JAX_KERNEL_FLAGS)
        self.np_params = jax.tree.map(np.asarray, self.jax.params)
        self.port = LLMEngine(self.cfg, params_from_jax(self.np_params,
                                                        self.cfg),
                              max_len=MAX_LEN, device="cpu")
        # the exact reference: the same weights through the plain path
        # in f64
        cfg64 = dataclasses.replace(self.cfg, dtype="float64")
        self.exact = LLMEngine(
            cfg64, params_from_jax(jax.tree.map(
                lambda a: a.astype(np.float64), self.np_params), cfg64),
            max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return Pair(request.param)


def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def assert_tokens(want, got, logits):
    """``got`` equals ``want`` wherever ``logits``' top-2 gap > GAP."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1] > GAP).numpy()
    want, got = np.asarray(want), np.asarray(got)
    assert sure.mean() > 0.5, "too many near-ties to compare"
    np.testing.assert_array_equal(want[sure], got[sure])


def assert_cache_close(jax_cache, port_cache, exact_cache):
    """Hold the port's f32 cache against the JAX one at the f32 floor.

    ``exact_cache`` is the f64 run.  For each layer of each leaf, the
    JAX cache must sit within 3e-5 of the layer's largest value from it
    (so the f64 run computes the JAX model), and the port's cache no
    further from it than twice the JAX cache sits.  A fixed absolute
    limit does not fit: on reduced minicpm (values up to 46) the JAX
    cache itself sits 2.7e-5 from the f64 run at layer 0 and 6.8e-4 at
    layer 1: without qk-norm, layer 0's softmax is peaked enough to turn
    the scores' f32 rounding into relative changes of about 1e-5, which
    layer 1 inherits.  The port sits 3.1e-5 and 1.1e-3 from it.  The
    readings print with ``pytest -rP``."""
    j, t = flatten(jax.tree.map(np.asarray, jax_cache)), flatten(port_cache)
    x = flatten(exact_cache)
    assert set(j) == set(t) == set(x)
    for path, a in j.items():
        b, ref = t[path].float().numpy(), x[path].numpy()
        assert a.shape == b.shape == ref.shape, path
        for r in range(a.shape[0]):                  # one layer group each
            scale = np.abs(ref[r]).max()
            e_jax = np.abs(a[r] - ref[r]).max()
            e_port = np.abs(b[r] - ref[r]).max()
            print(f"{path}[{r}]: scale {scale:.3g}, JAX {e_jax:.3g} and "
                  f"port {e_port:.3g} from the f64 run, "
                  f"{np.abs(a[r] - b[r]).max():.3g} apart")
            assert e_jax <= 3e-5 * scale, (path, r, e_jax, scale)
            assert e_port <= 2 * e_jax + 1e-6 * scale, (path, r, e_port,
                                                        e_jax)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trips_every_leaf(dtype):
    cfg, jcfg = _small("qwen3_32b", dtype=dtype)
    params = JaxEngine(jcfg, max_len=16, seed=3).params
    np_tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(np_tree, cfg)
    flat = flatten(np_tree)
    assert set(sd) == set(flat)
    for path, a in flat.items():
        t = sd[path]
        assert tuple(t.shape) == a.shape, path
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=path)
    # the engine's state_dict keys are the JAX paths
    engine = LLMEngine(cfg, sd, max_len=16, device="cpu")
    assert set(engine.model.state_dict()) == set(flat)
    assert "blocks.l0.mixer.wq" in engine.model.state_dict()


# ---------------------------------------------------------------------------
# prefill, generate, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", ["default", "kernels"])
def test_prefill_logits_match_jax(pair, flags):
    toks = _prompts(pair.cfg, 2, 13, 0)
    je = pair.jax if flags == "default" else pair.jax_kernels
    jl, _ = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                             flags=je.flags)
    tl, _ = pair.port.model.prefill(torch.as_tensor(toks).long(), MAX_LEN)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (2, pair.cfg.padded_vocab)
    real = slice(0, pair.cfg.vocab_size)
    assert np.abs(jl[:, real] - tl[:, real].numpy()).max() <= 1e-4
    if pair.cfg.padded_vocab != pair.cfg.vocab_size:
        assert (tl[:, pair.cfg.vocab_size:] == -1e30).all()


def test_generate_matches_jax(pair):
    toks = _prompts(pair.cfg, 2, 11, 1)
    n = 8
    want = pair.jax.generate(toks, n)
    got = pair.port.generate(toks, n)
    assert got.shape == want.shape == (2, n)
    # the port's logits along the JAX tokens (teacher forcing)
    model = pair.port.model
    logits, cache = model.prefill(torch.as_tensor(toks).long(), MAX_LEN)
    steps = [logits]
    for i in range(n - 1):
        pos = torch.full((2,), toks.shape[1] + i, dtype=torch.int32)
        logits, cache = model.decode_step(
            torch.as_tensor(want[:, i:i + 1]).long(), cache, pos)
        steps.append(logits)
    assert_tokens(want, got, torch.stack(steps, dim=1))


def _serve(engine, cfg, log):
    """prefill -> insert -> decode (slot 3 inactive half the time) ->
    verify, recording every output; returns the final cache."""
    backend = types.SimpleNamespace(kind="slot", num_slots=4)
    cache = engine.new_cache(backend)
    last = np.zeros(4, np.int32)
    pos = np.zeros(4, np.int32)
    for g, S in enumerate((10, 14)):
        first, rows = engine.prefill(_prompts(cfg, 2, S, 10 + g))
        for r in range(2):
            cache = engine.insert(backend, cache, rows, r, 2 * g + r)
            last[2 * g + r], pos[2 * g + r] = first[r], S
    log.append(("prefill", last.copy()))
    for t in range(6):
        active = np.array([True, True, True, t % 2 == 0])
        tok, cache = engine.decode(backend, cache, last, pos, active)
        log.append(("decode", tok))
        last = np.where(active, tok, last)
        pos = pos + active
    window = np.concatenate([last[:, None], _prompts(cfg, 4, 2, 7)], axis=1)
    guess, cache = engine.verify(backend, cache, window, pos,
                                 np.ones(4, bool))
    log.append(("verify", guess))
    return cache


def test_serving_sequence_matches_jax(pair):
    jlog, tlog, xlog = [], [], []
    jcache = _serve(pair.jax, pair.jcfg, jlog)
    tcache = _serve(pair.port, pair.cfg, tlog)
    xcache = _serve(pair.exact, pair.cfg, xlog)
    assert [k for k, _ in jlog] == [k for k, _ in tlog]
    for (kind, want), (_, got) in zip(jlog, tlog):
        if not np.array_equal(want, got):
            pytest.fail(f"{kind}: port tokens {got} != JAX tokens {want}")
    assert_cache_close(jcache, tcache, xcache)


# ---------------------------------------------------------------------------
# device rule, unsupported configs, import hygiene
# ---------------------------------------------------------------------------

def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm_2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, max_len=16, device="cuda")


def test_model_without_device_needs_cuda(monkeypatch):
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm_2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    assert Model(cfg, device="cpu").new_cache(1, 8)["blocks"]["l0"][
        "mixer"]["k"].device.type == "cpu"


@pytest.mark.parametrize("name", ["granite_moe_3b_a800m", "xlstm_1_3b",
                                  "deepseek_v3_671b", "seamless_m4t_large_v2",
                                  "phi_3_vision_4_2b", "jamba_1_5_large_398b"])
def test_unsupported_configs_raise(name):
    """Each architecture the port does not serve raises, naming its
    ROADMAP item.  granite_moe_3b_a800m, jamba_1_5_large_398b and
    deepseek_v3_671b are served since their MoE FFN, Mamba layers and
    MLA were ported: what stays refused there is the expert-parallel
    MoE; deepseek_v3_671b's case also serves a few tokens.  xlstm_1_3b,
    seamless_m4t_large_v2 and phi_3_vision_4_2b are served since their
    recurrent stack and the encoder-decoder and modality stubs were
    ported: their cases serve a few tokens (``generate`` takes tokens
    only, as in JAX)."""
    from repro_torch.models.transformer import RuntimeFlags
    if name in ("granite_moe_3b_a800m", "jamba_1_5_large_398b",
                "deepseek_v3_671b"):
        cfg = get_config(name).reduced()
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 11"):
            LLMEngine(cfg, max_len=16, device="cpu",
                      flags=RuntimeFlags(moe_impl="ep"))
        if name != "deepseek_v3_671b":
            return
    cfg = get_config(name).reduced()
    engine = LLMEngine(cfg, max_len=16, device="cpu")
    out = engine.generate(_prompts(cfg, 2, 5, 0), 3)
    assert out.shape == (2, 3)
    assert ((0 <= out) & (out < cfg.vocab_size)).all()


def test_sliding_window_and_other_layouts_raise():
    """Sliding-window attention is served since ROADMAP Queue 1 item 12,
    and refused where JAX refuses it: a windowed dense stack builds its
    engine, and its paged arena, a windowed hybrid stack's hybrid arena
    and extend on the state layout raise JAX's errors.  The state and
    hybrid layouts are served since ROADMAP Queue 1 item 7: on a dense
    stack they build and extend and speculate, while the paged layout
    refuses a recurrent stack and an unknown layout is refused
    outright."""
    for name, kind in (("minicpm_2b", "paged"),
                       ("jamba_1_5_large_398b", "hybrid")):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  sliding_window=16)
        windowed = LLMEngine(cfg, max_len=16, device="cpu")
        with pytest.raises(ValueError, match="sliding-window attention "
                                             "is not supported"):
            windowed.new_cache(types.SimpleNamespace(
                kind=kind, num_slots=2, num_blocks=5, block_size=8))
        with pytest.raises(ValueError, match="prefix extend: "
                                             "sliding-window"):
            windowed.check_extend_support("state")
    engine = LLMEngine(get_config("minicpm_2b").reduced(), max_len=16,
                       device="cpu")
    for kind in ("slot", "paged", "state", "hybrid"):
        engine.check_extend_support(kind)
        engine.check_spec_support(kind)
    state = engine.new_cache(types.SimpleNamespace(kind="state",
                                                   num_slots=2))
    assert state["blocks"]["l0"]["mixer"]["k"].shape[1:3] == (2, 16)
    hybrid = engine.new_cache(types.SimpleNamespace(
        kind="hybrid", num_slots=2, num_blocks=5, block_size=8))
    assert hybrid["blocks"]["l0"]["mixer"]["k"].shape[1:3] == (5, 8)
    with pytest.raises(ValueError, match="unknown cache layout"):
        engine.new_cache(types.SimpleNamespace(kind="ring", num_slots=2))
    xlstm = LLMEngine(get_config("xlstm_1_3b").reduced(), max_len=16,
                      device="cpu")
    for check in (xlstm.check_extend_support, xlstm.check_spec_support):
        with pytest.raises(ValueError, match="recurrent"):
            check("paged")
        check("state")
    assert engine.mesh is None and engine.cache_shards() == 1
    assert engine.mesh_desc == {"devices": 1, "axes": {}}


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {n}"
