"""The port's sharding rules (``repro_torch.sharding.rules``) and logical
axes against the JAX package's, and the rank slices they cut.

Pure logic on duck-typed meshes (a stand-in that has ``shape`` and
``axis_names``, as the JAX rules' tests use): every leaf of every
architecture's template carries JAX's logical axes; ``resolve_spec``,
``param_specs`` and ``cache_specs`` give JAX's spec dimension by
dimension on four meshes, for every abstract cache of every layout; the
cases of ``tests/test_sharding_rules.py``'s ``TestResolveSpec`` and
``TestKVCacheAxes``; and ``shard_state_dict``'s slices (and a rank's
``Model``) concatenate bitwise to the unsharded ``Model``'s weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.params import logical_axes as jax_logical_axes  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import flatten, logical_axes  # noqa: E402
from repro_torch.sharding.rules import (RULES, _kv_cache_axes,  # noqa: E402
                                        cache_specs, local_shape,
                                        local_tree, param_parts,
                                        param_specs, resolve_spec,
                                        shard_state_dict)


class FakeMesh:
    """Duck-typed mesh: rules only read .shape and .axis_names."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH_POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "pod": MESH_POD,
          "tp2": FakeMesh({"data": 1, "model": 2}),
          "tp4": FakeMesh({"data": 1, "model": 4})}


def _jax_flat(tree, is_leaf):
    """A JAX pytree of nested dicts as ``{"a.b.c": leaf}``."""
    pairs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(k.key) for k in path): v for path, v in pairs}


class TestResolveSpec:
    def test_basic(self):
        s = resolve_spec((8192, 64, 128), ("embed", "heads", "head_dim"),
                         MESH)
        assert s == ("data", "model")

    def test_indivisible_replicates(self):
        # kv_heads=8 can't shard 16 ways -> replicated
        s = resolve_spec((8192, 8, 128), ("embed", "kv_heads", "head_dim"),
                         MESH)
        assert s == ("data",)

    def test_axis_claimed_once(self):
        # both dims want "model": first dim wins, second replicates
        s = resolve_spec((64, 25600), ("heads", "mlp"), MESH)
        assert s == ("model",)

    def test_experts_fallback_chain(self):
        s = resolve_spec((48, 1536, 512), ("experts", "embed", "mlp"),
                         MESH)
        assert s == ("model", "data")

    def test_batch_axes_multi_pod(self):
        s = resolve_spec((256, 4096), ("batch", None), MESH_POD)
        assert s == (("pod", "data"),)

    def test_batch_indivisible(self):
        s = resolve_spec((1, 4096), ("batch", None), MESH)
        assert s == ()


class TestKVCacheAxes:
    def test_kv_heads_preferred(self):
        axes = _kv_cache_axes((128, 32768, 32, 128), MESH)
        assert axes[2] == "kv_heads"

    def test_head_dim_fallback(self):
        axes = _kv_cache_axes((128, 32768, 8, 128), MESH)
        assert axes[3] == "head_dim_sharded"

    def test_seq_last_resort(self):
        axes = _kv_cache_axes((128, 32768, 8, 100), MESH)
        assert axes[1] == "seq"


def test_rules_are_jax_rules():
    assert RULES == jax_rules.RULES


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_leaf_carries_jax_logical_axes(arch):
    port = flatten(logical_axes(tf.model_template(get_config(arch))))
    ref = _jax_flat(jax_logical_axes(JaxModel(jax_get_config(arch)).template),
                    lambda x: isinstance(x, tuple))
    assert port == ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch, mesh):
    m = MESHES[mesh]
    port = flatten(param_specs(tf.model_template(get_config(arch)), m))
    ref = _jax_flat(jax_rules._spec_tree_from_template(
        JaxModel(jax_get_config(arch)).template, m),
        lambda x: isinstance(x, P))
    assert port == {k: tuple(v) for k, v in ref.items()}


def _abstract(arch, layout):
    """(port, JAX) abstract cache of ``layout``, or the exception both
    raise for it."""
    cfg, jm = get_config(arch), JaxModel(jax_get_config(arch))
    enc = 16 if cfg.is_encoder_decoder else 0
    port_fn, jax_fn = {
        "slot": (lambda: tf.abstract_cache(cfg, 4, 64, enc),
                 lambda: jm.abstract_cache(4, 64, enc)),
        "paged": (lambda: tf.abstract_paged_cache(cfg, 33, 16),
                  lambda: jm.abstract_paged_cache(33, 16)),
        "hybrid": (lambda: tf.abstract_hybrid_cache(cfg, 4, 33, 16),
                   lambda: jm.abstract_hybrid_cache(4, 33, 16)),
    }[layout]
    try:
        ref = jax_fn()
    except Exception as e:          # noqa: BLE001 - the port must refuse too
        with pytest.raises(type(e)):
            port_fn()
        return None, None
    return port_fn(), ref


def _jax_cache_specs(tree, mesh, scanned=False):
    """JAX's ``cache_specs`` walk, its specs as ``PartitionSpec``s (its
    ``NamedSharding`` wrapper needs a real mesh)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{p}": s for p, s in _jax_cache_specs(
                v, mesh, scanned or k == "blocks").items()})
        else:
            axes = jax_rules._cache_leaf_axes(k, v.shape, scanned, mesh)
            out[k] = jax_rules.resolve_spec(v.shape, axes, mesh)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", ["slot", "paged", "hybrid"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_jax(arch, layout, mesh):
    port, ref = _abstract(arch, layout)
    if port is None:
        return
    m = MESHES[mesh]
    got = flatten(cache_specs(port, m))
    want = _jax_cache_specs(ref, m)
    assert got == {k: tuple(v) for k, v in want.items()}
    shapes = {k: tuple(v.shape) for k, v in flatten(port).items()}
    assert shapes == {k: tuple(v.shape) for k, v in
                      _jax_flat(ref, lambda x: hasattr(x, "shape")).items()}


# ---------------------------------------------------------------------------
# a rank's slices
# ---------------------------------------------------------------------------

QWEN = dataclasses.replace(
    get_config("qwen3_32b").reduced(), num_layers=2, d_model=64,
    num_heads=8, num_kv_heads=4, head_dim=16, vocab_size=256)
MINICPM = dataclasses.replace(
    get_config("minicpm_2b").reduced(), num_layers=1, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=200)


GRANITE = dataclasses.replace(
    get_config("granite_moe_3b_a800m").reduced(), d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, vocab_size=256)
JAMBA = dataclasses.replace(
    get_config("jamba_1_5_large_398b").reduced(), d_model=64,
    num_kv_heads=4, vocab_size=256)
XLSTM = dataclasses.replace(
    get_config("xlstm_1_3b").reduced(), num_layers=2, d_model=64,
    vocab_size=256, block_pattern=("mlstm", "slstm"))
#: the fused projections (``ParamSpec.parts``): each rank holds its
#: slice of every block of the last axis
FUSED = {"mamba": ("in_proj",), "mlstm": ("up_proj",),
         "slstm": ("w_x", "b", "w_h")}


def _whole(pieces, dim, blocks):
    """The ranks' ``pieces`` put back together: along ``dim``, or, for a
    fused last axis of ``blocks``, block by block."""
    if blocks is None or dim != pieces[0].dim() - 1:
        return torch.cat(pieces, dim)
    tp = len(pieces)
    cut = [p.split([n // tp for n in blocks], dim) for p in pieces]
    return torch.cat([torch.cat([c[i] for c in cut], dim)
                      for i in range(len(blocks))], dim)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cfg", [QWEN, MINICPM, GRANITE, JAMBA, XLSTM],
                         ids=["qwen3", "minicpm", "granite", "jamba",
                              "xlstm"])
def test_slices_concatenate_to_the_unsharded_model(cfg, tp):
    """``shard_state_dict``'s slices, and the weights each rank's
    ``Model`` draws from the seed, concatenate bitwise to the unsharded
    ``Model(seed)``'s state_dict (a fused projection block by block);
    the norms and qk-norm scales are whole on every rank."""
    full = Model(cfg, device="cpu", seed=5).state_dict()
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    specs = flatten(param_specs(tf.model_template(cfg), mesh))
    blocks = param_parts(tf.model_template(cfg))
    parts = [shard_state_dict(full, tf.model_template(cfg), mesh, r)
             for r in range(tp)]
    drawn = [Model(cfg, device="cpu", seed=5, mesh=mesh,
                   rank=r).state_dict() for r in range(tp)]
    for path, t in full.items():
        spec = specs[path] + (None,) * (t.ndim - len(specs[path]))
        dims = [d for d, e in enumerate(spec) if e is not None and
                "model" in ((e,) if isinstance(e, str) else e)]
        for r in range(tp):
            assert torch.equal(drawn[r][path], parts[r][path]), path
            assert tuple(parts[r][path].shape) == local_shape(
                tuple(t.shape), specs[path], mesh)
        if not dims:
            assert all(torch.equal(p[path], t) for p in parts), path
            continue
        (dim,) = dims
        assert torch.equal(_whole([p[path] for p in parts], dim,
                                  blocks[path]), t), path
    assert "model" in specs["embed.embedding"]
    if cfg is not XLSTM:                    # xLSTM blocks have no FFN
        assert "model" in specs["blocks.l0.ffn.w_down"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", sorted(FUSED))
def test_fused_projections_cut_block_by_block(kind, tp):
    """Mamba's ``in_proj`` [x | z], mLSTM's ``up_proj`` [xm | z] (xm by
    head: the rank's dk of each) and the sLSTM's gate columns: rank r
    holds slice r of each block, in order."""
    cfg = JAMBA if kind == "mamba" else XLSTM
    path = {"mamba": "blocks.l1.mixer", "mlstm": "blocks.l0.mixer",
            "slstm": "blocks.l1.mixer"}[kind]
    full = Model(cfg, device="cpu", seed=5).state_dict()
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    d, H = cfg.d_model, cfg.num_heads
    di, hd = 2 * d, 2 * d // H
    want_blocks = {
        ("mamba", "in_proj"): (cfg.d_inner, cfg.d_inner),
        ("mlstm", "up_proj"): (hd,) * H + (di,),
        # reduced xlstm: 2 sLSTM heads of 32, gate blocks of 32 x gcd(2,
        # 4) = 64 = d_model, so the rank's channels are d's slice r
        ("slstm", "w_x"): (d,) * 4, ("slstm", "b"): (d,) * 4,
        ("slstm", "w_h"): (d,) * 2}
    blocks = param_parts(tf.model_template(cfg))
    for r in range(tp):
        rank = shard_state_dict(full, tf.model_template(cfg), mesh, r)
        for leaf in FUSED[kind]:
            key = f"{path}.{leaf}"
            assert blocks[key] == want_blocks[kind, leaf]
            t = full[key]
            cols = [b.narrow(-1, r * (b.shape[-1] // tp), b.shape[-1] // tp)
                    for b in t.split(list(blocks[key]), -1)]
            assert torch.equal(rank[key], torch.cat(cols, -1)), key


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_caches_hold_their_kv_heads(tp):
    cfg = QWEN
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    model = Model(cfg, device="cpu", seed=0, mesh=mesh, rank=tp - 1)
    full = Model(cfg, device="cpu", seed=0)
    for local, whole in ((model.new_cache(2, 32), full.new_cache(2, 32)),
                         (model.new_paged_cache(9, 8),
                          full.new_paged_cache(9, 8))):
        for path, a in flatten(local).items():
            w = flatten(whole)[path]
            assert a.shape[:-2] == w.shape[:-2] and a.shape[-1] == w.shape[-1]
            assert a.shape[-2] * tp == w.shape[-2] == cfg.num_kv_heads
    assert np.prod(model.params["blocks"]["l0"]["mixer"]["wq"].shape) * tp \
        == np.prod(full.params["blocks"]["l0"]["mixer"]["wq"].shape)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cfg,layout", [(XLSTM, "slot"), (JAMBA, "hybrid"),
                                        (GRANITE, "paged")],
                         ids=["xlstm-state", "jamba-hybrid", "granite-paged"])
def test_rank_mixer_caches_are_local_tree_shapes(cfg, layout, tp):
    """A rank's caches, recurrent state slabs among them, have the shapes
    ``local_tree(cache_specs(...))`` gives: Mamba's conv and h on
    d_inner, mLSTM's C and n on dk and its m on heads, the sLSTM's state
    on d_model, attention K/V on kv heads."""
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    model = Model(cfg, device="cpu", seed=0, mesh=mesh, rank=tp - 1)
    cache, abstract = {
        "slot": (lambda: model.new_cache(3, 16),
                 lambda: tf.abstract_cache(cfg, 3, 16)),
        "hybrid": (lambda: model.new_hybrid_cache(3, 9, 8),
                   lambda: tf.abstract_hybrid_cache(cfg, 3, 9, 8)),
        "paged": (lambda: model.new_paged_cache(9, 8),
                  lambda: tf.abstract_paged_cache(cfg, 9, 8)),
    }[layout]
    got = {p: tuple(a.shape) for p, a in flatten(cache()).items()}
    want = {p: tuple(a.shape) for p, a in
            flatten(local_tree(abstract(), mesh)).items()}
    assert got == want
    full = {p: tuple(a.shape) for p, a in flatten(abstract()).items()}
    for path, shape in got.items():
        key = path.rsplit(".", 1)[1]
        sharded = [i for i, (a, b) in enumerate(zip(shape, full[path]))
                   if a != b]
        assert len(sharded) == 1 and shape[sharded[0]] * tp == \
            full[path][sharded[0]], (path, shape, full[path])
        if cfg is XLSTM:
            assert sharded[0] == {"C": 3, "n": 3 if len(shape) == 4 else 2,
                                  "m": 2, "c": 2, "h": 2}[key], path
