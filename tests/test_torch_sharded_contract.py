"""The port's tensor-parallel serving of the contractions and of the
widths the ranks do not divide (ROADMAP item 11b-ii), on the CPU.

The equivalence runs in ONE subprocess
(``tests/_torch_sharded_contract_battery.py``), as the other tp test
files run theirs: reduced deepseek_v3_671b (MLA, slot and paged),
GQA configurations whose K/V lie on head_dim (slot, paged, hybrid) and
on the sequence (slot, paged), reduced seamless_m4t_large_v2 through
``generate`` with its encoder's frames, and one configuration for each
width the constructor refused before, through the port's
``GraphServer`` on meshes of 1, 2 and 4 gloo CPU ranks.  Every run's
tokens must equal the JAX unsharded engine's greedy tokens and the
port's run without a mesh, its first-step logits sit within 1e-4 of
JAX's, ``cache_shards`` equal the JAX engine's rule, and every rank's
cache leaves have ``local_tree``'s shapes.  The tests here are thin,
parametrised assertions over its JSON verdicts.

In this process: each rank's weights against ``param_specs`` (a fused
projection whose block the ranks do not divide held whole), a
vocabulary the ranks do not divide computed whole and not summed, and
the lengths a sequence-cut cache needs the ranks to divide.
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.serving.engine import (check_tp_support,  # noqa: E402
                                        cuts_positions)
from repro_torch.sharding.rules import (local_shape, param_parts,  # noqa: E402
                                        param_specs)

from test_torch_engine import one_torch_thread  # noqa: E402,F401
from _torch_sharded_contract_battery import CASES, SCENARIOS  # noqa: E402

_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_sharded_contract_battery.py")


@pytest.fixture(scope="module")
def battery():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, _BATTERY], capture_output=True,
                          text=True, env=env, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("BATTERY ")]
    assert lines, (f"battery produced no verdict (rc={proc.returncode}):\n"
                   f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BATTERY "):])


def _check(battery, key):
    assert key in battery, f"battery never ran {key}: {sorted(battery)}"
    verdict = battery[key]
    assert verdict["ok"], f"{key}: {verdict['detail']}"


def _serving_keys():
    keys = []
    for name, (_, _, layouts, sizes) in CASES.items():
        for layout in layouts:
            if layout == "generate":
                keys += [f"generate/{name}/tp{tp}" for tp in sizes]
                continue
            for scen in SCENARIOS:
                if scen == "preempt" and layout not in ("paged", "hybrid"):
                    continue
                keys += [f"{scen}/{layout}/{name}/tp{tp}" for tp in sizes]
    return keys


@pytest.mark.parametrize("key", _serving_keys())
def test_serving_matches_jax_and_unsharded(battery, key):
    """Decode, verify windows, chunked extend and preemption replay (or
    the encoder-decoder's ``generate``) on an N-rank mesh stream the JAX
    engine's greedy tokens and the port's unsharded run's."""
    _check(battery, key)


@pytest.mark.parametrize("key", [
    f"logits/{name}/tp{tp}" for name, (_, _, _, sizes) in CASES.items()
    for tp in (0,) + sizes])
def test_first_step_logits_match_jax(battery, key):
    """Every engine's prefill logits within 1e-4 of JAX's, pad masked."""
    _check(battery, key)


@pytest.mark.parametrize("key", [
    f"cache_shards/{name}/tp{tp}" for name, (_, _, _, sizes) in CASES.items()
    for tp in sizes])
def test_cache_shards_is_the_jax_rule(battery, key):
    """``cache_shards`` returns what the JAX engine's rule returns: tp for
    K/V on kv heads or head_dim and for MLA's lora rank, else 1."""
    _check(battery, key)


@pytest.mark.parametrize("key", [
    f"cache_shapes/{layout}/{name}/tp{tp}"
    for name, (_, _, layouts, sizes) in CASES.items()
    for layout in layouts for tp in sizes])
def test_rank_caches_are_local_tree_shapes(battery, key):
    """Every rank's cache leaves (an encoder-decoder's prefill rows with
    their cross caches) have ``local_tree``'s shapes."""
    _check(battery, key)


def test_ranks_hold_rank0_caches_and_no_call_drops(battery):
    _check(battery, "hygiene/ranks_and_drops")


# ---------------------------------------------------------------------------
# in this process: weights, a whole vocabulary, lengths
# ---------------------------------------------------------------------------

def _cfg(name):
    arch, kw, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_weights_are_param_specs_slices(name, tp):
    """Each rank's weights have ``param_specs``' per-rank shapes, apart
    from a fused projection whose block the ranks do not divide, which
    is whole; every other leaf the rules cut is smaller than the whole
    on every rank."""
    cfg = _cfg(name)
    template = tf.model_template(cfg)
    mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
    specs = flatten(param_specs(template, mesh))
    parts = param_parts(template)
    whole = {p: tuple(s.shape) for p, s in flatten(template).items()}
    for rank in (0, tp - 1):
        got = Model(cfg, device="cpu", seed=0, mesh=mesh,
                    rank=rank).state_dict()
        for path, t in got.items():
            want = local_shape(whole[path], specs[path], mesh)
            blocks = parts[path]
            if blocks is not None and any(b % tp for b in blocks):
                want = want[:-1] + (whole[path][-1],)
            assert tuple(t.shape) == want, path
            if want != whole[path]:
                assert np.prod(want) * tp == np.prod(whole[path]), path


class _NoSum:
    """A rank group that must not be asked for a sum."""
    rank, size = 1, 3

    def all_reduce(self, t):
        raise AssertionError("a whole width was summed")


def test_whole_vocabulary_is_computed_whole_and_not_summed():
    """A padded vocabulary the ranks do not divide (128 rows at 3 ranks:
    the padded vocabulary is a multiple of 128, so no tp of 2, 4 or 8
    leaves it whole) is looked up and projected whole, with no sum."""
    cfg = dataclasses.replace(get_config("minicpm_2b").reduced(),
                              num_layers=1, d_model=32, vocab_size=100)
    model = Model(cfg, device="cpu", seed=0)
    params = model.params
    flags = types.SimpleNamespace(tp=_NoSum())
    toks = torch.tensor([[1, 5, 99]])
    assert torch.equal(tf._embed(params, cfg, toks, flags),
                       tf._embed(params, cfg, toks,
                                 types.SimpleNamespace(tp=None)))
    x = torch.randn(1, 3, cfg.d_model)
    assert torch.equal(tf._logits(params, cfg, x.clone(), _NoSum()),
                       tf._logits(params, cfg, x.clone()))


def test_sequence_cut_lengths_must_divide():
    """K/V on the sequence (and MLA's ``k_rope``) hold a rank's cut of
    the positions: ``max_len`` and the block size must divide tp."""
    seq = _cfg("seq")
    assert cuts_positions(seq, 4) and not cuts_positions(seq, 2)
    assert cuts_positions(_cfg("mla"), 2)
    assert not cuts_positions(_cfg("hd"), 4)
    with pytest.raises(ValueError, match="max_len 30"):
        check_tp_support(seq, 4, 30)
    assert check_tp_support(seq, 4, 32) is None
    assert check_tp_support(seq, 2, 30) is None
