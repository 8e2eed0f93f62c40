"""The port's training on a mesh, second half, on the CPU: the recurrent
mixers (the mLSTM's sequence-parallel and ``dk`` arms, the sLSTM whole
on every rank, Mamba on its channels), MLA's sequence-parallel branch
and its MTP head, and Adafactor.

The equivalence runs in ONE subprocess
(``tests/_torch_train_mesh_mixers_battery.py``): JAX's ``make_train_step``
under an ``Auto``-typed mesh of 4 forced host devices against the port's
``make_train_step(mesh=...)`` on gloo CPU ranks, by
``tests/_torch_train_mesh_battery.py``'s rules, and the module checks
(``mlstm_apply_sp`` and the layer's dispatch at 8192 tokens against
JAX's under ``shard_map``, Adafactor's state specs against JAX's, each
mixer's mesh layer in f64 against the unsharded layer).  The
tests here are thin assertions over its JSON verdicts, one per case.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_train_mesh_mixers_battery.py")
CASES = ["xlstm_pair/1x2", "xlstm_pair/2x2", "jamba/2x2", "jamba/1x4",
         "deepseek_v3/2x2", "deepseek_v3_seq/1x4", "minicpm_adafactor/2x2",
         "minicpm_adafactor/pod2x1x2"]
#: the attention arm, or the mLSTM's, each case takes
ARMS = {"xlstm_pair/1x2": {"mlstm_dk"}, "xlstm_pair/2x2": {"mlstm_dk"},
        "jamba/2x2": {"heads"}, "jamba/1x4": {"seq"},
        "deepseek_v3/2x2": {"heads"}, "deepseek_v3_seq/1x4": {"seq"},
        "minicpm_adafactor/2x2": {"heads"},
        "minicpm_adafactor/pod2x1x2": {"heads"}}


@pytest.fixture(scope="module")
def battery():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
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
    return verdict["detail"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_matches_jax(battery, case):
    """One step and a 3-step curve of the case on its mesh against JAX's
    under an ``Auto`` mesh, in the arm the case names."""
    assert set(_check(battery, case)["arms"]) == ARMS[case]


def test_mtp_loss_held(battery):
    """deepseek_v3_671b's MTP loss on the mesh is JAX's (or within the
    f32 floor of the port's f64 step), on both attention arms."""
    for case in ("deepseek_v3/2x2", "deepseek_v3_seq/1x4"):
        d = _check(battery, case)["mtp_loss"]
        assert d["mesh"] > 0 and d["jax"] > 0


def test_adafactor_state(battery):
    """Adafactor's factored state after a mesh step is the unsharded
    step's; its state shapes, checkpoint and resume hold bitwise."""
    for case in ("jamba/2x2", "jamba/1x4", "deepseek_v3/2x2",
                 "minicpm_adafactor/2x2", "minicpm_adafactor/pod2x1x2"):
        assert _check(battery, case)["moments"]["leaves"] > 0
    for case in ("minicpm_adafactor/2x2", "deepseek_v3/2x2"):
        d = _check(battery, case)
        assert d["resumed_bitwise"] and d["checkpoint_files"] > 1


@pytest.mark.parametrize("mp", [2, 4])
def test_mlstm_apply_sp_matches_jax(battery, mp):
    """``mlstm_apply_sp`` on ``mp`` ranks against JAX's under
    ``shard_map``: y, the input's and every weight's gradient."""
    d = _check(battery, f"sp/mp{mp}")
    assert len(d["grads"]) == 9


def test_sp_dispatch_at_8192(battery):
    """One mLSTM layer at 1 x 8192 on a model line of 2: the port takes
    the sequence-parallel arm, as JAX's dispatch does, and matches its
    forward and backward."""
    assert _check(battery, "dispatch_8192")["arms"] == {"sp": 1}


#: the f64 layer checks: the arm of each mixer on its model line
LAYERS = ["mlstm_dk/1x2", "mlstm_dk/1x4", "slstm/1x2", "mamba/1x2",
          "mamba/1x4", "mla_heads/1x2", "mla_seq/1x4"]


@pytest.mark.parametrize("case", LAYERS)
def test_mesh_layer_f64_is_unsharded(battery, case):
    """One layer through ``mesh_block`` in f64 on a model line: y, the
    input's and every weight's gradient the unsharded layer's within
    1e-9 (the step checks cannot see a gradient's scale where Adam's
    first step is its sign)."""
    d = _check(battery, f"layer_f64/{case}")
    assert d["grads"] and max(d["grads"].values()) <= 1e-9


def test_adafactor_specs_are_jax(battery):
    """Adafactor's state specs equal JAX's ``train_state_specs`` for every
    leaf of every reduced architecture."""
    d = _check(battery, "adafactor_specs")
    assert d["factored"] > 0 and d["leaves"] > d["factored"]
