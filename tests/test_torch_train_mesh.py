"""The port's training on a mesh (ROADMAP item 11c-i) on the CPU (item
11c-ii's mixers, MLA and Adafactor: ``test_torch_train_mesh_mixers.py``).

The equivalence runs in ONE subprocess (``tests/_torch_train_mesh_battery.py``):
JAX's ``make_train_step`` under an ``Auto``-typed mesh of 4 forced host
devices, the port's ``make_train_step(mesh=...)`` on gloo CPU ranks, the
same reduced f32 weights and numpy-seeded batches.  Each case holds one
step's loss, aux, grad norm and every updated param leaf, and a 3-step
loss curve, by ``tests/test_torch_train.py``'s tolerances and its
``assert_leaves`` rule; the attention arm each case takes is asserted,
the expert-parallel cases' drops are held to ``moe.ep_plain``'s, and one
case checks each rank's state shapes and the mesh checkpoint.  The
tests here are thin assertions over its JSON verdicts, one per case.

The architectures and the optimizer a mesh refused before item 11c-ii
(xlstm_1_3b, jamba_1_5_large_398b, deepseek_v3_671b, Adafactor) build
and take a step there too.  In this process: the meshes and their
errors, ``train_state_specs`` (AdamW's and Adafactor's) and
``batch_specs``, the flags a mesh checks, ``moe_impl="ep"`` without a mesh (``ep_plain``) and the
launcher's ``--host-mesh`` over two CPU ranks.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (TrainingMesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh, mesh_desc)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import (TRAIN_FLAGS,  # noqa: E402
                                            RuntimeFlags)
from repro_torch.runtime.steps import make_train_step  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_train import LINE  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_train_mesh_battery.py")
CASES = ["minicpm/1x2", "minicpm/2x1", "minicpm/2x2", "minicpm/1x4",
         "minicpm/pod2x1x2", "qwen3/2x2", "qwen3/1x4",
         "deepseek7b_window/2x2", "deepseek7b_window/1x4",
         "granite_ep/2x2", "granite_ep_drops/2x2", "granite_ep_decode/2x2",
         "granite_ep_b3/2x2", "phi3v/2x2", "seamless/1x4"]


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
    under an ``Auto`` mesh, in the attention arm the case names."""
    _check(battery, case)


def test_arms_cover_both_strategies(battery):
    """The head arm at 4 heads over 2 kv heads on 2 model ranks, the
    sequence arm on 4 (2 kv heads do not divide 4), the plain attention
    on a model axis of 1."""
    arms = {c: set(_check(battery, c)["arms"]) for c in CASES}
    assert arms["minicpm/2x2"] == arms["qwen3/2x2"] == {"heads"}
    assert arms["minicpm/1x4"] == arms["seamless/1x4"] == {"seq"}
    assert arms["minicpm/2x1"] == {"whole"}


def test_ep_drops_are_the_shards(battery):
    """At capacity_factor 0.5 the training-sized ``_moe_ep`` drops what
    each data shard's capacity drops, which is not what the unsharded
    gather drops: the mesh's drops equal ``ep_plain``'s, and JAX's mesh
    step is not its unsharded gather step."""
    d = _check(battery, "granite_ep_drops/2x2")
    assert d["drops"]["mesh"] == d["drops"]["ep_plain"]
    assert d["drops"]["mesh"] != d["drops"]["gather"]
    for c in ("granite_ep/2x2", "granite_ep_decode/2x2", "granite_ep_b3/2x2"):
        drops = _check(battery, c)["drops"]
        assert drops["mesh"] == drops["ep_plain"]
    decode = _check(battery, "granite_ep_decode/2x2")["drops"]
    assert decode["ep_plain"] == decode["gather"]     # the global capacity


def test_state_shapes_and_checkpoint(battery):
    """Each rank's TrainState shapes are ``train_state_specs``'s local
    shapes; the mesh checkpoint is the unsharded save, byte for byte; a
    whole state cut into the ranks' slices gathers back bitwise."""
    d = _check(battery, "minicpm/2x2")
    assert d["state_leaves"] == 34 and d["checkpoint_files"] == 35
    assert d["resumed_bitwise"]


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_meshes():
    m = make_host_mesh(devices=["cpu"] * 4)
    assert (m.axis_names, m.sizes) == (("data", "model"), (4, 1))
    assert make_host_mesh(2, devices=["cpu"] * 4).shape == \
        {"data": 2, "model": 2}
    assert make_host_mesh(3, devices=["cpu"] * 4).sizes == (4, 1)
    p = make_production_mesh(devices=["cpu"] * 300)
    assert p.shape == {"data": 16, "model": 16} and len(p.devices) == 256
    pod = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_desc(pod) == {"devices": 512, "platform": "cpu",
                              "axes": {"pod": 2, "data": 16, "model": 16}}
    with pytest.raises(ValueError, match="needs 512 devices, have 300"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 300)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=["cpu"] * 4)


def test_train_state_and_batch_specs():
    cfg = get_config("minicpm_2b").reduced()
    tmpl = tf.model_template(cfg)
    mesh = TrainingMesh(("cpu",) * 4, ("data", "model"), (2, 2))
    st = rules.train_state_specs(tmpl, mesh, "adamw")
    assert st.opt.step == () and st.opt.m == st.params == st.opt.v
    assert st.params["blocks"]["l0"]["mixer"]["wq"] == \
        (None, "data", "model")
    assert st.params["embed"]["embedding"] == ("model", "data")
    shapes = rules.local_train_state_shapes(tmpl, mesh, "adamw")
    assert shapes["params.embed.embedding"] == (512, 128)
    assert shapes["m.blocks.l0.ffn.w_down"] == (2, 256, 128)
    ada = rules.train_state_specs(tmpl, mesh, "adafactor")
    assert ada.opt.m is None and ada.params == st.params
    # a factored leaf: rows by the param's spec but its last entry,
    # columns by resolve_spec of its own dims; a vector: the param's
    assert ada.opt.v["blocks"]["l0"]["ffn"]["w_down"] == rules.Factors(
        (None, "model"), (None, "data"))
    assert ada.opt.v["embed"]["embedding"] == rules.Factors(
        ("model",), ("data",))
    assert ada.opt.v["final_norm"]["scale"] == ("data",)
    ashapes = rules.local_train_state_shapes(tmpl, mesh, "adafactor")
    assert ashapes["v.blocks.l0.ffn.w_down.0"] == (2, 256)
    assert ashapes["v.blocks.l0.ffn.w_down.1"] == (2, 128)
    assert not any(k.startswith("m.") for k in ashapes)
    assert rules.batch_specs({"tokens": (4, 64), "odd": (3, 64)}, mesh) == \
        {"tokens": ("data",), "odd": ()}
    pod = TrainingMesh(("cpu",) * 4, ("pod", "data", "model"), (2, 1, 2))
    assert rules.batch_specs({"x": (4, 8, 2)}, pod) == \
        {"x": (("pod", "data"),)}


#: what a training mesh refused before the recurrent mixers, MLA, the
#: MTP head and Adafactor were ported
REFUSALS = {"xlstm_1_3b": "mLSTM", "jamba_1_5_large_398b": "Mamba",
            "deepseek_v3_671b": "MLA, MTP, Adafactor",
            "minicpm_2b": "Adafactor"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_mesh_refusals_name_11c_ii(battery, name):
    """What a training mesh once refused (ROADMAP item 11c-ii) now builds
    on a (1, 2) mesh from its config and takes one step: reduced
    xlstm_1_3b's mLSTM layers, jamba's Mamba and Adafactor,
    deepseek_v3_671b's MLA, MTP head and Adafactor, and Adafactor asked
    of minicpm_2b; the ranks' update sums of every leaf are the
    unsharded step's (the battery's ``check_build``)."""
    m = _check(battery, f"builds/{name}")
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert ("mtp_loss" in m) == (name == "deepseek_v3_671b")


def test_mesh_flags_checked():
    cfg = get_config("granite_moe_3b_a800m").reduced()
    model = Model(cfg, device="cpu")
    mesh = TrainingMesh(("cpu",) * 4, ("data", "model"), (2, 2))
    for bad in (dict(model_size=4), dict(batch_axes=("data",),
                                         batch_divisor=4)):
        with pytest.raises(ValueError):
            make_train_step(model, schedule=lambda s: s, mesh=mesh,
                            flags=dataclasses.replace(TRAIN_FLAGS, **bad))


def test_ep_without_a_mesh_is_ep_plain():
    """``moe_impl="ep"`` needs flags that name a mesh (JAX's needs one);
    with them and no mesh it is ``moe.ep_plain``: at a decode-sized batch
    the gather dispatch bitwise, at a training-sized one the dispatch of
    each shard's rows with its own capacity."""
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m").reduced(),
                              capacity_factor=0.5)
    p = Model(cfg, device="cpu").params["blocks"]["l0"]["ffn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.as_tensor(np.random.RandomState(1).randn(4, 32, cfg.d_model),
                        dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="11c-i"):
        moe.moe_apply(p, cfg, x, RuntimeFlags(moe_impl="ep"))
    ep = RuntimeFlags(moe_impl="ep", batch_axes=("data",), batch_divisor=2)
    got, aux = moe.moe_apply(p, cfg, x, ep)
    want, want_aux = moe.moe_apply(p, cfg, x, RuntimeFlags())
    assert torch.equal(aux, want_aux)
    halves = [moe.moe_apply(p, cfg, h, RuntimeFlags())[0] for h in x.chunk(2)]
    assert torch.equal(got, torch.cat(halves))
    assert not torch.equal(got, want)            # the shards drop apart
    small = x[:2, :16]
    assert torch.equal(moe.moe_apply(p, cfg, small, ep)[0],
                       moe.moe_apply(p, cfg, small, RuntimeFlags())[0])


def test_launcher_host_mesh_two_ranks(tmp_path):
    """``--host-mesh`` over two CPU ranks (``--host-devices 2``): a (2, 1)
    mesh, data parallel with ZeRO; JAX's lines, JAX's rc, the checkpoint
    gathered from the ranks."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--reduced", "--arch", "minicpm_2b", "--steps", "3",
           "--batch", "2", "--seq", "32", "--log-every", "2", "--host-mesh",
           "--host-devices", "2", "--checkpoint-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(ROOT))
    lines = r.stdout.strip().splitlines()
    assert LINE["head"].match(lines[0]), r.stdout + r.stderr
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 2 and all(LINE["step"].match(ln) for ln in steps)
    end = LINE["end"].match(lines[-2])
    assert end, r.stdout
    assert lines[-1].startswith("checkpoint: ")
    assert len(os.listdir(lines[-1].split(": ", 1)[1])) == 12
    first, last = float(end.group(1)), float(end.group(2))
    assert r.returncode == (0 if last < first else 1)
