"""The port's cost analysis (ROADMAP item 11d) on the CPU: the dry run,
the op counter and the roofline (``repro_torch.launch.{dryrun,op_cost,
analysis}``), and the model facade's ``param_count``, ``abstract`` and
``input_shapes_for``.

The equivalence with JAX's dry run runs in ONE subprocess
(``tests/_torch_dryrun_battery.py``): JAX's own ``build_lowering`` on 4
forced host devices under ``Auto`` meshes, reduced configs and small
shapes, against the port's ``build_lowering`` under the op counter; the
tests here are thin assertions over its JSON verdicts, one per case.
In this process: the parameter counts of the ten full architectures,
the input shapes of every architecture at the four production shapes,
``model_flops`` and ``adjusted_config``, the kernels on ``meta``
operands, the ZeRO gathers' bytes, the import walk and the CLI.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import analysis, dryrun, mesh as port_mesh  # noqa: E402
from repro_torch.launch.mesh import TrainingMesh  # noqa: E402
from repro_torch.launch.op_cost import OpCounter  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.sharding.rules import _names, local_shape, param_specs  # noqa: E402

from test_torch_engine import one_torch_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
_BATTERY = os.path.join(HERE, "_torch_dryrun_battery.py")

ARCHS = ["minicpm_2b", "qwen3_32b", "stablelm_12b", "deepseek_7b",
         "granite_moe_3b_a800m", "xlstm_1_3b", "jamba_1_5_large_398b",
         "deepseek_v3_671b", "phi_3_vision_4_2b", "seamless_m4t_large_v2"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the battery's cases (its ``PLAN``): every architecture and shape on
#: (1, 1); on (2, 2) every architecture's serving shapes and two
#: architectures' train step; on (2, 1, 2) every architecture's decode
#: (the 150 s budget)
CASES = ([f"{a}/{s}/1x1" for a in ARCHS for s in SHAPES]
         + [f"{a}/{s}/2x2" for a in ARCHS
            for s in ("prefill_32k", "decode_32k", "long_500k")]
         + [f"{a}/train_4k/2x2" for a in ("minicpm_2b",
                                          "deepseek_v3_671b")]
         + [f"{a}/decode_32k/2x1x2" for a in ARCHS])


@pytest.fixture(scope="module")
def battery():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, _BATTERY], capture_output=True,
                          text=True, env=env, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("BATTERY ")]
    assert lines, (f"battery produced no verdict (rc={proc.returncode}):\n"
                   f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BATTERY "):])


@pytest.mark.parametrize("case", CASES)
def test_dryrun_matches_jax(battery, case):
    """The argument bytes per device exactly (but the named leaves), and
    the FLOPs within 2% on (1, 1) and by the battery's ``MESH_TOL``
    elsewhere, each after the named products (the battery's
    docstring)."""
    assert case in battery, f"battery never ran {case}: {sorted(battery)}"
    verdict = battery[case]
    assert verdict["ok"], f"{case}: {verdict['detail']}"


def test_battery_plan_and_budget(battery):
    """The battery ran exactly the cases above."""
    ran = {k for k in battery if not k.startswith("_")}
    assert ran == set(CASES)


# ---------------------------------------------------------------------------
# in this process: the model facade against JAX's
# ---------------------------------------------------------------------------

def _jax_model(arch):
    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    return JaxModel(jax_get_config(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_jax(arch):
    """``Model.param_count()`` is JAX's for the whole model, read from
    the template (nothing drawn, the same on a mesh's rank)."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    assert model.param_count() == _jax_model(arch).param_count()
    assert sum(t.numel() for t in flatten(model.abstract()).values()) == \
        model.param_count()


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_shapes_match_jax(arch, shape):
    """``input_shapes_for`` gives JAX's shapes and dtypes: the
    encoder-decoder's frames, a frontend's prefix embeddings, labels at
    train."""
    from repro.models.config import INPUT_SHAPES as JAX_SHAPES
    want = _jax_model(arch).input_shapes_for(JAX_SHAPES[shape])
    got = Model(get_config(arch), device="meta").input_shapes_for(
        INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), k


def _jax_adjusted_config():
    """JAX's ``adjusted_config``, from a module that sets ``XLA_FLAGS``
    when it is imported: the variable is put back at once, before JAX
    starts a backend in this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import adjusted_config
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return adjusted_config


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_adjusted_config_match_jax(arch):
    from repro.configs import get_config as jax_get_config
    from repro.launch.analysis import model_flops as jax_model_flops
    from repro.models.config import INPUT_SHAPES as JAX_SHAPES
    jax_adjusted = _jax_adjusted_config()
    for shape in INPUT_SHAPES:
        cfg = analysis.adjusted_config(get_config(arch), shape)
        jcfg = jax_adjusted(jax_get_config(arch), shape)
        assert cfg.sliding_window == jcfg.sliding_window
        assert dataclasses.asdict(cfg) == {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in dataclasses.asdict(jcfg).items()}
        assert analysis.model_flops(cfg, INPUT_SHAPES[shape]) == \
            jax_model_flops(jcfg, JAX_SHAPES[shape])


# ---------------------------------------------------------------------------
# the counter, the kernels, the collectives
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernels_record_one_op_each_on_meta():
    """Each of K1-K5 on ``meta`` operands records exactly one fused op
    with the active counter, with the ``times`` phase's bound bytes and
    operations (read each operand and write each output once; the keys
    the queries see), returns an empty output of its shape, and counts
    no launch."""
    B, H, KV, hd, bs, P = 4, 8, 2, 64, 16, 4
    i32 = torch.int32
    before = dict(ops.launches)
    with OpCounter() as c:
        x = ops.rmsnorm(_meta(5, 256), _meta(256))
        a = ops.flash_attention(_meta(2, 40, H, hd), _meta(2, 168, KV, hd),
                                _meta(2, 168, KV, hd), q_offset=128)
        pos = torch.tensor([3, 17, 30, 63], dtype=i32)      # host positions
        d2 = ops.fused_flash_decode(
            _meta(B, 2, H, hd), _meta(B, 2, KV, hd), _meta(B, 2, KV, hd),
            _meta(9, bs, KV, hd), _meta(9, bs, KV, hd),
            _meta(B, P, dtype=i32), pos, _meta(hd // 2,
                                               dtype=torch.float32))
        d4 = ops.fused_flash_decode(
            _meta(B, 1, H, hd), _meta(B, 1, KV, hd), _meta(B, 1, KV, hd),
            _meta(9, bs, KV, hd), _meta(9, bs, KV, hd),
            _meta(B, P, dtype=i32), _meta(B, dtype=i32),
            _meta(hd // 2, dtype=torch.float32), split_k=True)
        k5 = ops.paged_attention(_meta(B, H, hd), _meta(9, bs, KV, hd),
                                 _meta(9, bs, KV, hd),
                                 _meta(B, P, dtype=i32), pos)
    assert dict(ops.launches) == before
    names = [k["name"] for k in c.kernels]
    assert names == ["rmsnorm", "flash_attention", "fused_flash_decode",
                     "fused_flash_decode_splitk", "paged_attention"]
    for out, shape in ((x, (5, 256)), (a, (2, 40, H, hd)),
                       (d2, (B, 2, H, hd)), (d4, (B, 1, H, hd)),
                       (k5, (B, H, hd))):
        assert out.device.type == "meta" and tuple(out.shape) == shape
    k1, k3, k2, k4, kp = c.kernels
    assert (k1["bytes"], k1["flops"], k1["peak"]) == \
        (2 * 5 * 256 * 2 + 256 * 2, 4 * 5 * 256, "f32")
    pairs = 2 * H * sum(min(128 + s + 1, 168) for s in range(40))
    assert k3["flops"] == 4 * hd * pairs
    assert k3["bytes"] == 2 * (2 * 2 * 40 * H * hd + 2 * 2 * 168 * KV * hd)
    keys = [4, 18, 31, 64]
    assert k2["flops"] == 4 * hd * H * sum(n + s for n in keys
                                            for s in range(2))
    assert k2["bytes"] == 2 * sum(n + 1 for n in keys) * KV * hd * 2 + \
        2 * (B * 2 * H * hd + B * 2 * KV * hd) * 2 + B * P * 4 + B * 4
    # meta positions: every key the row's table addresses
    assert k4["flops"] == 4 * hd * H * B * P * bs
    assert kp["flops"] == 4 * hd * H * sum(keys)
    assert kp["bytes"] == 2 * sum(keys) * KV * hd * 2 + \
        2 * B * H * hd * 2 + B * P * 4 + B * 4
    assert c.flops == sum(k["flops"] for k in c.kernels)


def test_kernels_still_run_on_the_cpu():
    """A CPU tensor runs the plain version, as before; nothing is
    recorded without a counter."""
    x = torch.randn(3, 64)
    s = torch.ones(64)
    with OpCounter() as c:
        y = ops.rmsnorm(x, s)
    assert y.device.type == "cpu" and torch.isfinite(y).all()
    assert c.kernels == [] and c.bytes > 0


def test_flash_dryrun_prices_k3():
    """``--flash`` runs K3 at prefill, recorded once a layer."""
    cfg = get_config("minicpm_2b").reduced()
    orig = dryrun.get_config, dryrun.INPUT_SHAPES
    dryrun.get_config = lambda a: cfg
    dryrun.INPUT_SHAPES = {"p": InputShape("p", 64, 4, "prefill")}
    try:
        mesh = TrainingMesh(("meta",) * 4, ("data", "model"), (2, 2))
        step = dryrun.build_lowering("minicpm_2b", "p", mesh,
                                     dryrun.plain_flags(flash=True))
        c = dryrun.count_step(step)
    finally:
        dryrun.get_config, dryrun.INPUT_SHAPES = orig
    assert [k["name"] for k in c.kernels] == \
        ["flash_attention"] * cfg.num_layers


def _zero_gathered(cfg, mesh, remat_twice: bool, skip=()):
    """The bytes rank 0 gathers over data: every leaf the specs cut on
    ``data``, at its size with that cut undone; twice for a leaf inside
    a checkpointed unit (a layer group, an encoder layer, the MTP block;
    not the dense head layers, which run outside one) where
    ``remat_twice`` (the recompute gathers it again)."""
    tmpl = Model(cfg, device="meta").template
    specs = flatten(param_specs(tmpl, mesh))
    total = 0
    for path, s in flatten(tmpl).items():
        spec = specs[path]
        if path in skip or not any("data" in _names(e) for e in spec):
            continue
        loc = list(local_shape(s.shape, spec, mesh))
        for i, e in enumerate(spec):
            if "data" in _names(e):
                loc[i] *= mesh.shape["data"]
        n = math.prod(loc) * 4
        again = path.startswith(("blocks.", "mtp.block.", "encoder.blocks."))
        total += n * (2 if remat_twice and again else 1)
    return total


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_v3_671b",
                                  "seamless_m4t_large_v2"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_data_line_gathers_are_the_zero_leaves(arch, kind):
    """The recorded data-line ``all-gather`` bytes equal the sum of the
    rank's ZeRO-gathered leaves computed from the specs: in train each
    layer's weights as it runs and again in its group's recompute, the
    embedding, head and dense head layers once; at serving every leaf
    the step reads, once."""
    cfg = get_config(arch).reduced()
    orig = dryrun.get_config, dryrun.INPUT_SHAPES
    dryrun.get_config = lambda a: cfg
    dryrun.INPUT_SHAPES = {"x": InputShape("x", 64, 4, kind)}
    try:
        mesh = TrainingMesh(("meta",) * 4, ("data", "model"), (2, 2))
        c = dryrun.count_step(dryrun.build_lowering(arch, "x", mesh))
    finally:
        dryrun.get_config, dryrun.INPUT_SHAPES = orig
    tmpl = flatten(Model(cfg, device="meta").template)
    skip = () if kind == "train" else \
        set(dryrun.unread_weights(cfg, kind, tmpl))
    assert c.coll_by_line[("data", "all-gather")] == \
        _zero_gathered(cfg, mesh, kind == "train", skip)


def test_roofline_uses_the_h100_peaks():
    """The roofline keeps JAX's formula on the port's constants: one
    H100 SXM's data-sheet peaks, no TPU figure."""
    assert (port_mesh.PEAK_FLOPS_BF16, port_mesh.HBM_BW,
            port_mesh.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = analysis.roofline(989e12, 3.35e12 * 2, 450e9 * 3, 256)
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == \
        (1.0, 2.0, 3.0)
    assert r["dominant"] == "collective"


def test_meta_model_draws_nothing():
    """``Model(cfg, device="meta")`` builds the whole template on
    ``meta`` without a generator; on a serving mesh a rank's slices."""
    from repro_torch.launch.mesh import ServingMesh
    cfg = get_config("deepseek_v3_671b")
    whole = Model(cfg, device="meta")
    assert sum(p.numel() for p in whole.parameters()) == \
        whole.param_count()
    rank = Model(cfg, device="meta", mesh=ServingMesh(("meta",) * 16))
    held = sum(p.numel() for p in rank.parameters())
    assert held < whole.param_count() / 8
    assert all(p.device.type == "meta" for p in rank.parameters())


def test_no_jax_in_the_cost_modules():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.analysis, repro_torch.launch.op_cost; "
            "assert not any(m in ('jax', 'repro') or m.startswith(("
            "'jax.', 'repro.')) for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_cli_prints_jax_keys(tmp_path, capsys):
    """The CLI at one production case, single and multi pod, with and
    without ``--flash``: JAX's result keys, one line a case, JAX's last
    line."""
    out = tmp_path / "dry.jsonl"
    rc = dryrun.main(["--arch", "minicpm_2b", "--shape", "decode_32k",
                      "--mesh", "both", "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "2 lowered+compiled OK, 0 failed" in text
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16"]
    keys = {"arch", "shape", "mesh", "chips", "hbm_per_device_gb",
            "flops_per_device", "bytes_per_device", "collective_bytes",
            "collective_counts", "compute_s", "memory_s", "collective_s",
            "dominant", "model_flops_per_chip", "useful_flops_ratio",
            "compile_time_s"}
    for r in rows:
        assert set(r) == keys
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert 0 < r["useful_flops_ratio"] <= 1
        assert np.isfinite(r["hbm_per_device_gb"])
    assert rows[0]["chips"] == 256 and rows[1]["chips"] == 512
    assert dryrun.main(["--arch", "minicpm_2b", "--shape", "decode_32k",
                        "--flash"]) == 0


def test_trace_limit_reports_not_run(capsys):
    """A case whose trace passes ``--max-seconds`` is stopped and listed
    as failed with its cause."""
    rc = dryrun.main(["--arch", "minicpm_2b", "--shape", "train_4k",
                      "--max-seconds", "1e-9"])
    text = capsys.readouterr().out
    assert rc == 1 and "not run: the trace passed" in text
    assert "0 lowered+compiled OK, 1 failed" in text
