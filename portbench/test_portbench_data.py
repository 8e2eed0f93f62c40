"""The harness is driven by data: every cell, configuration, mix, limit
and metric reader is found by its name in BENCHMARK.json, a further cell
is files and entries alone, and the yardstick's formulas hold the
kernel bounds that the port's kernel table lists."""
import json
import re
import shutil
from pathlib import Path

import pytest

from pbcore import costs
from pbcore.bench import Bench, barred_modules
from pbcore.weights import param_count

ROOT = Path(__file__).resolve().parents[1]
BENCH = Bench(ROOT)
DRIVERS = ("serve", "train")
#: the numbers each kind of check may compare
COMPARED = {"serve": {"logit_gap", "logit_gap_mean"},
            "train": {"loss_gap", "grad_gap", "update_gap"}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cells():
    return [w["name"] for w in BENCH.spec["workloads"]]


@pytest.mark.parametrize("name", cells())
def test_cell_files_found_by_name(name):
    cell = BENCH.cell(name)
    spec, mix = BENCH.config(cell), BENCH.traffic(cell)
    assert spec["dtype"] == "bfloat16" and mix["kind"] in DRIVERS
    limits = BENCH.limits(cell)
    assert limits and set(limits) <= COMPARED[mix["kind"]]
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = BENCH.per_layer(cell)
    assert layers
    for m in layers:
        assert callable(BENCH.reader(m))
        assert m["moves"] in e2e


def test_benchmark_json_keeps_the_contract():
    b = BENCH.spec
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1].startswith("portbench/")
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        spec = json.loads((ROOT / c["file"]).read_text())
        assert sorted(spec["reduced"]) == sorted(c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    all_names = names + cells() + [m["name"] for m in metrics]
    assert len(all_names) == len(set(all_names))
    for n in all_names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in cells()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert "workloads" in m
        layers.setdefault(m["layer"], m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_is_data_alone(tmp_path):
    """A further cell (a new mix and a new metric reader) is found without
    an edit to any file the benchmark has."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "portbench/traffic/chat.json").read_text())
    mix.update(clients=8, slots=8)
    (tmp_path / "portbench/traffic/chat8.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/limits/minicpm_2b.chat8.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    (tmp_path / "portbench/metrics/slots_seen.py").write_text(
        "def read(run):\n    return run.mix['slots']\n")
    b["workloads"].append({"name": "minicpm_2b.chat8", "config": "minicpm_2b",
                           "traffic": "chat8", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "slots_seen", "unit": "slots",
                           "better": "higher", "source": "program_counter",
                           "layer": "Scheduler and KV cache",
                           "moves": "output_tok_s",
                           "workloads": ["minicpm_2b.chat8"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("minicpm_2b.chat8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    bench = Bench(tmp_path)
    cell = bench.cell("minicpm_2b.chat8")
    assert bench.traffic(cell)["slots"] == 8
    metrics = {m["name"]: m for m in bench.per_layer(cell)}
    run = type("Run", (), {"mix": {"slots": 8}})()
    assert bench.reader(metrics["slots_seen"])(run) == 8


def test_barred_modules_compare_whole_names():
    assert barred_modules(["repro_torch.models", "jaxtyping", "reprox"]) \
        == []
    assert barred_modules(["repro.models", "jax", "flax.linen"]) == \
        ["flax.linen", "jax", "repro.models"]


def test_k3_bounds_of_the_kernel_table():
    """PERF.md's kernel table: K3 [2, 18, 36, 64] causal 0.000198 ms, the
    serve chunk [1, 256, 36, 64] at 512 0.002817 ms (bytes), qwen3's
    prefill [1, 1024, 64 over 8, 128] 0.01739 ms (operations)."""
    cases = [((2, 18, 18, 36, 36, 64, 0), 0.000198),
             ((1, 256, 768, 36, 36, 64, 512), 0.002817),
             ((1, 1024, 1024, 64, 8, 128, 0), 0.01739)]
    for args, ms in cases:
        got = costs.bound_s(*costs.flash_attention_cost(*args)) * 1e3
        assert got == pytest.approx(ms, rel=2e-3)


def test_k2_bound_of_the_kernel_table():
    """qwen3's K2 row, 4 rows of 4096 keys, 64 heads over 8 of 128, block
    16 over a 4096-position table: 0.02008 ms (bytes).  The serve rows'
    bounds (4 rows of 300-930 keys) are not listed with their positions,
    so they are not reproduced."""
    flops, nbytes = costs.flash_decode_cost([4095] * 4, 64, 8, 128, 256)
    assert costs.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.02008,
                                                              rel=2e-3)


def test_published_sizes():
    """minicpm_2b: 2.72 B parameters; granite_moe_3b_a800m: 3.30 B."""
    spec = json.loads((ROOT / "portbench/configs/minicpm_2b.json")
                      .read_text())
    assert param_count(spec) / 1e9 == pytest.approx(2.72, abs=0.01)
    spec = json.loads((ROOT / "portbench/configs/granite_moe_3b_a800m.json")
                      .read_text())
    assert param_count(spec) / 1e9 == pytest.approx(3.30, abs=0.01)
