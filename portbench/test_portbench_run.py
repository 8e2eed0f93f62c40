"""The harness end to end on the CPU: it refuses a machine without a
card and a checkout without the program, loads neither JAX nor the JAX
package nor anything under benchmarks/, and its output check fails a run
whose served tokens were altered where the program produced them."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--workload", "minicpm_2b.chat", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def run_py(cwd: Path, env_path=True):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    if env_path:
        env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=env)


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    out = run_py(tmp_path, env_path=False)
    assert out.returncode != 0
    assert "{" not in out.stdout


PROBE = r"""
import json, sys
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.append(args[0])
sys.addaudithook(hook)
import importlib.util
spec = importlib.util.spec_from_file_location("portbench_run", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import pbcore.serve, pbcore.kerneltime, pbcore.trace, pbcore.reference, pbcore.testing
import pbcore.train, pbcore.reftrain
cfg = pbcore.serve.program_config(pbcore.testing.DENSE)
from repro_torch.serving import AsyncFrontend, GraphServer, LLMEngine
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_imports_no_jax_and_reads_no_benchmarks_folder():
    out = subprocess.run([sys.executable, "-c", PROBE,
                          str(ROOT / "portbench" / "run.py")],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    top = set(seen["modules"])
    assert "repro_torch" in top and "pbcore" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    bench_dir = str(ROOT / "benchmarks")
    assert not [p for p in seen["opened"] if p.startswith(bench_dir)
                or p.startswith("benchmarks/")]


FAULT = r"""
import importlib.util, json, sys, types
import numpy as np
from repro_torch.serving.engine import LLMEngine
spec = importlib.util.spec_from_file_location("portbench_run", sys.argv[1])
run_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run_mod)
from pbcore import testing
from pbcore.bench import Bench
if sys.argv[2] == "altered":
    decode = LLMEngine.decode

    def broken(self, backend, cache, last, positions, active,
               block_tables=None):
        out, cache = decode(self, backend, cache, last, positions, active,
                            block_tables)
        rows = np.nonzero(np.asarray(active))[0]
        if rows.size:
            out = out.copy()
            out[rows[0]] = (out[rows[0]] + 1) % 512
        return out, cache
    LLMEngine.decode = broken
bench = Bench(run_mod.ROOT)
cell = bench.cell("minicpm_2b.chat")
args = types.SimpleNamespace(seed=2**32 + 1, seconds=1.0, trace=0)
result, code = run_mod.run_cell(args, bench, cell, testing.spec(),
                                  testing.mix(), {"logit_gap": 0.01},
                                  device="cpu")
print(json.dumps({"code": code, "result": result}))
"""


@pytest.mark.parametrize("altered", [False, True])
def test_output_check_fails_an_altered_token(altered):
    """A run driven on the CPU in a process of its own, the card's look
    skipped; with ``altered`` the engine's decode tick returns one row's
    token plus one, where the token is produced."""
    out = subprocess.run([sys.executable, "-c", FAULT,
                          str(ROOT / "portbench" / "run.py"),
                          "altered" if altered else "sound"],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    result = seen["result"]
    assert seen["code"] == 0 and result["attempted"] > 0
    assert result["correct"] is (not altered)
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms",
                                      "output_tok_s", "setup_s"}


TRAIN_FAULT = r"""
import importlib.util, json, sys, types
import torch
import repro_torch.runtime.steps as steps
spec = importlib.util.spec_from_file_location("portbench_run", sys.argv[1])
run_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run_mod)
from pbcore import testing
from pbcore.bench import Bench
fault = sys.argv[2]
make = steps.make_train_step


def broken(model, **kw):
    step, init = make(model, **kw)

    def unchanged(state, batch):
        with torch.no_grad():
            _, metrics = step.loss_fn(state.params, batch)
        return state, metrics

    def half(state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return {"sound": step, "unchanged": unchanged, "half": half}[fault], init


steps.make_train_step = broken
bench = Bench(run_mod.ROOT)
cell = bench.cell("minicpm_2b.train")
mix = dict(bench.traffic(cell), batch=2, seq=16)
args = types.SimpleNamespace(seed=2**32 + 3, seconds=1.0, trace=0)
result, code = run_mod.run_cell(args, bench, cell, testing.spec(), mix,
                                {"loss_gap": 0.002, "grad_gap": 0.01,
                                 "update_gap": 0.01}, device="cpu")
print(json.dumps({"code": code, "result": result}))
"""


@pytest.mark.parametrize("fault", ["sound", "unchanged", "half"])
def test_training_check_fails_a_broken_step(fault):
    """A training run driven on the CPU at a tiny size, the card's look
    skipped, with the program's step returning its state unchanged or
    taking the mean over half of each batch: ``correct`` is false, and
    true for the sound step."""
    out = subprocess.run([sys.executable, "-c", TRAIN_FAULT,
                          str(ROOT / "portbench" / "run.py"), fault],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    result = seen["result"]
    assert seen["code"] == 0 and result["attempted"] > 3
    assert result["correct"] is (fault == "sound")
    assert set(result["metrics"]) == {"train_tok_s", "setup_s"}
    assert list(result)[-1] == "checks"
