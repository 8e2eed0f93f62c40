"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU.

Each runs in a subprocess through a runner that reads, after the run,
which modules it imported: none of ``jax`` or ``repro`` (the JAX
package).  The three perception examples print the lines of their JAX
scripts, run in the same test (but the timelines and histograms and
the tracked frames' detection counts, which are timing-dependent), and
keep to the copy rule: apart from imports and
docstrings they are the JAX scripts line for line.  The LLM examples
run with ``--device cpu``: the serve example answers its 24 requests,
the train example's loss falls in 40 steps.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

from test_torch_graph import _copy_faults

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PERCEPTION = ("quickstart", "face_landmark", "object_detection")
LLM = ("serve_llm", "train_lm")

#: runs the script named by argv[1] with the rest of argv as its own,
#: then prints the jax / repro modules it imported and exits with the
#: script's code
RUNNER = """
import runpy, sys
path = sys.argv[1]
sys.argv = [path] + sys.argv[2:]
try:
    runpy.run_path(path, run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code or 0
print("IMPORTED", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "repro")))
sys.exit(code)
"""


def _run(script, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-c", RUNNER, str(EXAMPLES / script), *args],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=str(ROOT))


def _torch_run(script, *args, timeout=120):
    """The torch example's stdout; it exits 0 having imported neither
    jax nor repro."""
    r = _run(script, *args, timeout=timeout)
    assert r.returncode == 0, f"{script}: rc {r.returncode}\n" \
        f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    assert "IMPORTED []" in r.stdout.splitlines(), r.stdout[-500:]
    return r.stdout


#: object_detection's per-frame detection counts: on the frames the
#: detector runs (every 4th) they are its detections, on the others the
#: tracker's, whose RESET loopback races the frames (the JAX script run
#: 16 times at once on one host printed 4 lists that differed at
#: tracked frames); only the detector frames' counts are compared
_PER_FRAME = re.compile(r"^(.*detections per frame: )(\[.*\])$")


def _deterministic(text):
    """The lines of an example's output but its trace: a timeline block
    (from ``timeline (`` to the next blank line), the runner's own line,
    and the tracked frames' detection counts (``_PER_FRAME``)."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith("timeline ("):
            skip = True
        elif not line.strip():
            skip = False
        if skip or line.startswith("IMPORTED "):
            continue
        m = _PER_FRAME.match(line)
        if m:
            counts = ast.literal_eval(m.group(2))
            line = f"{m.group(1)}{len(counts)} frames, detector frames " \
                f"{counts[::4]}"
        out.append(line)
    return out


@pytest.mark.parametrize("name", PERCEPTION)
def test_perception_example_prints_the_jax_lines(name):
    got = _torch_run(f"torch_{name}.py")
    ref = _run(f"{name}.py")
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert _deterministic(got) == _deterministic(ref.stdout)
    assert f"{name} OK" in got.splitlines()
    assert any("[out]" in ln for ln in got.splitlines())


@pytest.mark.parametrize("name", PERCEPTION)
def test_perception_example_is_a_copy(name):
    ref = (EXAMPLES / f"{name}.py").read_text().replace(
        "repro.", "repro_torch.")
    port = (EXAMPLES / f"torch_{name}.py").read_text()
    faults = _copy_faults(f"examples/torch_{name}.py", ref, port, set())
    assert not faults, "\n".join(faults)


def test_serve_example_on_the_cpu():
    out = _torch_run("torch_serve_llm.py", "--device", "cpu")
    assert "served 24/24 requests" in out, out[-2000:]


def test_train_example_on_the_cpu(tmp_path):
    out = _torch_run("torch_train_lm.py", "--device", "cpu", "--steps",
                     "40", "--checkpoint-dir", str(tmp_path), timeout=300)
    assert "(improved)" in out, out[-2000:]
    assert (tmp_path / "step_00000040").exists()


@pytest.mark.parametrize("name", LLM)
def test_llm_example_passes_the_jax_arguments(name):
    """The torch LLM example forwards its JAX script's argv to the port's
    launcher (the train script's checkpoint directory its own); both
    default to the card."""
    def argv(path):
        """The script's string constants but its docstring, in order."""
        body = ast.parse(path.read_text()).body[1:]
        return [n.value for stmt in body for n in ast.walk(stmt)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)]

    ref = argv(EXAMPLES / f"{name}.py")
    port = argv(EXAMPLES / f"torch_{name}.py")
    assert port == [a.replace("/tmp/repro_ckpt", "/tmp/repro_torch_ckpt")
                    for a in ref]
    assert "--device" not in port
    text = (EXAMPLES / f"torch_{name}.py").read_text()
    launcher = "serve" if name == "serve_llm" else "train"
    assert f"from repro_torch.launch.{launcher} import main" in text


def test_no_torch_example_imports_jax_or_repro():
    for path in sorted(EXAMPLES.glob("torch_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (path, n)
    assert {p.name for p in EXAMPLES.glob("torch_*.py")} == \
        {f"torch_{n}.py" for n in PERCEPTION + LLM}
