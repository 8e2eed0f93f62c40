"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload minicpm_2b.chat --seed 7 \
        --seconds 30 --trace 0

Runs on the machine it is started on, from the root of a checkout that
holds the program (``src/repro_torch``).  Set-up (imports, CUDA, the
kernels' library from ``build/kernels/``, the weights drawn on the card
from ``--seed``, the server and a warm-up of the cell's shapes; for a
training cell the step object and its first, checked steps) is
``setup_s``; the window then runs ``--seconds``.  ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from
a run with spans and the profiler on.  Every run holds what its timed
path produced (a sample of the requests served, or the checked steps)
against the plain reference and prints each number compared beside its
limit.  The last line of standard output is the
result, a JSON object.  Without a CUDA device, or with fewer than the
cell asks for, it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]

from pbcore import bench as bench_mod  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


#: the run class of each kind of traffic mix (module, class)
DRIVERS = {"serve": ("pbcore.serve", "ServeRun"),
           "train": ("pbcore.train", "TrainRun")}


def run_cell(args, bench, cell, spec, mix, limits, device="cuda"):
    """Set-up, the window and the output check of one run; the result
    and 0, or None and an exit code."""
    import importlib
    module, name = DRIVERS[mix["kind"]]
    run = getattr(importlib.import_module(module), name)(
        spec, mix, args.seed, args.seconds, bool(args.trace), device)
    run.setup()
    run.window()
    setup_s = run.t0 - T_START
    barred = bench_mod.barred_modules()
    if barred:
        return None, fail(f"loaded after the window: {barred}", 3)
    e2e = run.end_to_end()
    e2e["setup_s"] = setup_s
    run.close()
    metrics = {}
    if args.trace:
        for m in bench.per_layer(cell):
            value = bench.reader(m)(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell):
            metrics[m["name"]] = {"value": bench_mod.number(e2e[m["name"]]),
                                  "unit": m["unit"]}
    correct, checks = bench_mod.verdict(run.check(), limits)
    device = dict(bench_mod.device_info(run.device, cell["chips"]),
                  memory_peak_bytes=run.memory_peak)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if args.trace:
        prof = run.profile
        device["busy_s"] = prof["busy_s"] if prof else None
        device["window_s"] = prof["window_s"] if prof else None
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    for line in run.report():
        print(line, file=sys.stderr)
    result["checks"] = checks
    return result, 0


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no program at {ROOT / 'src' / 'repro_torch'}")
    bench = bench_mod.Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    # one intra-op thread: the host path is Python and small launches,
    # and idle pool threads only contend with it
    torch.set_num_threads(1)
    spec, mix = bench.config(cell), bench.traffic(cell)
    limits = bench.limits(cell)
    if mix["kind"] not in DRIVERS:
        return fail(f"no driver for traffic of kind {mix['kind']!r}")
    result, code = run_cell(args, bench, cell, spec, mix, limits)
    if result is None:
        return code
    barred = bench_mod.barred_modules()
    if barred:
        return fail(f"loaded in the process printing the result: {barred}",
                    3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
