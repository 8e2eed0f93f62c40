"""The readings a serving cell's output limits are set from, on the card:
the program's served-token gaps over many seeds (the lower readings) and
the fp8 control's on the same prompts and served tokens (the upper
readings), each judged by the cell's limits (``limits/<cell>.json``) as
a run judges it.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload minicpm_2b.chat \
        --seeds 101 102 103 --seconds 10 --control-seeds 3

Each seed is a short window of the cell at its own load, in one process
(a training cell: its checked steps, a short window, and the control
and the half-batch fault put in the program's place);
a JSON line a seed with the numbers a check may compare (``compared``)
and the verdict on them (``correct``: the program's has to be true, the
control's false), then a summary line.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]

from pbcore.bench import Bench, verdict  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the control on the first this many seeds")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from pbcore.serve import ServeRun, compared
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    spec, mix = bench.config(cell), bench.traffic(cell)
    limits = bench.limits(cell)
    if mix["kind"] == "train":
        return train_readings(args, spec, mix, limits)
    lows, highs = [], []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = ServeRun(spec, mix, seed, args.seconds, False)
        run.setup()
        run.window()
        run.close()
        reqs = run.sample()
        line = {"seed": seed, "attempted": run.attempted,
                "failed": run.failed,
                "program": compared(run.gaps(reqs=reqs))}
        line["program_correct"] = verdict(line["program"], limits)[0]
        line["looks"] = dict(run.looks)
        lows.append(line["program"])
        if i < args.control_seeds:
            line["control"] = compared(run.gaps("fp8", reqs=reqs))
            line["control_correct"] = verdict(line["control"], limits)[0]
            highs.append(line["control"])
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(x[k] for x in lows) for k in lows[0]},
        "upper": {k: min(x[k] for x in highs) for k in highs[0]}
        if highs else None}), flush=True)
    return 0


def train_readings(args, spec, mix, limits) -> int:
    """A training cell: each seed's program readings against the
    reference's, and on the first ``--control-seeds`` seeds the fp8
    control's and the half-batch fault's, planted in the reference put
    in the program's place."""
    import torch
    from pbcore.reftrain import train_numbers
    from pbcore.train import TrainRun
    lows, highs = [], []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = TrainRun(spec, mix, seed, args.seconds, False)
        run.setup()
        run.window()
        run.close()
        ref = run.reference()
        line = {"seed": seed, "steps": run.attempted,
                "loss": run.readings["loss"], "ref_loss": ref["loss"],
                "program": train_numbers(run.readings, ref)}
        line["program_correct"] = verdict(line["program"], limits)[0]
        lows.append(line["program"])
        if i < args.control_seeds:
            for name, kw in (("control", {"quant": "fp8"}),
                             ("half_batch", {"half_batch": True})):
                got = train_numbers(run.reference(**kw), ref)
                line[name] = got
                line[name + "_correct"] = verdict(got, limits)[0]
            highs.append(line["control"])
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run, ref
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({
        "lower": {k: max(x[k] for x in lows) for k in lows[0]},
        "upper": {k: min(x[k] for x in highs) for k in highs[0]}
        if highs else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
