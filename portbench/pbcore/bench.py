"""The harness's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names by name under ``portbench/``:

* ``configs/<config>.json``: a configuration (the program's architecture
  name, its sizes, dtype, source, ``reduced``, ``assumed``);
* ``traffic/<traffic>.json``: a traffic mix, read by the one generator
  of its ``kind``;
* ``limits/<cell>.json``: the limit of each number a cell's output check
  compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns the metric's value or None where it finds nothing.

A later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                  # the checkout
#: top-level modules that the process printing a result may not hold
BARRED = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files of one cell."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "portbench"

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: Dict) -> Dict:
        return load_json(self.dir / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: Dict) -> Dict[str, float]:
        return load_json(self.dir / "limits" / f"{cell['name']}.json")

    def _reports(self, metric: Dict, cell: Dict) -> bool:
        return cell["name"] in metric.get("workloads", [cell["name"]])

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: Dict) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"] if self._reports(m, cell)
                and m["moves"] in e2e]

    def reader(self, metric: Dict):
        """The ``read`` function of ``metrics/<name>.py``."""
        path = self.dir / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def barred_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``BARRED``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in BARRED})


def device_info(device, count: int = 1) -> Dict:
    """The result's device: the card's name, or the CPU where a test
    drives a run there."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def number(x: float) -> Optional[float]:
    """A finite float for the result's JSON, else None."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else None


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each number a cell's check compares beside
    its limit, and whether every one lies within it.  A number that is
    missing or not finite fails, and so does a check with no limits."""
    checks = {k: {"value": number(numbers.get(k, math.inf)), "limit": v}
              for k, v in limits.items()}
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks
