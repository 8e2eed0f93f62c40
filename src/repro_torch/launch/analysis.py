"""Dry-run analysis: memory, op cost, collective bytes, roofline — the
JAX package's ``launch/analysis.py`` on the port's counter.

JAX reads a compiled module (``memory_analysis``, the HLO text); the port
reads an :class:`~repro_torch.launch.op_cost.OpCounter` that watched
rank 0's step run on ``meta`` tensors.  The roofline terms keep JAX's
formula, with one H100's peaks (``launch/mesh.py``):

    compute    = FLOPs / peak bf16 FLOP/s
    memory     = HBM bytes / HBM bytes/s
    collective = collective bytes / one link's bytes/s

JAX's ``cost_stats`` has no counterpart: it reads XLA's
``cost_analysis``, which counts a ``while`` body once, and the counter
counts every op a Python loop runs, so there is nothing to correct.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from .op_cost import COLLECTIVES, OpCounter

#: the sliding window of the pure-attention architectures at long_500k
LONG_WINDOW = 8192


def adjusted_config(cfg, shape_name: str):
    """The long_500k policy: pure-attention architectures run the
    sliding-window variant; SSM and hybrid stacks run natively."""
    if shape_name == "long_500k" and not cfg.sub_quadratic \
            and cfg.family != "hybrid":
        cfg = dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    return cfg


def collective_bytes(counter: OpCounter) -> Dict[str, float]:
    """Output bytes per collective kind over the step, ``count`` (the
    calls) and ``total``."""
    out = {k: counter.coll[k] for k in COLLECTIVES}
    out["count"] = counter.coll_calls
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def memory_stats(counter: OpCounter, argument_bytes: float,
                 output_bytes: float = 0.0, alias_bytes: float = 0.0,
                 gather_bytes: float = 0.0) -> Dict[str, float]:
    """JAX's keys, per device: ``argument_size_in_bytes`` (what the rank
    holds going in), ``output_size_in_bytes``, ``alias_size_in_bytes``
    (outputs written in place into arguments: a train state, a decode
    cache), ``temp_size_in_bytes`` (the peak of the storages the step
    allocates, its new outputs included, plus ``gather_bytes``: weights
    gathered whole for a layer beyond what the rank holds of them) and
    ``total_per_device``, argument + temp (a new output is live at the
    step's end, so it is in temp already)."""
    out = {"argument_size_in_bytes": float(argument_bytes),
           "output_size_in_bytes": float(output_bytes),
           "temp_size_in_bytes": float(counter.peak_bytes + gather_bytes),
           "alias_size_in_bytes": float(alias_bytes),
           "generated_code_size_in_bytes": 0.0}
    out["total_per_device"] = (out["argument_size_in_bytes"]
                               + out["temp_size_in_bytes"])
    return out


def roofline(flops: float, bytes_hbm: float, bytes_coll: float,
             chips: int, per_device: bool = True) -> Dict[str, float]:
    """Roofline terms in seconds.  The counter's numbers are one rank's
    already (it counts rank 0's program); ``chips`` is kept for the
    callers' model-FLOPs ratio, as in JAX."""
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_hbm / HBM_BW
    coll_s = bytes_coll / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant}


def model_flops(cfg, shape, mtp: bool = False) -> float:
    """Analytic 6·N_active·D for the step (train: fwd+bwd; decode: 2·N·D)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
