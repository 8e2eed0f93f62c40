"""The production-mesh dry run: the JAX package's ``launch/dryrun.py`` on
the port, on the CPU, with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm_2b \\
        --shape decode_32k --mesh single

For every architecture x ``INPUT_SHAPES`` entry x production mesh
(``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
``("pod", "data", "model")``), rank 0's program runs once on ``meta``
tensors under an :class:`~repro_torch.launch.op_cost.OpCounter` (where
JAX lowers and compiles the step for 512 placeholder host devices), and
the line reports JAX's keys: per-device memory, FLOPs, HBM bytes,
collective bytes by kind, the three roofline terms with one H100's peaks,
the dominant term and ``useful_flops_ratio`` (the analytic model FLOPs
over the FLOPs the step dispatches).  ``compile_time_s`` holds the
trace's wall seconds (building rank 0 and running its step on ``meta``).
No HLO file is written: the port has none.

Rank 0's program:

* **train** shapes: rank 0 of the port's own training mesh
  (``runtime/train_mesh.py``'s ``Rank`` on ``make_production_mesh(
  devices=["meta"] * n)``): ZeRO over data, the model axis under
  autograd, ``moe_impl="ep"``, JAX's optimizer and schedule and
  ``remat="group"``; its lines are recording stand-ins
  (``sharding/group.py``'s ``RecordingGroup``).
* **prefill** and **decode** shapes: the port's tensor-parallel serving
  rank at tp = the mesh's ``model`` size (heads, FFN columns, experts,
  mixer channels and vocabulary; K/V by ``_kv_cache_axes``' preference of
  kv heads, then head_dim, then the sequence), serving the rows
  ``batch_specs`` gives rank 0 over the batch axes.  Its weights are held
  as ``param_specs`` cut them on the production mesh, ``embed→data``
  included: each data-cut weight is gathered whole before use, recorded
  as ``all-gather`` bytes on the data line (the training mesh's ZeRO
  forward gathers its weights so).  The peak counts those gathers layer
  by layer: the largest layer group's gathered weights, beyond the
  slices held of them, are added once to the step's own peak.  The MoE
  layers run the serving rank's expert-parallel dispatch (its experts'
  terms summed over the model line), the function of JAX's
  ``moe_impl="ep"`` decode branch.

The flags are JAX's ``RuntimeFlags()`` defaults: every kernel off
(``use_flash`` from ``--flash``), whatever the port's own defaults are.
The kernels have no backward, so a train shape runs the plain path under
``--flash`` too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import ALL_ARCHS, get_config
from ..models.config import INPUT_SHAPES
from ..models.model import Model
from ..models.params import flatten
from ..models.transformer import RuntimeFlags, group_structure
from ..optim import make_schedule
from ..runtime.steps import make_decode_step, make_prefill_step
from ..runtime.train_mesh import Rank
from ..sharding.group import RecordingCollectives
from ..sharding.rules import (_batch_axes, _entry_slice, _names,
                              batch_specs, local_shape, param_specs)
from .analysis import (LONG_WINDOW, adjusted_config, collective_bytes,
                       memory_stats, model_flops, roofline)
from .mesh import ServingMesh, make_production_mesh
from .op_cost import OpCounter, TraceTimeout, nbytes

__all__ = ["LONG_WINDOW", "adjusted_config", "build_lowering", "count_step",
           "dryrun_one", "main", "plain_flags", "production_mesh",
           "unread_weights"]


#: a case whose trace passes this many seconds is stopped and reported
#: as not run, with its cause (xlstm_1_3b's token loops at train_4k and
#: prefill_32k)
MAX_SECONDS = 600.0


def plain_flags(flash: bool = False) -> RuntimeFlags:
    """JAX's ``RuntimeFlags()`` defaults: every kernel off but
    ``use_flash``, which ``--flash`` sets."""
    return RuntimeFlags(use_flash=flash, fused_rmsnorm=False,
                        use_fused_decode=False, use_paged_kernel=False,
                        fused_split_k=False, cuda_graphs=False)


def production_mesh(multi_pod: bool = False):
    """JAX's production mesh over ``meta`` devices, one per rank."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a nested dict / tuple / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return nbytes(tree)
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


@dataclasses.dataclass
class DryStep:
    """Rank 0's step, ready to run on ``meta`` tensors: ``run()`` runs it
    once (under a counter); ``arguments`` are the bytes rank 0 holds
    going in, by argument (JAX's ``argument_size_in_bytes`` is their
    sum); ``outputs`` and ``aliased`` the bytes of its outputs and of the
    outputs written in place; ``gathers`` the weights rank 0 gathers
    whole before use ({unit: (gathered, held)} bytes, a unit a layer
    group or a top-level leaf) and ``record_gathers`` records them."""
    cfg: Any
    shape: Any
    run: Any
    arguments: Dict[str, int]
    outputs: int = 0
    aliased: int = 0
    gathers: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    recorder: Optional[RecordingCollectives] = None

    def record_gathers(self) -> None:
        for gathered, held in self.gathers.values():
            if gathered > held:
                self.recorder.record("all-gather", "data", gathered, held)

    def gather_peak(self) -> int:
        """The largest unit's gathered bytes beyond what is held of it."""
        return max((g - h for g, h in self.gathers.values()), default=0)


def _rows(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Rank 0's rows of each batch entry (``batch_specs``)."""
    specs = batch_specs({k: tuple(v.shape) for k, v in batch.items()}, mesh)
    out = {}
    for k, v in batch.items():
        entry = specs[k][0] if specs[k] else None
        if entry is not None:
            idx, count = _entry_slice(mesh, entry, 0)
            n = v.shape[0] // count
            v = v[idx * n:(idx + 1) * n]
        out[k] = v
    return out


def unread_weights(cfg, kind: str, paths) -> List[str]:
    """The weights a serving step of ``kind`` does not read: the MTP
    head, and at decode an encoder-decoder's encoder and its cross
    attention's key and value projections (the memory's K/V are in the
    cache).  JAX's jit drops such arguments (``keep_unused=False``); the
    serving rank holds them and gathers none of them."""
    out = [p for p in paths if p.startswith("mtp.")]
    if kind == "decode" and cfg.is_encoder_decoder:
        out += [p for p in paths if p.startswith("encoder.")
                or (".cross." in p and p.rsplit(".", 1)[-1] in ("wk", "wv"))]
    return out


def _gathers(model: Model, mesh, kind: str) -> Dict[str, tuple]:
    """Each unit's (gathered, held) bytes: a weight the production
    ``param_specs`` cut on data is held at its cut and gathered to the
    serving rank's slice, where the step reads it; a stacked ``blocks``
    leaf's unit is its layer group (one slice of its leading axis), any
    other leaf's its first two path components."""
    specs = flatten(param_specs(model.template, mesh))
    whole = flatten(model.template)
    skip = set(unread_weights(model.cfg, kind, whole))
    _, _, R = group_structure(model.cfg)
    units: Dict[str, list] = {}
    for path, t in dict(model.named_parameters()).items():
        if path in skip:
            continue
        spec = specs[path]
        if not any("data" in _names(e) for e in spec):
            continue
        held = math.prod(local_shape(whole[path].shape, spec, mesh)) * \
            t.element_size()
        if path.startswith("blocks.") and R:
            for r in range(R):
                u = units.setdefault(f"blocks[{r}]", [0, 0])
                u[0] += nbytes(t) // R
                u[1] += held // R
        else:
            u = units.setdefault(".".join(path.split(".")[:2]), [0, 0])
            u[0] += nbytes(t)
            u[1] += held
    return {k: tuple(v) for k, v in units.items()}


def _held_bytes(model: Model, mesh) -> int:
    """The bytes of rank 0's weights as the production ``param_specs``
    cut them."""
    specs = flatten(param_specs(model.template, mesh))
    return sum(math.prod(local_shape(spec.shape, specs[path], mesh))
               * model.get_parameter(path).element_size()
               for path, spec in flatten(model.template).items())


def build_lowering(arch: str, shape_name: str, mesh,
                   flags: Optional[RuntimeFlags] = None) -> DryStep:
    """Rank 0's step of ``arch`` at ``shape_name`` on ``mesh`` (a
    ``TrainingMesh`` over ``meta`` devices), with JAX's flags for it:
    the mesh's batch axes, ``moe_impl="ep"`` and the model axis."""
    flags = flags or plain_flags()
    batch_axes = _batch_axes(mesh)
    divisor = math.prod(mesh.shape[a] for a in batch_axes)
    mp = mesh.shape["model"]
    cfg = adjusted_config(get_config(arch), shape_name)
    shape = INPUT_SHAPES[shape_name]
    whole = Model(cfg, device="meta")
    batch = whole.input_shapes_for(shape)

    if shape.kind == "train":
        flags = dataclasses.replace(
            flags, use_flash=False, batch_axes=batch_axes,
            batch_divisor=divisor, moe_impl="ep", model_axis="model",
            model_size=mp)
        rank = Rank(RecordingCollectives(mesh, 0),
                    {"cfg": cfg, "mesh": mesh, "optimizer": cfg.optimizer,
                     "flags": flags, "tag": "dryrun"})
        state = rank.init(None, 0)
        schedule = make_schedule(cfg.lr_schedule, peak_lr=3e-4,
                                 warmup=100, total=10_000)
        lr = schedule(state.opt.step + 1)
        rows = _rows(batch, mesh)
        state_bytes = tree_bytes(state.params) + tree_bytes(
            (state.opt.m, state.opt.v))
        return DryStep(
            cfg, shape, lambda: rank.step(state, batch, lr),
            {"params+opt": state_bytes, "step": nbytes(state.opt.step),
             **{k: nbytes(v) for k, v in rows.items()}},
            outputs=state_bytes + nbytes(state.opt.step),
            aliased=state_bytes)

    # serving: the tensor-parallel rank at tp = the model axis
    recorder = RecordingCollectives(mesh, 0)
    serving = ServingMesh(("meta",) * mp) if mp > 1 else None
    model = Model(cfg, device="meta", mesh=serving, rank=0)
    tp = RecordingCollectives(serving, 0) if serving is not None else None
    flags = dataclasses.replace(flags, decode_shards=mp, tp=tp)
    rows = _rows(batch, mesh)
    B = rows["tokens"].shape[0]
    held = _held_bytes(model, mesh)
    gathers = _gathers(model, mesh, shape.kind)
    enc_len = shape.seq_len if cfg.is_encoder_decoder else 0
    if shape.kind == "prefill":
        step = make_prefill_step(model, shape.seq_len, flags)
        kw = {k: v for k, v in rows.items() if k != "tokens"}
        cache_bytes = tree_bytes(model.new_cache(B, shape.seq_len, enc_len))
        return DryStep(cfg, shape, lambda: step(rows["tokens"], **kw),
                       {"params": held,
                        **{k: nbytes(v) for k, v in rows.items()}},
                       outputs=cache_bytes + B * 4, gathers=gathers,
                       recorder=recorder)
    if cfg.is_encoder_decoder and cfg.sliding_window:
        enc_len = min(enc_len, cfg.sliding_window)
    step = make_decode_step(model, flags)
    cache = model.new_cache(B, shape.seq_len, enc_len)
    positions = torch.empty(B, dtype=torch.int32, device="meta")
    cache_bytes = tree_bytes(cache)
    return DryStep(cfg, shape,
                   lambda: step(rows["tokens"], cache, positions),
                   {"params": held, "tokens": nbytes(rows["tokens"]),
                    "cache": cache_bytes, "positions": nbytes(positions)},
                   outputs=cache_bytes + nbytes(rows["tokens"]),
                   aliased=cache_bytes, gathers=gathers, recorder=recorder)


def count_step(step: DryStep,
               max_seconds: Optional[float] = None) -> OpCounter:
    """Run ``step`` once under a fresh counter and return it
    (``op_cost.TraceTimeout`` past ``max_seconds``)."""
    with OpCounter(max_seconds) as counter:
        step.record_gathers()
        step.run()
    return counter


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               flags: Optional[RuntimeFlags] = None,
               verbose: bool = True,
               max_seconds: Optional[float] = MAX_SECONDS) -> Dict[str, Any]:
    t0 = time.time()
    mesh = production_mesh(multi_pod)
    chips = len(mesh.devices)
    step = build_lowering(arch, shape_name, mesh, flags)
    counter = count_step(step, max_seconds)
    mem = memory_stats(counter, sum(step.arguments.values()), step.outputs,
                       step.aliased, step.gather_peak())
    cost = counter.totals()
    coll = collective_bytes(counter)
    rl = roofline(cost["flops"], cost["bytes"], coll["total"], chips)
    mf = model_flops(step.cfg, step.shape)
    mf_per_chip = mf / chips
    useful = mf_per_chip / cost["flops"] if cost["flops"] else 0.0
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "hbm_per_device_gb": mem["total_per_device"] / 2**30,
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["bytes"],
        "collective_bytes": coll["total"],
        "collective_counts": {k: v for k, v in coll.items()
                              if k not in ("total", "count") and v},
        "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
        "collective_s": rl["collective_s"], "dominant": rl["dominant"],
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": useful,
        "compile_time_s": time.time() - t0,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"hbm/dev={result['hbm_per_device_gb']:.2f}GiB "
              f"compute={rl['compute_s']*1e3:.2f}ms "
              f"memory={rl['memory_s']*1e3:.2f}ms "
              f"collective={rl['collective_s']*1e3:.2f}ms "
              f"dominant={rl['dominant']} useful={useful:.2f} "
              f"compile={result['compile_time_s']:.0f}s", flush=True)
        print("  memory_analysis:", {k: f"{v/2**30:.2f}GiB"
                                     for k, v in mem.items()
                                     if "size" in k})
        print("  cost_analysis:", {"flops": cost["flops"],
                                   "bytes": cost["bytes"]}, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="",
                    help="append JSON results to this file")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=MAX_SECONDS,
                    help="stop a case's trace after this many seconds "
                         "and report it as not run (0: no limit)")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    flags = plain_flags(args.flash)

    results: List[Dict[str, Any]] = []
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(dryrun_one(
                        arch, shape, mp, flags,
                        max_seconds=args.max_seconds or None))
                except TraceTimeout as e:
                    print(f"[{arch} x {shape}] {e}", flush=True)
                    failures.append((arch, shape, mp, repr(e)))
                except Exception as e:  # noqa: BLE001
                    import traceback
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    print(f"\n{len(results)} lowered+compiled OK, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
