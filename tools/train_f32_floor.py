#!/usr/bin/env python3
"""How far the port's f32 train-loss gradients sit from an f64 run on the
same weights, and why, on the CPU.

    PYTHONPATH=src python3 tools/train_f32_floor.py --arch minicpm_2b \
        --depth 2 --tokens 32
    PYTHONPATH=src python3 tools/train_f32_floor.py --arch xlstm_1_3b \
        --depth 2 --pattern mlstm slstm --tokens 128 --w-h-scale 0.1
    PYTHONPATH=src python3 tools/train_f32_floor.py --device cuda \
        --arch jamba_1_5_large_398b --depth 2 --ffn-pattern dense \
        --tokens 64 --rows 2

The arch at full width, cut to ``--depth`` layers (``--pattern``: the
block kinds cycled over them; ``--ffn-pattern``: the FFN kinds), on
``--device`` (the CPU, or a card with its products in true f32),
random weights from ``--seed``
(``--w-h-scale`` scales the sLSTM layers' recurrent weights ``w_h``),
``--rows`` rows of ``--tokens`` tokens from the synthetic data pipeline.  Prints one
JSON line: the loss and grad norm in f32 and f64; for each leaf its
gradient norm in both and the f32 one's distance from the f64 one (the
norm of the difference over the f64 norm), largest first; the leaves
whose squared norms part the two grad norms most; and, for each
attention layer's softmax in an f64 forward, the largest score
magnitude and the share of query rows whose top probability exceeds
0.99 (a saturated softmax).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticTextDataset
from repro_torch.models import attention
from repro_torch.models.layers import no_tf32
from repro_torch.models.model import Model
from repro_torch.models.params import flatten
from repro_torch.models.transformer import TRAIN_FLAGS
from repro_torch.optim import make_schedule
from repro_torch.runtime.steps import make_train_step


def model_in(cfg, weights, dtype, device):
    dt = getattr(torch, dtype)
    return Model(dataclasses.replace(cfg, dtype=dtype), device=device,
                 params={k: v.to(device, dt) for k, v in weights.items()})


def grads(cfg, weights, batch, dtype, device):
    """(loss, {leaf: gradient on the host, in ``dtype``}) of the train
    loss in ``dtype``."""
    model = model_in(cfg, weights, dtype, device)
    step, _ = make_train_step(model, schedule=make_schedule(
        cfg.lr_schedule, peak_lr=3e-4, warmup=5, total=6))
    params = model.params
    for p in flatten(params).values():
        p.requires_grad_(True)
    with no_tf32(torch.device(device)):
        loss, _ = step.loss_fn(params, {k: v.to(device)
                                        for k, v in batch.items()})
        loss.backward()
    return float(loss.detach()), {k: p.grad.detach().cpu()
                                  for k, p in flatten(params).items()}


def softmax_readings(cfg, weights, tokens, device):
    """For each softmax over attention scores in an f64 forward (the
    plain path with ``attn_impl="naive"``, one softmax over the whole
    sequence a layer): the largest score magnitude and the share of
    query rows whose top probability exceeds 0.99."""
    model = model_in(cfg, weights, "float64", device)
    out, real = [], attention.torch.softmax

    def softmax(x, dim=-1, **kw):
        p = real(x, dim=dim, **kw)
        out.append({"max_abs_score": float(x[x > -1e30].abs().max()),
                    "saturated_rows": float((p.max(dim).values > 0.99)
                                            .double().mean())})
        return p
    attention.torch.softmax = softmax
    try:
        with torch.no_grad():
            model.forward(tokens.to(device), flags=dataclasses.replace(
                TRAIN_FLAGS, attn_impl="naive"))
    finally:
        attention.torch.softmax = real
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--pattern", nargs="+", default=None)
    ap.add_argument("--ffn-pattern", nargs="+", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--w-h-scale", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cut = dict(num_layers=args.depth, dtype="float32")
    if args.pattern:
        cut["block_pattern"] = tuple(args.pattern)
    if args.ffn_pattern:
        cut["ffn_pattern"] = tuple(args.ffn_pattern)
    cfg = dataclasses.replace(get_config(args.arch), **cut)
    model = Model(cfg, device=args.device, seed=args.seed)
    weights = {k: v.detach().cpu().clone()
               for k, v in model.named_parameters()}
    del model
    if args.w_h_scale is not None:
        for k in weights:
            if k.endswith(".mixer.w_h"):
                weights[k] *= args.w_h_scale
    b = SyntheticTextDataset(cfg.vocab_size, args.tokens, args.seed
                             ).batch(0, args.rows)
    batch = {k: torch.as_tensor(v).long() for k, v in b.items()}
    l32, g32 = grads(cfg, weights, batch, "float32", args.device)
    l64, g64 = grads(cfg, weights, batch, "float64", args.device)
    g32 = {k: v.double() for k, v in g32.items()}
    norm = lambda g: math.sqrt(sum(float((v * v).sum())  # noqa: E731
                                   for v in g.values()))
    leaves = sorted(({"leaf": k, "norm_f32": float(g32[k].norm()),
                      "norm_f64": float(g64[k].norm()),
                      "f32_vs_f64": float((g32[k] - g64[k]).norm()
                                          / max(float(g64[k].norm()),
                                                1e-300))}
                     for k in g64), key=lambda r: -r["f32_vs_f64"])
    gap = sorted(((abs(float((g32[k] ** 2).sum() - (g64[k] ** 2).sum())), k)
                  for k in g64), reverse=True)[:3]
    print(json.dumps({
        "arch": args.arch, "depth": args.depth, "device": args.device,
        "layer_kinds": list(cfg.layer_kinds()), "tokens": args.tokens,
        "w_h_scale": args.w_h_scale, "loss": {"f32": l32, "f64": l64},
        "grad_norm": {"f32": norm(g32), "f64": norm(g64)},
        "finite": all(bool(torch.isfinite(g).all()) for g in g32.values()),
        "leaves": leaves,
        "grad_gap_leaves": [{"leaf": k, "sq_norm_gap": d} for d, k in gap],
        "attention_softmax": softmax_readings(cfg, weights,
                                              batch["tokens"],
                                              args.device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
