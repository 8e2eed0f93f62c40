#!/usr/bin/env python3
"""How xlstm_1_3b's gradients grow with depth at its random init, in the
JAX package and in the PyTorch port, on the CPU.

    PYTHONPATH=src python3 tools/xlstm_grad_growth.py [--depths 1 2 4 8] \
        [--tokens 512] [--pattern mlstm slstm]

For each depth: xlstm_1_3b at full width (d_model 2048, 4 heads, f32)
cut to that many layers (its own 7:1 block pattern, or ``--pattern``'s
kinds cycled over them), one row of ``--tokens`` tokens from the
synthetic data pipeline, and the train loss's gradients — JAX's through
``make_train_step`` (weights from ``PRNGKey(0)``), the port's through
its ``train_step.loss_fn`` on the same weights (``params_from_jax``).
Prints one JSON line a depth: the loss, the grad norm as both packages
compute it (each leaf's squares summed in f32: inf once an element
passes sqrt(f32 max), about 1.8e19) and the largest gradient element
with its leaf.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticTextDataset
from repro.models import Model as JaxModel
from repro.optim import make_schedule as jax_make_schedule
from repro.runtime.steps import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, params_from_jax
from repro_torch.optim import make_schedule
from repro_torch.runtime.steps import make_train_step

SCHEDULE = dict(peak_lr=3e-4, warmup=5, total=6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--pattern", nargs="+", default=None)
    args = ap.parse_args(argv)
    for depth in args.depths:
        t0 = time.time()
        cut = dict(num_layers=depth, dtype="float32")
        if args.pattern:
            cut["block_pattern"] = tuple(args.pattern)
        jcfg = dataclasses.replace(jax_get_config("xlstm_1_3b"), **cut)
        cfg = dataclasses.replace(get_config("xlstm_1_3b"), **cut)
        batch = SyntheticTextDataset(cfg.vocab_size, args.tokens,
                                     0).batch(0, 1)
        jmodel = JaxModel(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        step, init = jax_train_step(jmodel, schedule=jax_make_schedule(
            jcfg.lr_schedule, **SCHEDULE))
        _, jm = jax.jit(step)(init(jparams), batch)
        model = Model(cfg, device="cpu", params=params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        tstep, _ = make_train_step(model, schedule=make_schedule(
            cfg.lr_schedule, **SCHEDULE))
        params = model.params
        for p in flatten(params).values():
            p.requires_grad_(True)
        loss, _ = tstep.loss_fn(params, {k: torch.as_tensor(v).long()
                                         for k, v in batch.items()})
        loss.backward()
        grads = {k: p.grad for k, p in flatten(params).items()}
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads.values()))
        leaf, g_max = max(((k, float(g.abs().max()))
                           for k, g in grads.items()), key=lambda kv: kv[1])
        print(json.dumps({
            "depth": depth, "layer_kinds": list(cfg.layer_kinds()),
            "tokens": args.tokens,
            "jax_loss": float(jm["loss"]), "port_loss": float(loss),
            "jax_grad_norm": float(jm["grad_norm"]),
            "port_grad_norm": float(norm), "port_grad_max_abs": g_max,
            "port_grad_max_leaf": leaf,
            "seconds": round(time.time() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
