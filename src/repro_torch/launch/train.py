"""Training launcher of the port: the train step over the synthetic data
pipeline, on the card (``--device cuda``, the default) or the CPU
(``--device cpu``), with the JAX package's flags and printed lines.

    python -m repro_torch.launch.train --arch minicpm_2b --steps 100 \
        --reduced --device cpu --batch 8 --seq 256

    python -m repro_torch.launch.train --arch minicpm_2b --steps 20 \
        --batch 8 --seq 256 --host-mesh

``--host-mesh`` trains on ``make_host_mesh()`` over the visible devices
(every card; ``--host-devices N`` ranks, which on ``--device cpu`` or a
single card share it) with default flags: data parallel with ZeRO and
the gather MoE, as the JAX launcher's host-mesh path does; on one card
it is a 1 x 1 mesh.  ``--multi-pod`` builds the (2, 16, 16) production
mesh and its flags (``moe_impl="ep"``, the batch on ``("pod",
"data")``), which raises where fewer than 512 devices are visible.
Without either flag the port trains on one device: the JAX launcher
builds the (16, 16) production mesh there, which no machine of the port
has.  The model trains on the plain path (``TRAIN_FLAGS``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..checkpoint import save_checkpoint, save_from_mesh
from ..configs import get_config
from ..data import SyntheticTextDataset
from ..models.model import Model, resolve_device
from ..models.transformer import TRAIN_FLAGS
from ..optim import make_schedule
from ..runtime.steps import make_train_step
from .mesh import make_host_mesh, make_production_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="small mesh over local devices")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="ranks of --host-mesh (0: every visible card, or "
                         "1 on --device cpu); several share one device")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh, flags = None, TRAIN_FLAGS
    if args.host_mesh:
        n = args.host_devices
        devices = None if device.type == "cuda" and not n else \
            [str(device)] * max(n, 1)
        mesh = make_host_mesh(devices=devices)
    elif args.multi_pod:
        mesh = make_production_mesh(multi_pod=True)
        flags = dataclasses.replace(
            flags, batch_axes=("pod", "data"),
            batch_divisor=mesh.shape["pod"] * mesh.shape["data"],
            moe_impl="ep", model_size=mesh.shape["model"])
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device, seed=args.seed)
    print(f"arch={cfg.name} params={model.param_count():,d} "
          f"optimizer={cfg.optimizer} schedule={cfg.lr_schedule}")

    schedule = make_schedule(cfg.lr_schedule, peak_lr=args.lr,
                             warmup=max(args.steps // 20, 5),
                             total=args.steps)
    train_step, init_state = make_train_step(model, schedule=schedule,
                                             flags=flags, mesh=mesh)
    state = init_state(model.params)
    trainer = getattr(train_step, "trainer", None)

    ds = SyntheticTextDataset(cfg.vocab_size, args.seq, args.seed)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in ds.batch(step, args.batch).items()}
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = torch.as_tensor(
                np.random.RandomState(step).randn(
                    args.batch, args.seq, cfg.d_model),
                dtype=torch.float32, device=device)
        if cfg.frontend:
            P = cfg.num_prefix_embeddings
            batch["prefix_embeds"] = torch.as_tensor(
                np.random.RandomState(step).randn(
                    args.batch, P, cfg.d_model) * 0.02,
                dtype=torch.float32, device=device)
            batch["labels"] = torch.cat(
                [torch.zeros((args.batch, P), dtype=torch.long,
                             device=device), batch["labels"]], dim=1)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({dt:.1f}s)")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, args.steps,
                               state.params) if trainer is None else \
            save_from_mesh(args.checkpoint_dir, args.steps, trainer, state,
                           params_only=True)
        print("checkpoint:", path)
    if trainer is not None:
        trainer.close()
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
