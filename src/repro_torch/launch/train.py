"""Training launcher of the port: the train step over the synthetic data
pipeline, on the card (``--device cuda``, the default) or the CPU
(``--device cpu``), with the JAX package's flags and printed lines.

    python -m repro_torch.launch.train --arch minicpm_2b --steps 100 \
        --reduced --device cpu --batch 8 --seq 256

    python -m repro_torch.launch.train --arch minicpm_2b --steps 20 \
        --batch 8 --seq 256

The port has no sharded training yet (ROADMAP Queue 1 item 11c): ``--host-mesh``
is accepted and shards nothing on one device, and ``--multi-pod``
raises.  The model trains on the plain path (``TRAIN_FLAGS``).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..data import SyntheticTextDataset
from ..models.model import Model, resolve_device
from ..optim import make_schedule
from ..runtime.steps import make_train_step

MULTI_POD_REFUSAL = ("--multi-pod: sharded training is not yet ported to "
                     "repro_torch (ROADMAP Queue 1 item 11c)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="accepted; the port shards nothing on one device")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(MULTI_POD_REFUSAL)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params:,d} "
          f"optimizer={cfg.optimizer} schedule={cfg.lr_schedule}")

    schedule = make_schedule(cfg.lr_schedule, peak_lr=args.lr,
                             warmup=max(args.steps // 20, 5),
                             total=args.steps)
    train_step, init_state = make_train_step(model, schedule=schedule)
    state = init_state(model.params)

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
        path = save_checkpoint(args.checkpoint_dir, args.steps, state.params)
        print("checkpoint:", path)
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
