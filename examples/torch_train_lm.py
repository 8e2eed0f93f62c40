#!/usr/bin/env python
"""End-to-end training driver on the PyTorch port: a reduced
qwen3-family model on the synthetic pipeline for a few hundred steps, as
``examples/train_lm.py`` does through the JAX package, with its
arguments; loss must decrease.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

It trains on the card (``repro_torch.launch.train``'s ``--device
cuda``) unless ``--device cpu`` is given; ``--host-mesh`` is a 1 x 1
mesh on one device.  The checkpoint goes to ``/tmp/repro_torch_ckpt``
unless ``--checkpoint-dir`` says otherwise.
"""
import sys

from repro_torch.launch.train import main

args = ["--arch", "qwen3_32b", "--reduced", "--host-mesh",
        "--steps", "200", "--batch", "8", "--seq", "128",
        "--lr", "1e-3", "--log-every", "20",
        "--checkpoint-dir", "/tmp/repro_torch_ckpt"]
args += sys.argv[1:]
sys.exit(main(args))
