#!/usr/bin/env python
"""End-to-end driver on the PyTorch port: serve a small LM through the
continuous-batching GraphServer with several concurrent client threads,
as ``examples/serve_llm.py`` does through the JAX package, with its
arguments (requests join the running decode batch as slots free up;
tokens stream back per step).

    PYTHONPATH=src python examples/torch_serve_llm.py               # the card
    PYTHONPATH=src python examples/torch_serve_llm.py --device cpu  # the CPU

It runs on the card (``repro_torch.launch.serve``'s ``--device cuda``)
unless ``--device cpu`` is given.  Every knob of ``serve_llm.py``
(``--backend``, ``--chunk-size``, ``--speculate``, ``--priority``,
``--admission``, ``--fixed-batch``) is forwarded to
``repro_torch.launch.serve``; the scheduler stats are printed on exit.
"""
import sys

from repro_torch.launch.serve import main

sys.exit(main(["--arch", "qwen3_32b", "--reduced",
               "--requests", "24", "--clients", "6",
               "--num-slots", "4", "--max-new-tokens", "8"]
              + sys.argv[1:]))
