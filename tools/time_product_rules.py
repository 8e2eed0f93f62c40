#!/usr/bin/env python3
"""Time the unsharded captured decode and verify ticks of the
PyTorch/CUDA port under its product rule and under one rule for every
product, on one card.

    python3 tools/time_product_rules.py [--archs minicpm_2b ...]

``models/layers.py::linear`` runs a product of few rows as it is,
unless the caller blocks it (the recurrent mixers) or the model is a
tensor-parallel rank, whose products of fewer than ROW_BLOCK rows run
padded to ROW_BLOCK rows (``rows_padded``, ROADMAP Hazard 4).  The
other rule would pad every product on the card.  This tool reads what
that costs the unsharded ticks: for each arch (full width and depth,
bf16, random weights from the seed, one set shared by both engines),
one engine per variant (``port``: the port's rule; ``padded``: every
product of fewer than ROW_BLOCK rows padded, each engine's graphs
captured under its own rule), the Scheduler at 4 slots on a paged
arena, ticks in turns: 3 of warm-up (the first captures), then
TICK_READS read.  ``decode`` ticks carry 4 rows, ``verify`` ticks (4
drafted tokens a slot) 20, read VERIFY_READS times (a verify tick may
accept up to 5 tokens a slot, and the prompts leave 173 positions).
Prints one JSON line per reading (median wall ms, p10/p90, the slots
still active at the end) and the card's name and power limit; exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TICK_READS = 60
VERIFY_READS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def rule(name):
    """The port's product rule (``port``), or every product of fewer
    than ROW_BLOCK rows padded (``padded``), inside."""
    from repro_torch.models import layers, model
    saved = model._rank_products
    if name == "padded":
        model._rank_products = lambda flags: layers.rows_padded(True)
    try:
        yield
    finally:
        model._rank_products = saved


def ticks(torch, chip_smoke, arch, spec):
    """Both variants' captured ticks of ``arch`` in turns; ``spec``
    drafts that many tokens a slot each tick."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import LLMEngine, PagedBackend, Scheduler
    cfg = get_config(arch)
    first = LLMEngine(cfg, max_len=chip_smoke.SERVE_MAX_LEN,
                      seed=chip_smoke.SEED)
    weights = dict(first.model.named_parameters())
    engines = {"port": first,
               "padded": LLMEngine(cfg, weights,
                                   max_len=chip_smoke.SERVE_MAX_LEN)}
    requests = chip_smoke.serve_requests(cfg.vocab_size)
    reads = VERIFY_READS if spec else TICK_READS
    scheds = {}
    for name, engine in engines.items():
        with rule(name):
            be = PagedBackend(engine, chip_smoke.SERVE_SLOTS,
                              num_blocks=chip_smoke.ROOMY_BLOCKS,
                              block_size=chip_smoke.SERVE_BLOCK)
            sched = Scheduler(be, max_new_tokens=(spec + 1) * (
                                  3 + reads) + 8,
                              chunk_size=chip_smoke.SERVE_CHUNK,
                              speculate_k=spec,
                              draft_fn=chip_smoke.always_draft)
            for i, p in enumerate(requests[:chip_smoke.SERVE_SLOTS]):
                sched.submit({"tokens": p, "id": i})
            while sched.ingesting or sched.waiting:
                sched.admit()
        scheds[name] = sched
    times = {name: [] for name in scheds}
    for i in range(3 + reads):
        for name, sched in scheds.items():
            with rule(name):
                t0 = time.perf_counter()
                sched.step()
                torch.cuda.synchronize()
                if i >= 3:
                    times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ms in times.items():
        emit({"arch": arch, "tick": "verify" if spec else "decode",
              "rows": chip_smoke.SERVE_SLOTS * (spec + 1), "variant": name,
              "ticks": len(ms), "ms_median": statistics.median(ms),
              "ms_p10": float(np.percentile(ms, 10)),
              "ms_p90": float(np.percentile(ms, 90)),
              "active_at_end": scheds[name].active})
    del engines, scheds, weights, first
    chip_smoke.free_card(torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+",
                    default=["minicpm_2b", "granite_moe_3b_a800m"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_product_rules: needs a CUDA device")
    import chip_smoke
    chip_smoke.setup()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda})
    for arch in args.archs:
        for spec in (0, chip_smoke.SERVE_SPEC):
            ticks(torch, chip_smoke, arch, spec)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
