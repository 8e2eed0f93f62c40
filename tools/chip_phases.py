#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone on one card: a quicker
loop than the whole script while a phase is being written.

    python3 tools/chip_phases.py kernels,tp_moe,tp_hybrid,tp_state,tp_mixers_f32
    python3 tools/chip_phases.py kernels,tp_mla,tp_hd,tp_encdec
    python3 tools/chip_phases.py window_kernels,window_main_path,mla_window,mla_layouts
    python3 tools/chip_phases.py train_mesh,train_mesh_seq,train_ep
    python3 tools/chip_phases.py train_mesh_sp,train_mesh_hybrid,train_mesh_mla
    python3 tools/chip_phases.py window_main_path,cost_model
    python3 tools/chip_phases.py examples

``kernels`` holds K2, K4, K5 and K3 against their plain versions at one
rank's heads under tensor-parallel serving (granite_moe_3b_a800m's 12
over 4 kv heads, jamba's 32 over 4 and seamless_m4t_large_v2's 8 over
8 at tp 2, and granite's 256-row rank chunk), in bf16 and f32, each row
alone bitwise its row of the batch; the other names are
``chip_smoke.py``'s tensor-parallel phases of items 11b-i and 11b-ii,
run in the order given, their engines sharing one ``WorkerPool``
(``tp_hd``'s eight ranks have one of their own).  The phases of ROADMAP
items 12 and 15: ``window_kernels`` holds K3's window branch
(``WINDOW_PREFILLS``, bf16 and f32, each row alone bitwise) and times it
beside its plain version and SDPA with the same boolean mask;
``window_main_path`` and ``mla_window`` are ``chip_smoke.py``'s;
``mla_layouts`` builds deepseek_v3_671b's two layers and serves
``mla_serve``'s requests on a roomy paged arena first, the reference
that ``chip_smoke.py`` takes from ``mla_serve``.  The phases of ROADMAP
item 11c-i, ``train_mesh``, ``train_mesh_seq`` and ``train_ep``, and of
item 11c-ii, ``train_mesh_sp``, ``train_mesh_hybrid`` and
``train_mesh_mla``, are ``chip_smoke.py``'s (``train_mesh_seq`` starts
its own 8 ranks here, where ``chip_smoke.py`` takes ``tp_hd``'s).
``cost_model`` (ROADMAP item 11d) runs ``times`` and then holds the op
counter against its kernel rows and against the steps timed by the
phases named before it (``window_main_path`` registers deepseek_7b's
captured window tick; ``chip_smoke.py`` runs it over four steps).
``examples`` (ROADMAP item 20) runs ``examples/torch_serve_llm.py`` and
``examples/torch_train_lm.py`` on the card.  Builds the kernels first (``phase_build``).  Prints the
phases' JSON lines, then the card's name and power limit; exits
non-zero without a card or at the first failed check.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = {"tp_moe": cs.phase_tp_moe, "tp_hybrid": cs.phase_tp_hybrid,
          "tp_state": cs.phase_tp_state, "tp_mla": cs.phase_tp_mla,
          "tp_hd": cs.phase_tp_hd, "tp_encdec": cs.phase_tp_encdec}


def rank_kernels(torch) -> None:
    """``phase_kernels``' checks at the item 11b-i per-rank shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def record(name, dtype, case, a, b, tol):
        err, ok = cs.close(a, b, tol)
        cs.emit({"phase": "kernel_vs_plain", "kernel": name, "dtype": dtype,
                 "case": case, "max_abs_err": err, "tol": tol, "ok": ok})
        cs.check(ok, f"{name} {dtype} {case}: max abs err {err}")

    shapes = [s for s in cs.TP_HEADS
              if s[0].startswith(("granite", "jamba", "seamless"))]
    for dtype in ("bfloat16", "float32"):
        for shape in shapes:
            cs.check_paged_kernels(torch, dev, g, dtype, shape, record)
            cs.check_flash_shape(torch, dev, g, dtype, shape, record,
                                 rows=cs.SERVE_CHUNK + 64,
                                 offsets=(cs.SERVE_CHUNK,), batch=2)
        cs.check_flash_shape(torch, dev, g, dtype, shapes[0], record,
                             rows=cs.SERVE_CHUNK, offsets=(), batch=1)
    for shape in shapes:
        cs.check_window_independence(torch, dev, g, shape)


def window_kernels(torch) -> None:
    """K3's window cases of ``phase_kernels``, and its windowed time."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def record(name, dtype, case, a, b, tol):
        err, ok = cs.close(a, b, tol)
        cs.emit({"phase": "kernel_vs_plain", "kernel": name, "dtype": dtype,
                 "case": case, "max_abs_err": err, "tol": tol, "ok": ok})
        cs.check(ok, f"{name} {dtype} {case}: max abs err {err}")

    for dtype in ("bfloat16", "float32"):
        for shape, rows, window in cs.WINDOW_PREFILLS:
            cs.check_flash_shape(torch, dev, g, dtype, shape, record,
                                 rows=rows, offsets=(), batch=2,
                                 window=window)
    cs.FLASH_TIMED = tuple(t for t in cs.FLASH_TIMED if len(t) > 7)
    for r in cs.time_flash_shapes(torch, g):
        cs.emit({"phase": "times", "kernel": "flash_attention", **r})


def mla_layouts(torch, smi) -> None:
    """``phase_mla_layouts`` on its own engine, against its own paged
    reference (mla_serve's layout run)."""
    from repro_torch.serving import LLMEngine
    cfg = cs.deepseek_config()
    requests = cs.serve_requests(cfg.vocab_size)
    engine = LLMEngine(cfg, max_len=cs.SERVE_MAX_LEN, seed=cs.SEED)
    paged, _, _, _ = cs.serve(torch, engine, requests, cs.ROOMY_BLOCKS,
                              prefix_sharing=False, speculate_k=0)
    cs.phase_mla_layouts(torch, engine, requests, paged)


WINDOW_PHASES = {"window_main_path": cs.phase_window_main_path,
                 "mla_window": cs.phase_mla_window,
                 "mla_layouts": mla_layouts,
                 "train_mesh": cs.phase_train_mesh,
                 "train_mesh_seq": cs.phase_train_mesh_seq,
                 "train_ep": cs.phase_train_ep,
                 "train_mesh_sp": cs.phase_train_mesh_sp,
                 "train_mesh_hybrid": cs.phase_train_mesh_hybrid,
                 "train_mesh_mla": cs.phase_train_mesh_mla,
                 "examples": cs.phase_examples}


def main(argv) -> int:
    names = argv[0].split(",") if argv else [
        "kernels", "tp_moe", "tp_hybrid", "tp_state", "tp_mixers_f32",
        "tp_mla", "tp_hd", "tp_encdec"]
    unknown = set(names) - {"kernels", "tp_mixers_f32", "window_kernels",
                            "cost_model", *PHASES, *WINDOW_PHASES}
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    torch = cs.setup()
    smi = cs.phase_build(torch)
    from repro_torch.sharding.group import WorkerPool
    cs.TP_POOL = cs.TRAIN_POOL = WorkerPool()
    try:
        for name in names:
            if name == "kernels":
                rank_kernels(torch)
            elif name == "window_kernels":
                window_kernels(torch)
            elif name == "cost_model":
                cs.phase_times(torch)
                cs.phase_cost_model(torch, smi)
            elif name in WINDOW_PHASES:
                WINDOW_PHASES[name](torch, smi)
                cs.free_card(torch)
            elif name == "tp_mixers_f32":
                cs.phase_tp_mixers_f32(torch)
            else:
                PHASES[name](torch, smi)
    finally:
        cs.TP_POOL.close()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
