#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K5) from
``src/repro_torch/kernels/csrc`` with nvcc, holds each against its plain
PyTorch version on the card in bf16 and f32 (K3 also at qwen3_32b's and
stablelm_12b's head shapes, its suffixes bitwise equal to the full
prefill's rows; K2, K4 and K5 at minicpm_2b's, qwen3_32b's and
stablelm_12b's, windows of 1 and 5 queries, each row alone bitwise equal
to its row of the batch; K2 and K4's 5-query window bitwise equal to
five single-query calls), reads whether cuBLAS rows depend on the
row count, serves ``minicpm_2b`` at full width and depth (40 layers,
d_model 2304, bf16, random weights from a seed) through
``repro_torch.serving.LLMEngine`` — ``generate``, then ``new_cache`` /
``prefill`` / ``insert`` / ``decode`` / ``verify`` on a 4-slot cache —
and through the ``Scheduler`` on a paged arena (chunked prefill, prefix
sharing, speculative verify, preemption) once per decode kernel, then
the same requests through ``GraphServer`` and ``AsyncFrontend`` (the
graph runtime; tokens bitwise equal to the Scheduler's, TTFT, time per
output token and tokens/s from the server's metrics) and a graph
through the CUDA ``SyncPointCalculator``, then with requests preempted
after streaming tokens and replayed through the decode step (phase
``serve_preempt_decode``: through the Scheduler with K2 and K4 and
through ``GraphServer``, tokens bitwise those of the runs without
preemption, the replayed rows' K/V bitwise what they held), then the
captured decode and verify steps against eager ones (phase
``captured``: every serving run's tokens bitwise, and the paged and
slot ticks' times read in turns), then ``granite_moe_3b_a800m`` at full
width and depth (32 layers, 40 experts top-8 padded to 48, bf16): one
MoE FFN layer on the card against the CPU (``moe_layer_vs_cpu``), the
engine's main path against the plain path (``moe_main_path``), the serve
workload through the Scheduler captured against eager with its capacity
drops counted (``moe_serve``), slot against paged (``moe_serve_layouts``),
preempted requests replayed through the decode step
(``moe_preempt_decode``), the port's launcher in both front doors
(``moe_graph_serve``) and the captured decode tick against its bound
(``moe_tick``); checks the launch counters against the schedule and the
outputs (slot and paged layouts bitwise equal; an f32 run against
per-request greedy), and times each kernel with CUDA events over calls
queued back to back (K1 also at prefill widths, K3 also at the serve
workload's prefill chunk and qwen3_32b's full prefill, K2, K4 and K5
also on the paged arena at the serve tick's, qwen3_32b's and
granite_moe_3b_a800m's shapes, K2 and K4 there at windows of 1 and 5).
Kernels are also held at granite_moe_3b_a800m's head shape (24 heads
over 8 KV heads), and ``gemm_width`` reads its router and expert
products.  Every phase and check
prints a JSON line; any failure raises and exits non-zero.  The last
lines are the card's name and power limit, the kernel summary, and
``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository's ``src/`` beside it, and
exits non-zero without either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MAX_LEN = 512
GEN_PROMPT = (2, 16)          # generate: [batch, prompt length]
GEN_NEW = 8
GROUPS = (14, 18)             # serving: two prefill groups of 2 rows
TICKS = 16                    # serving decode ticks (slot 3 idle for half)
VERIFY_WIDTH = 4
REPS = 30                     # timed calls per kernel and method

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# tolerance of a kernel against its plain version, as allclose with
# atol = rtol: f32 differs by reduction order and approximate rsqrt/exp
# only; bf16 adds one rounding of the output
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the full-depth f32 model, kernel path against plain path: the limit
# on the logits' difference, and the top-2 gap above which greedy tokens
# must agree.  On an H100 the 40 layers differed by 4.0e-4 at a logit
# scale of 5.2 (4 rows x 8 steps), and every row's top-2 gap was wider
# than this limit
F32_MODEL_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def setup():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


# ---------------------------------------------------------------------------
# phase 1 — build
# ---------------------------------------------------------------------------

def phase_build(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": build.build_seconds, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "ptxas": ptxas})
    return smi


# ---------------------------------------------------------------------------
# phase 2 — each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def close(a, b, tol):
    """(max abs error, allclose with atol = rtol = tol)."""
    err = (a.float() - b.float()).abs()
    return float(err.max()), bool((err <= tol + tol * b.float().abs()).all())


def phase_kernels(torch):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_decode import fused_flash_decode_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import paging
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {name: 0.0 for name in SOURCES}

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dt)

    def record(name, dtype, case, a, b, tol):
        err, ok = close(a, b, tol)
        emit({"phase": "kernel_vs_plain", "kernel": name, "dtype": dtype,
              "case": case, "max_abs_err": err, "tol": tol, "ok": ok})
        check(ok, f"{name} {dtype} {case}: max abs err {err} beyond "
                  f"allclose(atol=rtol={tol})")
        if dtype == "bfloat16":
            errs[name] = max(errs[name], err)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        tol = TOL[dtype]
        # K1: the prefill and decode rows of minicpm_2b, d = 2304
        for rows in (2 * GROUPS[1], 4):
            x = rand((rows, 2304), dt)
            s = (1 + rand((2304,), torch.float32, 0.1)).to(dt)
            out = rmsnorm_cuda(x, s)
            record("rmsnorm", dtype, f"[{rows},2304]", out,
                   ref.rmsnorm_ref(x, s), tol)
            alone = rmsnorm_cuda(x[2:3].contiguous(), s)
            check(torch.equal(alone, out[2:3]), "rmsnorm: row 2 alone is "
                  "not bitwise equal to row 2 of the batch")
        # K3: the serving prefill [2, 18, 36, 64], then [4, 128, 36, 64]
        # causal and its suffixes at q_offset
        q, k, v = (rand((2, GROUPS[1], 36, 64), dt) for _ in range(3))
        record("flash_attention", dtype, f"[2,{GROUPS[1]},36,64] causal",
               flash_attention_cuda(q, k, v),
               ref.flash_attention_ref(q, k, v), tol)
        q, k, v = (rand((4, 128, 36, 64), dt) for _ in range(3))
        full = flash_attention_cuda(q, k, v)
        record("flash_attention", dtype, "[4,128,36,64] causal", full,
               ref.flash_attention_ref(q, k, v), tol)
        for off in (1, 50, 127):
            suf = flash_attention_cuda(q[:, off:].contiguous(), k, v,
                                       q_offset=off)
            record("flash_attention", dtype, f"q_offset={off}", suf,
                   ref.flash_attention_ref(q[:, off:], k, v, q_offset=off),
                   tol)
            check(torch.equal(suf, full[:, off:]),
                  f"flash_attention: suffix at q_offset={off} is not bitwise "
                  f"equal to the full prefill's rows")
        alone = flash_attention_cuda(q[2:3].contiguous(), k[2:3].contiguous(),
                                     v[2:3].contiguous())
        check(torch.equal(alone, full[2:3]), "flash_attention: row 2 alone "
              "is not bitwise equal to row 2 of the batch")
        for shape in PREFILL_SHAPES:
            check_flash_shape(torch, dev, g, dtype, shape, record)
        # K2: 4 rows, max_len 512, page 8, windows of 1 and 4
        B, KV, hd, page = 4, 36, 64, 8
        P = MAX_LEN // page
        freqs = ref.rope_freqs(hd, 10_000.0, dev)
        for Sq in (1, VERIFY_WIDTH):
            pos = torch.randint(0, MAX_LEN - Sq, (B,), device=dev,
                                generator=g).int()
            layouts = {
                "slot": (B * P, paging.slot_arena_tables(B, MAX_LEN, page,
                                                         dev)),
            }
            # paged: trash block 0, each row's pages scattered, tables
            # padded with 0 past the row's last page
            need = (pos + Sq + page - 1) // page
            perm = 1 + torch.randperm(B * P, device=dev, generator=g)
            tbl = torch.zeros(B, P, dtype=torch.int32, device=dev)
            for b in range(B):
                n = int(need[b])
                tbl[b, :n] = perm[b * P:b * P + n].int()
            layouts["paged"] = (1 + B * P, tbl)
            for lay, (NB, tables) in layouts.items():
                qd = rand((B, Sq, 36, hd), dt)
                kn, vn = rand((B, Sq, KV, hd), dt), rand((B, Sq, KV, hd), dt)
                kp, vp = rand((NB, page, KV, hd), dt), rand((NB, page, KV, hd),
                                                           dt)
                kp0, vp0 = kp.clone(), vp.clone()
                kp2, vp2 = kp.clone(), vp.clone()
                out = fused_flash_decode_cuda(qd, kn, vn, kp, vp, tables, pos,
                                              freqs)
                want = ref.fused_flash_decode_ref(qd, kn, vn, kp2, vp2,
                                                  tables, pos, freqs)
                case = f"S'={Sq} {lay}"
                record("fused_flash_decode", dtype, case, out, want, tol)
                record("fused_flash_decode", dtype, case + " k arena",
                       kp[1:], kp2[1:], tol)
                record("fused_flash_decode", dtype, case + " v arena",
                       vp[1:], vp2[1:], tol)
                kp3, vp3 = kp0.clone(), vp0.clone()
                alone = fused_flash_decode_cuda(
                    qd[2:3].contiguous(), kn[2:3].contiguous(),
                    vn[2:3].contiguous(), kp3, vp3, tables[2:3].contiguous(),
                    pos[2:3].contiguous(), freqs)
                check(torch.equal(alone, out[2:3]),
                      f"fused_flash_decode {case}: row 2 alone is not "
                      f"bitwise equal to row 2 of the batch")
        for shape in DECODE_SHAPES:
            check_paged_kernels(torch, dev, g, dtype, shape, record)
        # granite_moe_3b_a800m's G = 3: K3's suffixes of a 512-row
        # prefill, K2 and K4's windows against single queries
        check_flash_shape(torch, dev, g, dtype, GRANITE, record,
                          rows=512, offsets=(50, 256))
        check_window_independence(torch, dev, g, GRANITE, dtype)
    for shape in DECODE_SHAPES[:2]:
        check_window_independence(torch, dev, g, shape)
    torch.cuda.synchronize()
    return errs


#: (name, H, KV, hd) of the prefill shapes K3 is held at beside
#: minicpm_2b's: qwen3_32b's (GQA, head_dim 128) and stablelm_12b's
#: (head_dim 160, the widest the kernel takes)
PREFILL_SHAPES = (("qwen3_32b", 64, 8, 128), ("stablelm_12b", 32, 8, 160))
PREFILL_ROWS = 768
#: suffix offsets: the serve workload's chunk boundaries and one inside
#: a 128-key block
PREFILL_OFFSETS = (50, 256, 512)


def check_flash_shape(torch, dev, g, dtype, shape, record,
                      rows=PREFILL_ROWS, offsets=PREFILL_OFFSETS):
    """K3 at ``shape`` = (name, H, KV, hd): a causal prefill of ``rows``
    rows against its plain version, and its suffixes at ``offsets``
    against theirs and bitwise against the full rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    name, H, KV, hd = shape
    dt = getattr(torch, dtype)
    tol = TOL[dtype]
    S = rows

    def rand(*shp):
        return torch.randn(*shp, device=dev, generator=g).to(dt)

    q, k, v = rand(1, S, H, hd), rand(1, S, KV, hd), rand(1, S, KV, hd)
    full = flash_attention_cuda(q, k, v)
    case = f"{name} [1,{S},{H},{hd}] kv {KV} causal"
    record("flash_attention", dtype, case, full,
           ref.flash_attention_ref(q, k, v), tol)
    for off in offsets:
        suf = flash_attention_cuda(q[:, off:].contiguous(), k, v,
                                   q_offset=off)
        record("flash_attention", dtype, f"{case} q_offset={off}", suf,
               ref.flash_attention_ref(q[:, off:], k, v, q_offset=off), tol)
        check(torch.equal(suf, full[:, off:]),
              f"flash_attention {name}: suffix at q_offset={off} is not "
              f"bitwise equal to the full prefill's rows")


#: (name, H, KV, hd) of the attention shapes K2, K4 and K5 are held at:
#: minicpm_2b's (the served path), qwen3_32b's (GQA, wide heads: a
#: 5-query window is three 16-row tiles) and stablelm_12b's (head_dim
#: 160, the widest bf16 instance)
DECODE_SHAPES = (("minicpm_2b", 36, 36, 64), ("qwen3_32b", 64, 8, 128),
                 ("stablelm_12b", 32, 8, 160),
                 ("granite_moe_3b_a800m", 24, 8, 64))
#: granite_moe_3b_a800m's attention shape: 3 query heads per kv head
GRANITE = DECODE_SHAPES[3]
#: keys seen by the first window query of each active row, and the one
#: inactive row (all-zero table) at a stale position
ROW_KEYS = (1, 15, 16, 17, 300, 4095)
INACTIVE_POS = 37


def paged_layout(torch, dev, g, row_keys, Sq, bs, P):
    """Block tables of a paged arena with trash block 0: each active
    row's pages drawn at random from the pool, padded with 0 past the
    row's last page (window included); one inactive row, all zeros.
    Returns (tables [B, P] int32, positions [B] int32, blocks)."""
    B = len(row_keys) + 1
    pos = torch.tensor([n - 1 for n in row_keys] + [INACTIVE_POS],
                       dtype=torch.int32, device=dev)
    need = [-(-(n - 1 + Sq) // bs) for n in row_keys]
    NB = 1 + sum(need) + 8
    perm = 1 + torch.randperm(NB - 1, device=dev, generator=g)
    tbl = torch.zeros(B, P, dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[at:at + n].int()
        at += n
    return tbl, pos, NB


def check_paged_kernels(torch, dev, g, dtype, shape, record):
    """K2 and K4 against their plain version and against each other, K5
    against its plain version, at ``shape``; S' = 1 and 5; the rows of
    ROW_KEYS and an inactive row.  Bitwise: each row alone equals its
    row of the batch (K2, K4, K5); K4 on the same rows as a slot arena
    (page 8) equals K4 on the paged arena (bs 16); an inactive row writes
    nothing outside block 0 and K4's output is finite."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    name, H, KV, hd = shape
    dt = getattr(torch, dtype)
    tol = TOL[dtype]
    bs, page = 16, 8
    T_len = 4112                       # the longest row's window fits
    P = T_len // bs
    freqs = ref.rope_freqs(hd, 10_000.0, dev)

    def rand(*shp):
        return torch.randn(*shp, device=dev, generator=g).to(dt)

    def sub(t, b):
        return t[b:b + 1].contiguous()

    for Sq in (1, 5):
        tbl, pos, NB = paged_layout(torch, dev, g, ROW_KEYS, Sq, bs, P)
        B = tbl.shape[0]
        q, kn, vn = rand(B, Sq, H, hd), rand(B, Sq, KV, hd), rand(B, Sq, KV,
                                                                  hd)
        kp, vp = rand(NB, bs, KV, hd), rand(NB, bs, KV, hd)
        case = f"{name} S'={Sq}"
        # K4 and K2 and the plain version on copies of the same arenas
        a4, a2, ap = ([kp.clone(), vp.clone()] for _ in range(3))
        out4 = fused_flash_decode_splitk_cuda(q, kn, vn, *a4, tbl, pos, freqs)
        out2 = fused_flash_decode_cuda(q, kn, vn, *a2, tbl, pos, freqs)
        want = ref.fused_flash_decode_ref(q, kn, vn, *ap, tbl, pos, freqs)
        act = slice(0, B - 1)              # the active rows
        record("fused_flash_decode_splitk", dtype, case, out4[act],
               want[act], tol)
        record("fused_flash_decode", dtype, case, out2[act], want[act],
               tol)
        record("fused_flash_decode_splitk", dtype, case + " vs K2",
               out4[act], out2[act], tol)
        for i, label in ((0, "k arena"), (1, "v arena")):
            record("fused_flash_decode_splitk", dtype, f"{case} {label}",
                   a4[i][1:], ap[i][1:], tol)
            record("fused_flash_decode", dtype, f"{case} {label}",
                   a2[i][1:], ap[i][1:], tol)
        check(bool(torch.isfinite(out4).all()),
              f"K4 {case}: non-finite output")
        # each row alone; the inactive row's output is unspecified (it
        # reads block 0 while its window lands there), so it is held
        # to writing block 0 only
        for kernel, out, label in ((fused_flash_decode_splitk_cuda, out4,
                                    "K4"),
                                   (fused_flash_decode_cuda, out2, "K2")):
            for b in range(B):
                c = [kp.clone(), vp.clone()]
                alone = kernel(sub(q, b), sub(kn, b), sub(vn, b), *c,
                               sub(tbl, b), sub(pos, b), freqs)
                if b < B - 1:
                    check(torch.equal(alone, out[b:b + 1]),
                          f"{label} {case}: row {b} alone is not bitwise "
                          f"equal to its row of the batch")
                else:
                    check(torch.equal(c[0][1:], kp[1:])
                          and torch.equal(c[1][1:], vp[1:]),
                          f"{label} {case}: the inactive row wrote outside "
                          f"block 0")
        # layout independence: the same rows as slot rows, page 8
        ks = kp[tbl.long()].reshape(B, T_len, KV, hd)
        vs = vp[tbl.long()].reshape(B, T_len, KV, hd)
        from repro_torch.models import paging
        stbl = paging.slot_arena_tables(B, T_len, page, dev)
        arena = [ks.reshape(-1, page, KV, hd).clone(),
                 vs.reshape(-1, page, KV, hd).clone()]
        slot4 = fused_flash_decode_splitk_cuda(q, kn, vn, *arena, stbl, pos,
                                               freqs)
        check(torch.equal(slot4[act], out4[act]),
              f"K4 {case}: slot arena (page {page}) and paged arena "
              f"(bs {bs}) outputs are not bitwise equal")
        if Sq > 1:
            continue
        # K5: the rotated single query, the arena as the window left it
        q5 = rand(B, H, hd)
        out5 = paged_attention_cuda(q5, kp, vp, tbl, pos)
        want5 = ref.paged_attention_ref(q5, kp, vp, tbl, pos)
        record("paged_attention", dtype, name, out5[act], want5[act], tol)
        check(bool(torch.isfinite(out5).all()),
              f"K5 {name}: non-finite output")
        for b in range(B):
            alone = paged_attention_cuda(sub(q5, b), kp, vp, sub(tbl, b),
                                         sub(pos, b))
            check(torch.equal(alone, out5[b:b + 1]),
                  f"K5 {name}: row {b} alone is not bitwise equal to its "
                  f"row of the batch")


def check_window_independence(torch, dev, g, shape, dtype="bfloat16"):
    """K2 and K4 in ``dtype`` at ``shape`` = (name, H, KV, hd), the rows of
    ROW_KEYS: query ``s`` of an S' = 5 window equals bitwise the S' = 1
    call at ``pos + s`` over the same arena once the window's first
    ``s`` tokens are written (five calls in turn), and the arena after
    the five calls equals the window call's outside trash block 0.  The
    replay of a preempted request through the verify step rests on
    this: a streamed token re-derived in a window of another width."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
    name, H, KV, hd = shape
    bs, Sq = 16, SERVE_SPEC + 1
    tbl, pos, NB = paged_layout(torch, dev, g, ROW_KEYS, Sq, bs, 4112 // bs)
    B = tbl.shape[0]
    act = slice(0, B - 1)                  # the inactive row left out
    freqs = ref.rope_freqs(hd, 10_000.0, dev)

    def rand(*shp):
        return torch.randn(*shp, device=dev, generator=g).to(
            getattr(torch, dtype))

    q, kn, vn = rand(B, Sq, H, hd), rand(B, Sq, KV, hd), rand(B, Sq, KV, hd)
    kp, vp = rand(NB, bs, KV, hd), rand(NB, bs, KV, hd)
    for kernel, label in ((fused_flash_decode_cuda, "fused_flash_decode"),
                          (fused_flash_decode_splitk_cuda,
                           "fused_flash_decode_splitk")):
        window = [kp.clone(), vp.clone()]
        out = kernel(q, kn, vn, *window, tbl, pos, freqs)
        single = [kp.clone(), vp.clone()]
        queries = []
        for s in range(Sq):
            one = kernel(*(t[:, s:s + 1].contiguous() for t in (q, kn, vn)),
                         *single, tbl, pos + s, freqs)
            queries.append(torch.equal(one[act, 0], out[act, s]))
        arena = all(torch.equal(a[1:], b[1:])
                    for a, b in zip(single, window))
        emit({"phase": "kernel_vs_plain", "kernel": label,
              "dtype": dtype,
              "case": f"{name} window independence S'={Sq} vs {Sq} x S'=1",
              "queries_bitwise": queries, "arena_bitwise": arena})
        check(all(queries) and arena,
              f"{label} {name}: an S'={Sq} window is not bitwise equal to "
              f"{Sq} single-query calls (queries {queries}, arena "
              f"{arena})")


# ---------------------------------------------------------------------------
# phase 2b — are cuBLAS GEMM rows independent of the row count?
# ---------------------------------------------------------------------------

def phase_gemm_width(torch):
    """For minicpm_2b's four GEMM shapes (K x N) in bf16 and f32, and
    granite_moe_3b_a800m's f32 router: is row i of ``x[:M] @ W`` bitwise
    equal to row i of ``x[:16] @ W`` for M = 1, 2, 4, 8, 16, and for the
    first 16 rows at M = 20 (4 slots' verify windows of 5) and 32?  (The
    logits GEMM multiplies by the tied embedding's transpose, as the
    model does.)  For granite's bf16 expert product, the same for the
    rows of each expert at capacities C = 8, 16 and 72.  A reading."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    shapes = {"qkvo": (2304, 2304), "gate_up": (2304, 5760),
              "down": (5760, 2304), "logits": (2304, 122880)}
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, (K, N) in shapes.items():
            x = torch.randn(32, K, device=dev, generator=g).to(dt)
            if name == "logits":
                w = torch.randn(N, K, device=dev, generator=g).to(dt).t()
            else:
                w = torch.randn(K, N, device=dev, generator=g).to(dt)
            full = x[:16] @ w
            row = {}
            for M in (1, 2, 4, 8, 16, 20, 32):
                part = (x[:M] @ w)[:16]
                row[M] = {"equal": bool(torch.equal(part, full[:M])),
                          "max_abs_diff": float(
                              (part.float() - full[:M].float()).abs().max())}
            out[f"{name} {dtype}"] = row
            emit({"phase": "gemm_width", "gemm": name, "K": K, "N": N,
                  "dtype": dtype, "rows_equal_to_width_16": row})
    # granite_moe_3b_a800m: the router's f32 product, which picks each
    # token's experts, and the experts' bf16 batched product at the
    # capacities of a 4-slot decode tick (8), 16 and a 256-row chunk (72)
    K, N = 1536, 48
    x = torch.randn(32, K, device=dev, generator=g)
    w = torch.randn(K, N, device=dev, generator=g)
    full = x[:16] @ w
    row = {}
    for M in (1, 2, 4, 8, 16, 20, 32):
        part = (x[:M] @ w)[:16]
        row[M] = {"equal": bool(torch.equal(part, full[:M])),
                  "max_abs_diff": float((part - full[:M]).abs().max())}
    out["router float32"] = row
    emit({"phase": "gemm_width", "gemm": "router", "K": K, "N": N,
          "dtype": "float32", "rows_equal_to_width_16": row})
    E, ff = 48, 512
    xb = torch.randn(E, 72, K, device=dev, generator=g).to(torch.bfloat16)
    wb = torch.randn(E, K, ff, device=dev, generator=g).to(torch.bfloat16)
    full = torch.bmm(xb[:, :16], wb)
    row = {}
    for C in (8, 16, 72):
        n = min(C, 16)
        part = torch.bmm(xb[:, :C], wb)[:, :n]
        row[C] = {"equal": bool(torch.equal(part, full[:, :n])),
                  "max_abs_diff": float(
                      (part.float() - full[:, :n].float()).abs().max())}
    out["experts bfloat16"] = row
    emit({"phase": "gemm_width", "gemm": "experts", "batch": E, "K": K,
          "N": ff, "dtype": "bfloat16", "rows_equal_to_capacity_16": row})
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 3 — the main path at full width
# ---------------------------------------------------------------------------

def top2_agree(want_tok, got_tok, logits, tol):
    """Tokens equal wherever ``logits``' top-2 gap exceeds ``tol``."""
    import torch
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1] > tol).cpu()
    want = torch.as_tensor(want_tok).cpu()
    got = torch.as_tensor(got_tok).cpu()
    return bool((want[sure] == got[sure]).all()), int(sure.sum())


def drive_engine_path(torch, engine, cfg, rng):
    """The engine's main path with every launch counter at 0 first:
    ``generate`` on GEN_PROMPT prompts for GEN_NEW tokens, then two
    prefill groups inserted into a 4-slot slot cache, TICKS decode ticks
    (slot 3 idle for the first half) and one verify window.  Checks the
    tokens' range and the outputs' shapes; returns the launch counts and
    the schedule's, the tokens and the cache."""
    import numpy as np
    from repro_torch.kernels import build
    L = cfg.num_layers
    prompt = rng.randint(0, cfg.vocab_size, GEN_PROMPT).astype(np.int32)
    groups = [rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
              for S in GROUPS]
    drafts = rng.randint(0, cfg.vocab_size,
                         (4, VERIFY_WIDTH - 1)).astype(np.int32)
    backend = types.SimpleNamespace(kind="slot", num_slots=4)
    for name in build.launches:
        build.launches[name] = 0
    t0 = time.perf_counter()
    gen = engine.generate(prompt, GEN_NEW)
    cache = engine.new_cache(backend)
    last = np.zeros(4, np.int32)
    pos = np.zeros(4, np.int32)
    for gi, toks in enumerate(groups):
        first, rows = engine.prefill(toks)
        for r in range(2):
            cache = engine.insert(backend, cache, rows, r, 2 * gi + r)
            last[2 * gi + r], pos[2 * gi + r] = first[r], toks.shape[1]
    emitted = [last.copy()]
    for t in range(TICKS):
        active = np.array([True, True, True, t >= TICKS // 2])
        tok, cache = engine.decode(backend, cache, last, pos, active)
        emitted.append(tok)
        last = np.where(active, tok, last)
        pos = pos + active
    window = np.concatenate([last[:, None], drafts], axis=1)
    guess, cache = engine.verify(backend, cache, window, pos,
                                 np.ones(4, bool))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(build.launches)
    prefills = 1 + len(GROUPS)
    ticks = (GEN_NEW - 1) + TICKS
    expected = {name: 0 for name in build.launches}
    expected.update({"rmsnorm": (2 * L + 1) * (prefills + ticks + 1),
                     "flash_attention": L * prefills,
                     "fused_flash_decode": L * (ticks + 1)})
    for arr in [gen, guess] + emitted:
        arr = np.asarray(arr)
        check(((arr >= 0) & (arr < cfg.vocab_size)).all(),
              f"{cfg.name}: a token outside the vocab")
    check(gen.shape == (2, GEN_NEW) and guess.shape == (4, VERIFY_WIDTH),
          f"{cfg.name}: output shapes")
    return types.SimpleNamespace(
        counts=counts, expected=expected, gen=gen, guess=guess,
        groups=groups, backend=backend, cache=cache, last=last, pos=pos,
        seconds=seconds)


def phase_main_path(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    L = cfg.num_layers
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.padded_vocab)
          == (40, 2304, 36, 122880), "minicpm_2b is not at full width")
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    run = drive_engine_path(torch, engine, cfg, rng)
    counts, groups = run.counts, run.groups
    emit({"phase": "main_path", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
          "dtype": cfg.dtype, "init_seconds": init_s,
          "path_seconds": run.seconds, "launches": counts,
          "expected_launches": run.expected, "generate": run.gen.tolist(),
          "verify": run.guess.tolist()})
    check(counts == run.expected, f"launch counts {counts} != "
                                  f"{run.expected}")
    backend, cache, last, pos = run.backend, run.cache, run.last, run.pos

    # ---- against the plain path on the same weights ----------------------
    # bf16 kernel and plain paths, and the plain path in f32 on the same
    # weights (upcast) as the reference for both
    plain_flags = RuntimeFlags(use_flash=False, fused_rmsnorm=False,
                               use_fused_decode=False)
    plain = LLMEngine(cfg, dict(engine.model.named_parameters()),
                      max_len=MAX_LEN, flags=plain_flags)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    w32 = {k: v.float() for k, v in engine.model.named_parameters()}
    p32 = LLMEngine(cfg32, w32, max_len=MAX_LEN, flags=plain_flags)
    cmp = compare_first_tick(torch, engine, plain, p32, groups[0], cfg)
    emit({"phase": "main_vs_plain", **cmp})
    check(cmp["ok"], "first-tick logits disagree with the plain path")
    del plain

    # ---- end-to-end decode of the 4-slot batch ---------------------------
    e2e = time_decode(torch, engine, backend, cache, last, pos)
    emit({"phase": "e2e_decode", **e2e})
    del engine, cache

    # ---- all 40 layers in f32: greedy tokens vs the plain path -----------
    k32 = LLMEngine(cfg32, w32, max_len=MAX_LEN)
    toks32 = rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    cmp32 = compare_greedy(torch, k32, p32, toks32, steps=8,
                           tol=F32_MODEL_TOL)
    emit({"phase": "f32_model_vs_plain", **cmp32})
    check(cmp32["ok"], "f32 greedy tokens or logits disagree with the "
                       "plain path")
    del k32, p32, w32
    return counts, e2e


# ---------------------------------------------------------------------------
# phase 3b — the Scheduler over a paged arena at full width and depth
# ---------------------------------------------------------------------------

SERVE_MAX_LEN = 1024
SERVE_BLOCK = 16
SERVE_SLOTS = 4
SERVE_CHUNK = 256
SERVE_SPEC = 4
SERVE_REQUESTS = 8
SERVE_PREFIX = 256            # tokens every prompt starts with
SERVE_NEW = 32
SERVE_MOTIF = 37              # each prompt's body repeats a motif, so
                              # prompt lookup has drafts to propose
#: prompt lengths: the first request's, then the others' (drawn from the
#: seed).  Every prompt ingests in three chunks after the first 256-token
#: chunk of the shared prefix, which only the first request computes, so
#: the request admitted last is always the last to finish its prompt
SERVE_PROMPT = ((724, 768), (804, 850))
#: the arena with room for every slot's longest request (no pressure)
ROOMY_BLOCKS = 1 + SERVE_SLOTS * SERVE_MAX_LEN // SERVE_BLOCK
#: the f32 exactness check compares a step while the reference's top-2
#: logit gap is at least this
TOP2_GAP = 1e-3


def serve_requests(vocab: int):
    """The served prompts: the shared 256-token prefix, then a body that
    repeats a random motif; lengths from SERVE_PROMPT."""
    import numpy as np
    rng = np.random.RandomState(SEED + 3)
    prefix = rng.randint(0, vocab, SERVE_PREFIX)
    (lo0, hi0), (lo, hi) = SERVE_PROMPT
    lengths = [rng.randint(lo0, hi0 + 1)] + list(
        rng.randint(lo, hi + 1, SERVE_REQUESTS - 1))
    out = []
    for n in lengths:
        motif = rng.randint(0, vocab, SERVE_MOTIF)
        body = np.tile(motif, -(-(n - SERVE_PREFIX) // SERVE_MOTIF))
        out.append(np.concatenate([prefix, body[:n - SERVE_PREFIX]])
                   .astype(np.int32))
    return out


def pressure_blocks(requests):
    """The arena under pressure: (num_blocks, the fewest blocks four
    prompts take, the most three requests take at their end).

    Pressure preempts the youngest request in a slot.  A victim that has
    streamed tokens replays its prompt and tokens through prefill and
    must re-derive its last token, which a decode step produced; in
    bf16 the two round differently and 40 random layers amplify one ulp
    into a different token about half of the time, so a victim must
    hold no streamed token.  The arena is sized so that any three
    requests fit at their last token (a decode step never runs short
    while at most three slots decode) and no four prompts fit together
    (so four slots never decode at once, and pressure only arises while
    the youngest request still ingests its prompt).  Blocks are counted
    beside the shared prefix's 16, held once."""
    import itertools
    bs, shared = SERVE_BLOCK, SERVE_PREFIX // SERVE_BLOCK
    prompt = [-(-p.size // bs) - shared for p in requests]
    end = [-(-(p.size + SERVE_NEW + SERVE_SPEC + 1) // bs) - shared
           for p in requests]
    three = shared + max(sum(c) for c in itertools.combinations(end, 3))
    four = shared + min(sum(c) for c in itertools.combinations(prompt, 4))
    check(three < four, f"no arena size separates three requests' ends "
                        f"({three} blocks) from four prompts ({four})")
    return 1 + three, four, three


def always_draft(context, k):
    """Prompt lookup's draft, or else the last token repeated: random
    weights seldom emit a token of the prompt, and lookup alone would
    leave nearly every tick a plain decode.  So every tick of a
    speculating request but its last verifies a window of 1 + k."""
    import numpy as np
    from repro_torch.serving import lookup_draft
    d = lookup_draft(context, k)
    return d if d.size else np.repeat(np.asarray(context[-1:], np.int32), k)


def serve(torch, engine, requests, num_blocks, *, paged=True,
          prefix_sharing=True, speculate_k=SERVE_SPEC, hook=None):
    """Serve ``requests`` through the port's ``Scheduler`` to completion,
    with every launch counter at 0 before the first call; ``hook(sched)``
    is called before the requests are submitted.  Returns ({id:
    tokens}, scheduler stats with the wall seconds spent in ``admit``
    (admission and prompt ingestion) and in ``step`` (decode and verify
    ticks), launch counts, wall seconds)."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.serving import PagedBackend, Scheduler, SlotBackend
    if paged:
        backend = PagedBackend(engine, SERVE_SLOTS, num_blocks=num_blocks,
                               block_size=SERVE_BLOCK,
                               prefix_sharing=prefix_sharing)
    else:
        backend = SlotBackend(engine, SERVE_SLOTS)
    sched = Scheduler(backend, max_new_tokens=SERVE_NEW,
                      chunk_size=SERVE_CHUNK, speculate_k=speculate_k,
                      draft_fn=always_draft)
    if hook is not None:
        hook(sched)
    for i, p in enumerate(requests):
        sched.submit({"tokens": p, "id": i})
    for name in build.launches:
        build.launches[name] = 0
    t0 = time.perf_counter()
    got = {}
    split = {"admit_seconds": 0.0, "step_seconds": 0.0}
    while sched.has_work():
        for part, call in (("admit_seconds", sched.admit),
                           ("step_seconds", sched.step)):
            t1 = time.perf_counter()
            events = call()
            split[part] += time.perf_counter() - t1
            for ev in events:
                if ev.finished:
                    got[ev.request.id] = np.asarray(ev.request.tokens,
                                                    np.int32)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return got, {**sched.stats, **split}, dict(build.launches), wall


def expected_serve_launches(cfg, stats, attend: str):
    """Launches the schedule in ``stats`` implies: every forward pass
    runs 2 norms per layer and the final one; every prefill or extend
    call one K3 per layer; every decode or verify tick, and every decode
    or verify call of a replay, one ``attend`` per layer."""
    from repro_torch.kernels import build
    L = cfg.num_layers
    pre = stats["prefill_calls"]
    ticks = stats["decode_steps"] + stats["replay_steps"]
    want = {name: 0 for name in build.launches}
    want.update({"rmsnorm": (2 * L + 1) * (pre + ticks),
                 "flash_attention": L * pre, attend: L * ticks})
    return want


#: the three runs of the serve phase: (name, flags, speculate_k, the
#: decode attention kernel they must launch)
SERVE_RUNS = (
    ("default", {}, SERVE_SPEC, "fused_flash_decode"),
    ("split_k", {"fused_split_k": True}, SERVE_SPEC,
     "fused_flash_decode_splitk"),
    ("paged_kernel", {"use_fused_decode": False, "use_paged_kernel": True},
     0, "paged_attention"),
)


def phase_serve(torch):
    """The Scheduler on a PagedBackend at full width and depth (bf16
    minicpm_2b, random weights from the seed): three runs launched by
    the engine's flags, each held to the launches its schedule implies;
    the layout check (paged and slot backends, bitwise equal tokens);
    the exactness check in f32 against a per-request greedy reference;
    and the paged decode tick's time.  Returns the launch counts of the
    three runs and the tokens by request of each run and of the slot
    layout's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    requests = serve_requests(cfg.vocab_size)
    check(all(p.size + SERVE_NEW <= SERVE_MAX_LEN for p in requests),
          "a served request longer than max_len")
    blocks, four, three = pressure_blocks(requests)
    emit({"phase": "serve_workload", "prompt_lengths":
          [int(p.size) for p in requests], "num_blocks": blocks,
          "blocks_four_prompts": four, "blocks_three_ends": three})
    engines = {}
    counts_all = {}
    tokens = {}
    for name, flags, spec, attend in SERVE_RUNS:
        engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                           flags=RuntimeFlags(**flags))
        engines[name] = engine
        got, stats, counts, wall = serve(torch, engine, requests, blocks,
                                         speculate_k=spec)
        want = expected_serve_launches(cfg, stats, attend)
        emit({"phase": "serve", "run": name, "flags": flags,
              "speculate_k": spec, "num_blocks": blocks,
              "seconds": wall, "launches": counts,
              "expected_launches": want,
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "spec_drafted", "spec_accepted",
                  "preemptions", "replayed_tokens", "shared_block_hits",
                  "prefill_tokens_saved", "completed", "admit_seconds",
                  "step_seconds")}})
        check(counts == want, f"serve {name}: launch counts {counts} != "
                              f"{want}")
        check(stats["preemptions"] > 0, f"serve {name}: no preemption")
        check(stats["completed"] == len(requests)
              and sorted(got) == list(range(len(requests))),
              f"serve {name}: not every request completed")
        for i, toks in got.items():
            check(toks.shape == (SERVE_NEW,)
                  and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
                  f"serve {name}: request {i}'s tokens")
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        tokens[name] = got
        if name == "paged_kernel":
            del engines[name], engine

    # ---- the layout check: paged and slot, no sharing, no pressure -----
    engine = engines["default"]
    paged, _, _, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                           prefix_sharing=False)
    slot, stats, _, _ = serve(torch, engine, requests, 0, paged=False)
    tokens["slot"] = slot
    equal = [bool(np.array_equal(paged[i], slot[i]))
             for i in range(len(requests))]
    emit({"phase": "serve_layouts", "requests": len(requests),
          "bitwise_equal": sum(equal), "preemptions": stats["preemptions"]})
    check(all(equal), "paged and slot backends' tokens are not bitwise "
                      "equal")

    # ---- the paged decode tick, with K2 and with K4 --------------------
    for name in ("split_k", "default"):
        tick = time_paged_tick(torch, engines.pop(name), requests)
        emit({"phase": "serve_tick", "run": name, **tick})
    emit({"phase": "serve_replay", "dtype": cfg.dtype,
          **replay_agreement(engine, requests)})
    emit({"phase": "serve_replay_decode", "dtype": cfg.dtype,
          **decode_replay_agreement(engine, requests)})

    # ---- exactness in f32 against per-request greedy -------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    w32 = {k: v.float() for k, v in engine.model.named_parameters()}
    del engine
    e32 = LLMEngine(cfg32, w32, max_len=SERVE_MAX_LEN)
    emit({"phase": "serve_replay", "dtype": "float32",
          **replay_agreement(e32, requests)})
    got, stats, _, _ = serve(torch, e32, requests, blocks)
    exact = compare_with_greedy(torch, e32, requests, got)
    emit({"phase": "serve_f32_exact", "preemptions": stats["preemptions"],
          "replayed_tokens": stats["replayed_tokens"],
          "spec_steps": stats["spec_steps"], **exact})
    check(exact["rows_compared"] > 0, "f32 exactness: no row compared")
    check(exact["mismatches"] == 0, "f32 exactness: a served token differs "
                                    "from the greedy reference's")
    del e32, w32
    return counts_all, tokens


def replay_agreement(engine, requests, new=24, cuts=(1, 6, 12, 18, 23)):
    """How often a prefill re-derives the token a decode step emitted,
    as a replay after a mid-decode preemption must: four requests are
    decoded greedily by ``generate``, then each prompt ++ its first
    ``n`` tokens is prefilled and its next token compared with token
    ``n``.  A reading, not a check: it is why the serve workload keeps
    streamed tokens out of preemption."""
    import numpy as np
    agree = []
    for p in requests[:4]:
        gen = engine.generate(p[None], new)[0]
        for n in cuts:
            tok, _ = engine.prefill(np.concatenate([p, gen[:n]])[None])
            agree.append(int(tok[0]) == int(gen[n]))
    return {"agree": sum(agree), "cuts": len(agree)}


def decode_replay_agreement(engine, requests, new=24,
                            cuts=(1, 6, 12, 18, 23)):
    """``replay_agreement``'s reading for the replay through the decode
    step: each prompt ++ its first ``n`` greedy tokens is ingested as a
    preempted request's replay is (the prompt by prefill, the tokens by
    decode steps over the 4 slots, each derived token checked), and the
    token derived after them is compared with token ``n``."""
    from repro_torch.serving import PagedBackend, Scheduler
    from repro_torch.serving.batching import Request
    be = PagedBackend(engine, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS,
                      block_size=SERVE_BLOCK, prefix_sharing=False)
    Scheduler(be)                          # binds the arena and stats
    agree = []
    for p in requests[:4]:
        gen = engine.generate(p[None], new)[0]
        for n in cuts:
            req = Request(id=n, prompt=p, max_new_tokens=new,
                          tokens=[int(t) for t in gen[:n + 1]])
            req.slot = 0
            be.acquire(req, req.seq)
            try:
                tok = be.ingest(req, req.seq, 0, len(req.seq))
                agree.append(tok == int(gen[n]))
            except RuntimeError:           # a streamed token not derived
                agree.append(False)
            be.release(req)
    return {"agree": sum(agree), "cuts": len(agree),
            "replay_steps": be.stats["replay_steps"]}


def compare_with_greedy(torch, engine, requests, got):
    """Each request alone through ``engine.model``: prefill, then greedy
    decode steps, keeping the logits.  A served token must equal the
    reference's while the reference's top-2 gap is at least TOP2_GAP; a
    row is compared up to its first near-tie."""
    V = engine.cfg.vocab_size
    dev = engine.device
    rows = tokens = mismatches = 0
    near_ties = []
    for i, prompt in enumerate(requests):
        x = torch.as_tensor(prompt, device=dev).long()[None]
        logits, cache = engine.model.prefill(x, SERVE_MAX_LEN,
                                             flags=engine.flags)
        n = 0
        for j in range(SERVE_NEW):
            top2 = torch.topk(logits[0, :V].float(), 2).values
            gap = float(top2[0] - top2[1])
            tok = int(torch.argmax(logits[0, :V]))
            if gap < TOP2_GAP:
                near_ties.append([i, j, gap])
                break
            n += 1
            if tok != int(got[i][j]):
                mismatches += 1
                break
            pos = torch.full((1,), prompt.size + j, dtype=torch.int32,
                             device=dev)
            logits, cache = engine.model.decode_step(
                torch.tensor([[tok]], device=dev), cache, pos,
                flags=engine.flags)
        rows += n > 0
        tokens += n
    return {"rows": len(requests), "rows_compared": rows,
            "tokens_compared": tokens, "mismatches": mismatches,
            "near_ties": near_ties, "top2_gap": TOP2_GAP}


def time_paged_tick(torch, engine, requests, ticks=20, profiled=5):
    """Wall time of one Scheduler decode tick (4 active slots, paged
    arena, default flags, no speculation) and the device's share of it
    from the profiler."""
    from repro_torch.serving import PagedBackend, Scheduler
    backend = PagedBackend(engine, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS,
                           block_size=SERVE_BLOCK)
    sched = Scheduler(backend, max_new_tokens=4 + ticks + profiled,
                      chunk_size=SERVE_CHUNK)
    for i, p in enumerate(requests[:SERVE_SLOTS]):
        sched.submit({"tokens": p, "id": i})
    while sched.ingesting or sched.waiting:
        sched.admit()
    check(sched.active == SERVE_SLOTS, "tick timing: slots not all active")
    keys = [int(p) for p in sched.positions]
    for _ in range(3):
        sched.step()
    times = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        sched.step()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    per = profiled_ms(torch, sched.step, profiled)
    return {"slots": SERVE_SLOTS, "ticks": ticks,
            "keys_at_first_tick": keys,
            "ms_per_tick_median": ms, "ms_per_tick_min": min(times) * 1e3,
            "tokens_per_s": SERVE_SLOTS / (ms / 1e3),
            **device_share(per, ms, (
                "rmsnorm_kernel", "fused_decode_mma_kernel",
                "splitk_mma_kernel", "splitk_combine_kernel"))}


def compare_first_tick(torch, engine, plain, ref32, toks, cfg):
    """Prefill the same prompt on the bf16 kernel path, the bf16 plain
    path and the f32 plain reference ``ref32`` (the same weights,
    upcast), run one decode tick, and compare the logits.  bf16 rounds
    at different points on the two bf16 paths and 40 random layers
    amplify a 1-ulp difference until both sit about a quarter of the
    logits' scale from the f32 run, so no top-2 gap is wide enough to
    compare greedy tokens here (the f32 comparison does that).  The
    test: finite logits, the kernel path no further from the f32
    reference than twice the plain path's distance, and kernel and
    plain logits within ``tol`` of the logits' scale."""
    x = torch.as_tensor(toks).long().cuda()
    out = {}
    nxt = None
    for name, e in (("kernel", engine), ("plain", plain), ("f32", ref32)):
        l0, c = e.model.prefill(x, MAX_LEN, flags=e.flags)
        if nxt is None:
            nxt = torch.argmax(l0, -1)[:, None]
        p = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                       device="cuda")
        l1, _ = e.model.decode_step(nxt, c, p, flags=e.flags)
        out[name] = (l0[:, :cfg.vocab_size].float(),
                     l1[:, :cfg.vocab_size].float())
    res = {}
    tol = 0.1
    ok = True
    for i, step in enumerate(("prefill", "tick1")):
        k, p, r = (out[n][i] for n in ("kernel", "plain", "f32"))
        finite = bool(torch.isfinite(k).all() and torch.isfinite(p).all())
        scale = float(r.abs().max())
        err_kp = float((k - p).abs().max())
        err_k = float((k - r).abs().max())
        err_p = float((p - r).abs().max())
        res[step] = {"kernel_vs_plain": err_kp, "kernel_vs_f32": err_k,
                     "plain_vs_f32": err_p, "logit_scale": scale,
                     "finite": finite}
        ok = ok and finite and err_k <= 2 * err_p and err_kp <= tol * scale
    return {"tol_rel": tol, "ok": ok, **res}


def compare_greedy(torch, engine, plain, toks, steps, tol):
    """Greedy decode on the kernel path; the plain path is teacher-forced
    on its tokens.  Tokens must agree wherever the plain logits' top-2
    gap exceeds ``tol``, and at least half of the rows must be compared
    so; logits are held at ``tol`` too."""
    x = torch.as_tensor(toks).long().cuda()
    B, S = x.shape
    V = engine.cfg.vocab_size
    lk, ck = engine.model.prefill(x, MAX_LEN)
    lp, cp = plain.model.prefill(x, MAX_LEN, flags=plain.flags)
    worst, scale, agree_all, compared = 0.0, 0.0, True, 0
    for i in range(steps):
        lk, lp = lk[:, :V], lp[:, :V]
        for a in (lk, lp):
            check(bool(torch.isfinite(a).all()), "non-finite logits")
        worst = max(worst, float((lk - lp).abs().max()))
        scale = max(scale, float(lp.abs().max()))
        tok = torch.argmax(lk, -1)
        agree, n = top2_agree(torch.argmax(lp, -1), tok, lp, tol)
        agree_all, compared = agree_all and agree, compared + n
        pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
        lk, ck = engine.model.decode_step(tok[:, None], ck, pos)
        lp, cp = plain.model.decode_step(tok[:, None], cp, pos,
                                         flags=plain.flags)
    total = steps * B
    return {"steps": steps, "rows": B, "max_abs_logit_err": worst,
            "logit_scale": scale, "tol": tol, "tokens_agree": agree_all,
            "tokens_compared": compared, "tokens_total": total,
            "ok": agree_all and worst <= tol and 2 * compared >= total}


def time_decode(torch, engine, backend, cache, last, pos, ticks=20):
    import numpy as np
    active = np.ones(4, bool)
    pos = pos.copy()
    for _ in range(3):                                   # warm-up
        _, cache = engine.decode(backend, cache, last, pos, active)
    times = []
    for _ in range(ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = engine.decode(backend, cache, last, pos, active)
        times.append(time.perf_counter() - t0)
        last, pos = tok, pos + 1
    ms = statistics.median(times) * 1e3
    # device time per tick by kernel, from the profiler over 5 ticks;
    # the busy share sets it against the tick's wall time without the
    # profiler
    state = [last, cache, pos]

    def tick():
        state[0], state[1] = engine.decode(backend, state[1], state[0],
                                           state[2], active)
        state[2] = state[2] + 1

    per = profiled_ms(torch, tick, 5)
    top = [(name[:80], t) for name, t in
           sorted(per.items(), key=lambda kv: -kv[1])[:8]]
    return {"slots": 4, "ticks": ticks, "ms_per_tick_median": ms,
            "ms_per_tick_min": min(times) * 1e3,
            "tokens_per_s": 4 / (ms / 1e3),
            **device_share(per, ms, ("rmsnorm_kernel",
                                     "fused_decode_mma_kernel")),
            "top_kernels_ms_per_tick": top}


# ---------------------------------------------------------------------------
# phase 3c — the serve workload through GraphServer and AsyncFrontend
# ---------------------------------------------------------------------------

#: the device sleep ahead of the sync point's event, so that the event
#: is still pending unless the sync point waits for it
SYNC_SLEEP_MS = 50


def graph_run(torch, engine, requests, blocks, hook=None):
    """The requests streamed by ``AsyncFrontend`` from a ``GraphServer``
    over a paged arena of ``blocks`` blocks (the serve phase's chunk,
    slots and speculation; prompt lookup drafts), on ``engine``, called
    from the graph's executor thread, with every launch counter at 0
    first; ``hook(sched)`` is called on the server's scheduler before
    the first submit.  Returns the streams, launch counts, scheduler
    stats, metrics, request timelines, wall seconds, whether the arena
    drained at close, and the finish reasons."""
    import asyncio
    from repro_torch.kernels import build
    from repro_torch.serving import (AsyncFrontend, GraphServer, Policy,
                                     RequestTimeline)
    for name in build.launches:
        build.launches[name] = 0
    server = GraphServer(engine, backend="paged", num_slots=SERVE_SLOTS,
                         block_size=SERVE_BLOCK, chunk_size=SERVE_CHUNK,
                         speculate_k=SERVE_SPEC, num_blocks=blocks,
                         max_new_tokens=SERVE_NEW)
    sched = server._engine_calc.sched
    if hook is not None:
        hook(sched)
    handles = {}
    try:
        front = AsyncFrontend(server, policy=Policy(timeout_ms=600_000))

        async def stream(i, prompt):
            return [tok async for tok in front.stream(
                prompt, request_id=i,
                on_handle=lambda h: handles.__setitem__(h.id, h))]

        async def run():
            # a failed run fails the streams at once (the port's
            # GraphServer._pump), so they alone are awaited
            return await asyncio.gather(
                *(stream(i, p) for i, p in enumerate(requests)))

        t0 = time.perf_counter()
        streams = asyncio.run(run())
        wall = time.perf_counter() - t0
        out = types.SimpleNamespace(
            streams=streams, wall=wall, counts=dict(build.launches),
            stats=server.stats()["scheduler"], metrics=server.metrics(),
            records=RequestTimeline.from_tracer(
                server.graph.tracer).records())
    finally:
        server.close()
    out.drained = (sorted(sched.free) == list(range(SERVE_SLOTS))
                   and sched.pool.blocks_in_use == 0
                   and sched.pool.reserved_blocks == 0
                   and len(sched.prefix) == 0)
    out.reasons = {i: handles[i].finish_reason for i in handles}
    return out


def phase_graph_serve(torch, want, smi):
    """The serve workload through the graph: the 8 requests streamed by
    ``AsyncFrontend`` from a ``GraphServer`` over a paged arena (the
    serve phase's arena, chunk, slots and speculation), on the engine
    built here and called from the graph's executor thread.  Every
    request must finish with the tokens the Scheduler gave it in phase
    serve's default run, bitwise; the launches must be those the
    server's schedule implies; the arena must drain at close.  Prints
    TTFT, time per output token, tokens/s and preemptions from the
    server's metrics and request timelines, each beside the card's
    name and power limit.  Then the device sync point.  Returns the
    launch counts and the tokens by request."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    requests = serve_requests(cfg.vocab_size)
    blocks, _, _ = pressure_blocks(requests)
    engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    run = graph_run(torch, engine, requests, blocks)
    counts, stats, metrics, records = (run.counts, run.stats, run.metrics,
                                       run.records)
    want_launches = expected_serve_launches(cfg, stats, "fused_flash_decode")
    got = {i: np.asarray(s, np.int32) for i, s in enumerate(run.streams)}
    equal = [bool(np.array_equal(got[i], want[i])) for i in got]
    emit({"phase": "graph_serve", "requests": len(requests),
          "num_blocks": blocks, "seconds": run.wall, "launches": counts,
          "expected_launches": want_launches,
          "bitwise_equal_to_serve": sum(equal),
          "finish_reasons": run.reasons, "arena_drained": run.drained,
          "graphs_captured": graph_count(engine),
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "shared_block_hits",
              "completed")}})
    check(stats["completed"] == len(requests)
          and all(r == "length" for r in run.reasons.values())
          and len(run.reasons) == len(requests),
          "graph_serve: not every request finished")
    check(all(equal), "graph_serve: a request's tokens differ from phase "
                      "serve's default run")
    check(counts == want_launches, f"graph_serve: launch counts {counts} "
                                   f"!= {want_launches}")
    check(run.drained, "graph_serve: the arena did not drain at close")

    # ---- the readings: server metrics and request timelines ------------
    def hist(name, q):
        return metrics[name]["values"][0][q]
    ttft = [r["ttft_ms"] for r in records]
    tpot = [(r["finished_ms"] - r["first_token_ms"]) / (r["tokens"] - 1)
            for r in records]
    tokens = sum(r["tokens"] for r in records)
    span_ms = max(r["finished_ms"] for r in records) - \
        min(r["submitted_ms"] for r in records)
    check(len(records) == len(requests)
          and tokens == len(requests) * SERVE_NEW,
          "graph_serve: the request timelines miss a request or a token")
    readings = [
        {"metric": "ttft_ms", "p50": float(np.percentile(ttft, 50)),
         "p95": float(np.percentile(ttft, 95)), "histogram_p50": hist(
             "serve.ttft_ms", "p50"), "histogram_p95": hist(
             "serve.ttft_ms", "p95"), "requests": len(ttft)},
        {"metric": "tpot_ms", "p50": float(np.percentile(tpot, 50)),
         "itl_histogram_p50": hist("serve.itl_ms", "p50"),
         "requests": len(tpot)},
        {"metric": "tokens_per_s", "value": tokens / (span_ms / 1e3),
         "tokens": tokens, "span_ms": span_ms},
        {"metric": "preemptions", "value": stats["preemptions"],
         "replayed_tokens": stats["replayed_tokens"]},
    ]
    for r in readings:
        emit({"phase": "graph_serve_reading", **r, "nvidia_smi": smi})
    check(all(np.isfinite(ttft)) and all(np.isfinite(tpot)),
          "graph_serve: a non-finite reading")

    check_sync_point(torch, engine)
    return counts, got


def graph_count(engine):
    """The engine's captured graphs and their shared pool's bytes."""
    if engine.graphs is None:
        return {"graphs": 0, "pool_bytes": 0}
    return {"graphs": len(engine.graphs),
            "pool_bytes": engine.graphs.pool_bytes()}


def check_sync_point(torch, engine):
    """A graph ``InferenceCalculator -> SyncPointCalculator`` whose engine
    calls ``engine.__call__`` (greedy tokens, on the host) and then the
    model's prefill on the card, queued behind a device sleep, and
    records an event after it.  The packet that leaves the sync point
    must carry the same logits tensor, the event must have completed,
    and the logits' argmax must be the first greedy token."""
    import numpy as np
    import repro_torch.calculators  # noqa: F401 (registers them)
    from repro_torch.core import Graph, GraphBuilder
    b = GraphBuilder()
    infer = b.add_node("InferenceCalculator", name="infer",
                       inputs={"IN": b.input("prompts")},
                       side_inputs={"engine": b.side_input("engine")})
    sync = b.add_node("SyncPointCalculator", name="sync",
                      inputs={"IN": infer.out("OUT", name="results")})
    b.output(sync.out("OUT", name="synced"))
    made = []

    def run(payload):
        toks = engine(payload)
        x = torch.as_tensor(payload["tokens"], device="cuda").long()
        torch.cuda._sleep(int(SYNC_SLEEP_MS * SLEEP_CYCLES_PER_MS))
        logits, _ = engine.model.prefill(x, SERVE_MAX_LEN,
                                         flags=engine.flags)
        event = torch.cuda.Event()
        event.record()
        made.append((logits, event))
        return {"tokens": toks, "logits": logits}

    graph = Graph(b.build(), side_packets={"engine": run})
    poller = graph.add_output_stream_poller("synced")
    graph.start_run()
    prompt = serve_requests(engine.cfg.vocab_size)[0][None, :64]
    graph.add_packet_to_input_stream(
        "prompts", {"tokens": prompt, "max_new_tokens": 4}, 0)
    graph.close_all_input_streams()
    pkt = poller.next()
    logits, event = made[0]
    done = event.query()
    graph.wait_until_done(timeout=120)
    out = pkt.payload
    first = int(torch.argmax(out["logits"][0]))
    emit({"phase": "sync_point", "same_tensor": out["logits"] is logits,
          "event_done_on_arrival": done, "device_sleep_ms": SYNC_SLEEP_MS,
          "first_token": first, "greedy_tokens": out["tokens"][0].tolist()})
    check(out["logits"] is logits and out["logits"].is_cuda,
          "sync point: the packet does not carry the same CUDA tensor")
    check(done, "sync point: the packet left before the work it waits for")
    check(first == int(out["tokens"][0, 0]),
          "sync point: the logits' argmax is not the first greedy token")
    check(bool(torch.isfinite(out["logits"]).all()),
          "sync point: non-finite logits")
    check(isinstance(out["tokens"], np.ndarray),
          "sync point: engine.__call__ did not return host tokens")


# ---------------------------------------------------------------------------
# phase 3d — preemption mid-decode, replayed through the decode step
# ---------------------------------------------------------------------------

#: forced preemptions per run, and the tokens each victim has streamed
PREEMPTIONS = 6
PREEMPT_AFTER = 8


class ForcedPreemption:
    """Preempts requests mid-decode and checks what their replays write.

    ``install(sched)`` wraps the scheduler's ``step`` and its backend's
    ``ingest``.  Before a decode tick it preempts one decoding request
    that has streamed at least PREEMPT_AFTER tokens, has 4 more to go
    and was not preempted yet, until PREEMPTIONS, after reading the
    request's K/V at every position it holds through its block table.
    When the request's replay completes (the ``ingest`` of its last
    chunk returns) its K/V are read again through its new table and
    compared bitwise.  Under a ``GraphServer`` this runs on the engine's
    executor thread, inside the scheduler's own calls."""

    def __init__(self, torch):
        self.torch = torch
        self.streamed = []                 # each victim's streamed tokens
        self.kv_equal = []                 # one per completed replay
        self._held = {}                    # victim -> its K/V

    def install(self, sched):
        self.sched = sched
        step, ingest = sched.step, sched.backend.ingest

        def forced_step():
            self._preempt()
            return step()

        def checked_ingest(req, seq, start, end):
            tok = ingest(req, seq, start, end)
            if end == len(seq) and req in self._held:
                before = self._held.pop(req)
                self.kv_equal.append(all(
                    self.torch.equal(a, b)
                    for a, b in zip(before, self._kv(req, len(seq)))))
            return tok

        sched.step = forced_step
        sched.backend.ingest = checked_ingest

    def _preempt(self):
        sched = self.sched
        if len(self.streamed) >= PREEMPTIONS:
            return
        for req in sched.slots:
            if (req is not None and req not in sched.ingesting
                    and req.preemptions == 0
                    and PREEMPT_AFTER <= len(req.tokens)
                    <= req.max_new_tokens - 4):
                self._held[req] = self._kv(req, int(sched.positions[req.slot]))
                self.streamed.append(len(req.tokens))
                sched.preempt(req)
                return

    def _kv(self, req, n):
        """Positions ``[0, n)`` of each K/V leaf of ``req``, every layer,
        read through its block table."""
        from repro_torch.models.params import flatten
        be = self.sched.backend
        pages = self.torch.as_tensor(
            be.tables[req.slot][:-(-n // be.block_size)],
            device=be.engine.device).long()
        out = []
        for leaf in flatten(be.cache).values():      # [R, NB, bs, KV, hd]
            rows = leaf[:, pages].reshape(leaf.shape[0], -1, *leaf.shape[3:])
            out.append(rows[:, :n].clone())
        return out


def check_forced(label, forced, stats, got, want, counts, want_launches,
                 phase="serve_preempt_decode"):
    """Print and hold one run with forced preemptions against the same
    run without them: at least 4 preemptions of requests that had
    streamed PREEMPT_AFTER tokens or more (and no other preemption),
    streamed tokens replayed, each replayed row's K/V bitwise what it
    held, every request's tokens bitwise equal, launches equal to the
    schedule."""
    import numpy as np
    equal = sum(bool(np.array_equal(got[i], want[i])) for i in want)
    emit({"phase": phase, "run": label,
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_kv_bitwise": sum(forced.kv_equal),
          "replays_checked": len(forced.kv_equal),
          "bitwise_equal_to_unpreempted": equal, "requests": len(want),
          "launches": counts, "expected_launches": want_launches,
          "stats": {k: stats[k] for k in (
              "preemptions", "replayed_tokens", "replay_steps",
              "prefill_calls", "decode_steps", "spec_steps")}})
    check(len(forced.streamed) >= 4
          and min(forced.streamed) >= PREEMPT_AFTER,
          f"{label}: fewer than 4 mid-decode preemptions")
    check(stats["preemptions"] == len(forced.streamed),
          f"{label}: a preemption that was not forced")
    check(stats["replayed_tokens"] > 0 and stats["replay_steps"] > 0,
          f"{label}: no streamed token replayed through the decode step")
    check(len(forced.kv_equal) == len(forced.streamed)
          and all(forced.kv_equal),
          f"{label}: a replayed row's K/V differ from what it held")
    check(equal == len(want), f"{label}: a request's tokens differ from "
                              f"the run without preemption")
    check(counts == want_launches, f"{label}: launch counts {counts} != "
                                   f"{want_launches}")


def phase_serve_preempt_decode(torch):
    """Hazard 5 closed: bf16 minicpm_2b at full width and depth, the
    serve workload on a roomy arena, PREEMPTIONS requests preempted after
    streaming tokens (``ForcedPreemption``), each replayed through the
    decode step: through the Scheduler with K2 (default flags) and with
    K4 (``fused_split_k``), then through ``GraphServer`` and
    ``AsyncFrontend`` (K2; prompt lookup alone drafts, so the ticks
    decode one token and the replays verify windows of 5).  Each is held
    to the same run without preemption (``check_forced``).  Returns the
    launch counts of the runs with preemption and the tokens by request
    of the Scheduler runs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    requests = serve_requests(cfg.vocab_size)
    counts_all, tokens = {}, {}
    for name, flags, spec, attend in SERVE_RUNS[:2]:
        engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                           flags=RuntimeFlags(**flags))
        want, st0, _, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                                speculate_k=spec)
        check(st0["preemptions"] == 0, f"{name}: the roomy arena preempted")
        forced = ForcedPreemption(torch)
        got, stats, counts, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                                      speculate_k=spec, hook=forced.install)
        check_forced(name, forced, stats, got, want, counts,
                     expected_serve_launches(cfg, stats, attend))
        tokens[name] = got
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    # ---- through GraphServer and AsyncFrontend, on the K2 engine -------
    engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    plain = graph_run(torch, engine, requests, ROOMY_BLOCKS)
    check(plain.stats["preemptions"] == 0, "graph: the roomy arena "
                                           "preempted")
    forced = ForcedPreemption(torch)
    run = graph_run(torch, engine, requests, ROOMY_BLOCKS,
                    hook=forced.install)
    check_forced("graph", forced, run.stats,
                 {i: np.asarray(t, np.int32)
                  for i, t in enumerate(run.streams)},
                 {i: np.asarray(t, np.int32)
                  for i, t in enumerate(plain.streams)},
                 run.counts, expected_serve_launches(cfg, run.stats,
                                                     "fused_flash_decode"))
    check(run.drained and all(r == "length" for r in run.reasons.values()),
          "graph: a request did not finish, or the arena did not drain")
    for k, v in run.counts.items():
        counts_all[k] = counts_all.get(k, 0) + v
    return counts_all, tokens


# ---------------------------------------------------------------------------
# phase 3e — the decode and verify steps as CUDA graphs against eager
# ---------------------------------------------------------------------------

#: decode ticks read per engine and layout, in turns
TICK_READS = 120


def phase_captured(torch, captured, smi):
    """``captured`` holds the tokens by request of runs made so far with
    the engine's default, captured steps: the serve phase's three runs
    (``default``, ``split_k``, ``paged_kernel``) and its slot-layout run
    (``slot``), ``graph_serve``, and serve_preempt_decode's K2 run with
    forced preemptions.  Each runs again here on an engine whose steps
    run eagerly (``cuda_graphs`` off): tokens bitwise equal, launches
    equal to the schedule.  Then the paged and the slot decode tick,
    captured and eager, in turns (``interleaved_ticks``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    requests = serve_requests(cfg.vocab_size)
    blocks, _, _ = pressure_blocks(requests)

    def compare(label, got, stats, counts, attend):
        want = expected_serve_launches(cfg, stats, attend)
        equal = sum(bool(np.array_equal(np.asarray(got[i], np.int32),
                                        captured[label][i]))
                    for i in captured[label])
        emit({"phase": "captured", "run": label, "steps": "eager",
              "bitwise_equal_to_captured": equal,
              "requests": len(captured[label]), "launches": counts,
              "expected_launches": want,
              **{k: stats[k] for k in ("admit_seconds", "step_seconds")
                 if k in stats}})
        check(equal == len(requests) == len(captured[label]),
              f"captured {label}: eager tokens differ from captured")
        check(counts == want, f"captured {label}: eager launch counts "
                              f"{counts} != {want}")

    eager = None
    for name, flags, spec, attend in SERVE_RUNS:
        engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                           flags=RuntimeFlags(cuda_graphs=False, **flags))
        check(engine.graphs is None, "an engine with cuda_graphs off "
                                     "captures")
        got, stats, counts, _ = serve(torch, engine, requests, blocks,
                                      speculate_k=spec)
        compare(name, got, stats, counts, attend)
        if name == "default":
            eager = engine
    got, stats, counts, _ = serve(torch, eager, requests, 0, paged=False)
    compare("slot", got, stats, counts, "fused_flash_decode")
    run = graph_run(torch, eager, requests, blocks)
    compare("graph_serve", dict(enumerate(run.streams)), run.stats,
            run.counts, "fused_flash_decode")
    forced = ForcedPreemption(torch)
    got, stats, counts, _ = serve(torch, eager, requests, ROOMY_BLOCKS,
                                  hook=forced.install)
    check(len(forced.streamed) >= 4 and all(forced.kv_equal),
          "captured: the eager run's forced preemptions")
    compare("serve_preempt_decode", got, stats, counts,
            "fused_flash_decode")

    # ---- tick times: captured and eager on the same weights, in turns --
    steps = {"captured": LLMEngine(cfg, dict(eager.model.named_parameters()),
                                   max_len=SERVE_MAX_LEN),
             "eager": eager}
    for kind in ("paged", "slot"):
        for name, r in interleaved_ticks(torch, steps, requests,
                                         kind).items():
            emit({"phase": "captured_tick", "layout": kind, "steps": name,
                  **r, "nvidia_smi": smi})
    emit({"phase": "captured_graphs", **graph_count(steps["captured"])})


def interleaved_ticks(torch, engines, requests, kind, ticks=TICK_READS,
                      profiled=5):
    """Scheduler decode ticks (4 active slots, no speculation, the first
    four serve requests) on ``kind``'s layout, one for each engine in
    turns: 3 of warm-up, then ``ticks`` read.  Per engine: the tick's
    median, p10, p90 and min wall ms (each tick ends in the token copy
    to the host), tokens/s, and the device's busy share (the profiler's
    kernel sum over ``profiled`` more ticks, over the median)."""
    import numpy as np
    from repro_torch.serving import PagedBackend, Scheduler, SlotBackend
    scheds = {}
    for name, engine in engines.items():
        if kind == "paged":
            be = PagedBackend(engine, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS,
                              block_size=SERVE_BLOCK)
        else:
            be = SlotBackend(engine, SERVE_SLOTS)
        sched = Scheduler(be, max_new_tokens=4 + 3 + ticks + profiled,
                          chunk_size=SERVE_CHUNK)
        for i, p in enumerate(requests[:SERVE_SLOTS]):
            sched.submit({"tokens": p, "id": i})
        while sched.ingesting or sched.waiting:
            sched.admit()
        check(sched.active == SERVE_SLOTS, "tick timing: slots not all "
                                           "active")
        scheds[name] = sched
    times = {name: [] for name in scheds}
    for i in range(3 + ticks):
        for name, sched in scheds.items():
            t0 = time.perf_counter()
            sched.step()
            if i >= 3:
                times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, sched in scheds.items():
        ms = times[name]
        med = statistics.median(ms)
        per = profiled_ms(torch, sched.step, profiled)
        out[name] = {"ticks": len(ms), "ms_median": med,
                     "ms_p10": float(np.percentile(ms, 10)),
                     "ms_p90": float(np.percentile(ms, 90)),
                     "ms_min": min(ms), "tokens_per_s": SERVE_SLOTS / (
                         med / 1e3),
                     **device_share(per, med, (
                         "rmsnorm_kernel", "fused_decode_mma_kernel"))}
    return out


# ---------------------------------------------------------------------------
# phase 5 — granite_moe_3b_a800m: the MoE FFN at full width and depth
# ---------------------------------------------------------------------------

MOE_ARCH = "granite_moe_3b_a800m"
#: moe_layer_vs_cpu: tokens of the layer's call, the gap between a
#: token's 8th and 9th probability below which its choice may flip
#: between devices, and the outputs' limit relative to their scale
MOE_TOKENS = 256
MOE_GAP = 1e-5
MOE_TOL = 1e-4
#: depths at which moe_main_vs_plain holds the kernel path against the
#: plain path: random expert weights at the reference's scale make each
#: MoE output ~100x its input, and a layer roughly doubles a relative
#: error (f32 on an H100: 6.4e-6 at 1 layer, 3.1e-5 at 2, 1.0e-4 at 4,
#: 1.1e-3 at 8), so 32 layers turn f32 rounding into O(1) logits.  f32
#: is held at F32_MODEL_TOL up to MOE_F32_DEPTH layers and read beyond
MOE_DEPTHS = (1, 2, 4, 8, 16, 32)
MOE_F32_DEPTH = 4


def moe_config():
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.num_experts, cfg.num_experts_per_tok, cfg.d_ff,
           cfg.padded_vocab)
          == (32, 1536, 24, 8, 64, 40, 8, 512, 51200),
          f"{MOE_ARCH} is not at full width")
    return cfg


def free_card(torch):
    """Return the card's memory held by engines that went out of scope."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class RouteRecorder:
    """While installed (``with RouteRecorder(keep) as rec``), records the
    expert choices [N, k] of every ``moe.route`` call over N tokens that
    ``keep(N)`` selects, in call order, as copies on the device; nothing
    waits on the card.  A captured step's replays run no Python, so only
    eager calls are recorded."""

    def __init__(self, keep=lambda n: True):
        self.keep = keep
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        route = self._route = moe.route

        def recorded(params, cfg, xf):
            out = route(params, cfg, xf)
            if self.keep(xf.shape[0]):
                self.calls.append(out[1].clone())
            return out

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def kept(torch, idx, E_pad, C):
    """[N, k] bool: which (token, choice) pairs of one call keep a
    capacity row (the others are dropped)."""
    from repro_torch.models import moe
    order, _, keep = moe.dispatch_plan(idx, E_pad, C)
    return torch.zeros_like(keep).scatter_(0, order, keep).view(idx.shape)


def phase_moe_layer_vs_cpu(torch):
    """One full-width MoE FFN layer of granite in f32 (random weights
    from the seed, MOE_TOKENS tokens) on the card and on the CPU, at the
    configuration's capacity factor and at 0.1.  Expert choices must be
    equal except on near ties (a token's 8th-to-9th probability gap
    below MOE_GAP, counted); on the rows whose choices and kept pairs
    are equal the outputs are within MOE_TOL of the output's scale and
    the rows that every expert dropped are exactly zero on both."""
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(moe_config(), dtype="float32")
    E_pad = moe.padded_experts(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(moe.moe_template(cfg), gen, "float32", "cpu")
    x = torch.randn(1, MOE_TOKENS, cfg.d_model, generator=gen)
    dev = {k: v.cuda() for k, v in params.items()}
    logits = x[0] @ params["router"]
    logits[:, cfg.num_experts:] = -1e30
    top = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
    k = cfg.num_experts_per_tok
    near = (top[:, k - 1] - top[:, k]) < MOE_GAP
    for cf in (cfg.capacity_factor, 0.1):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        C = moe.capacity(c, MOE_TOKENS)
        res = {}
        for name, p, xx in (("cpu", params, x), ("cuda", dev, x.cuda())):
            out, aux = moe.moe_apply(p, c, xx)
            _, idx, _ = moe.route(p, c, xx[0])
            res[name] = (out[0].cpu(), idx.cpu(),
                         kept(torch, idx, E_pad, C).cpu(), float(aux))
        (oc, ic, kc, ac), (og, ig, kg, ag) = res["cpu"], res["cuda"]
        same_idx = (ic == ig).all(-1)
        rows = same_idx & (kc == kg).all(-1)
        scale = float(oc.abs().max())
        err = float((og[rows] - oc[rows]).abs().max()) if rows.any() \
            else 0.0
        zero_c, zero_g = oc.abs().amax(-1) == 0, og.abs().amax(-1) == 0
        r = {"phase": "moe_layer_vs_cpu", "tokens": MOE_TOKENS,
             "capacity_factor": cf, "capacity": C,
             "idx_rows_differ": int((~same_idx).sum()),
             "near_ties": int(near.sum()),
             "differing_rows_all_near_ties": bool(
                 (~same_idx <= near).all()),
             "rows_compared": int(rows.sum()), "max_abs_err": err,
             "output_scale": scale, "tol_rel": MOE_TOL,
             "dropped_pairs_cpu": moe.count_dropped(ic, E_pad, C),
             "dropped_pairs_cuda": moe.count_dropped(ig, E_pad, C),
             "zero_rows_cpu": int(zero_c.sum()),
             "zero_rows_cuda": int(zero_g.sum()),
             "aux_cpu": ac, "aux_cuda": ag}
        emit(r)
        check(r["differing_rows_all_near_ties"],
              f"moe_layer_vs_cpu: an expert choice differs off a near tie "
              f"(capacity factor {cf})")
        check(rows.float().mean() > 0.9,
              "moe_layer_vs_cpu: fewer than 90% of the rows compared")
        check(err <= MOE_TOL * scale, f"moe_layer_vs_cpu: outputs differ "
                                      f"by {err} at scale {scale}")
        check(torch.equal(zero_c[rows], zero_g[rows]),
              "moe_layer_vs_cpu: the dropped rows differ")
        if cf < 1:
            check(bool(zero_c.any()), "moe_layer_vs_cpu: no row dropped "
                                      "at capacity factor 0.1")


def routing_rows(torch, kernel_calls, plain_calls, B, E_pad, cfg):
    """Per batch row: did every layer route each of its tokens to the
    same set of experts, keeping as many of them, on both paths?  The
    calls run over [B * S] tokens each, row-major.  Returns ([B] bool,
    the routing decisions (token, layer) whose sets differ)."""
    from repro_torch.models import moe
    check(len(kernel_calls) == len(plain_calls),
          "routing: the two paths made different MoE calls")
    same = torch.ones(B, dtype=torch.bool)
    differ = 0
    for a, b in zip(kernel_calls, plain_calls):
        C = moe.capacity(cfg, a.shape[0])
        # a token's choices as a set: their rank order moves no output
        chosen = (a.sort(-1).values == b.sort(-1).values).all(-1)
        tok = chosen & (kept(torch, a, E_pad, C).sum(-1)
                        == kept(torch, b, E_pad, C).sum(-1))
        differ += int((~chosen).sum())
        same &= tok.view(B, -1).all(-1).cpu()
    return same, differ


def compare_moe_first_tick(torch, engine, plain, toks, limit, relative,
                           exact=None):
    """Prefill ``toks`` and run one decode tick on the kernel path
    (``engine``), the plain path (``plain``) and, where given, the plain
    path in f64 (``exact``, a reading of each path's distance from it),
    recording each MoE call's expert choices; the decisions whose expert
    sets differ from the kernel path's are counted.  On the rows routed
    alike at every layer on every path, the logits must be within
    ``limit`` (of the plain logits' scale where ``relative``) and the
    greedy tokens equal wherever the plain top-2 gap exceeds it;
    ``limit`` None: readings only."""
    from repro_torch.models import moe
    cfg = engine.cfg
    x = torch.as_tensor(toks, device=engine.device).long()
    B, S = x.shape
    V, L = cfg.vocab_size, cfg.num_layers
    E_pad = moe.padded_experts(cfg)
    nxt = None
    out, calls = {}, {}
    paths = {"kernel": engine, "plain": plain}
    if exact is not None:
        paths["exact"] = exact
    for name, e in paths.items():
        with RouteRecorder() as rec:
            l0, c = e.model.prefill(x, MAX_LEN, flags=e.flags)
            if nxt is None:
                nxt = torch.argmax(l0, -1)[:, None]
            p = torch.full((B,), S, dtype=torch.int32, device=e.device)
            l1, _ = e.model.decode_step(nxt, c, p, flags=e.flags)
        out[name] = (l0[:, :V].double(), l1[:, :V].double())
        calls[name] = rec.calls
    alike = [torch.ones(B, dtype=torch.bool)] * 2
    differ = {}
    for name in paths:
        if name == "kernel":
            continue
        pre, d_pre = routing_rows(torch, calls["kernel"][:L],
                                  calls[name][:L], B, E_pad, cfg)
        tick, d_tick = routing_rows(torch, calls["kernel"][L:],
                                    calls[name][L:], B, E_pad, cfg)
        alike = [alike[0] & pre, alike[1] & pre & tick]
        differ[name] = {"prefill": d_pre, "tick1": d_tick}
    res, ok = {}, True
    for i, step in enumerate(("prefill", "tick1")):
        k, p = out["kernel"][i], out["plain"][i]
        rows = alike[i].to(k.device)
        scale = float(p.abs().max())
        finite = bool(torch.isfinite(k).all() and torch.isfinite(p).all())

        def err(a, b):
            return float((a[rows] - b[rows]).abs().max()) if rows.any() \
                else None

        r = {"rows_routed_alike": int(rows.sum()), "rows": B,
             "logit_scale": scale, "finite": finite,
             "kernel_vs_plain": err(k, p),
             "all_rows_kernel_vs_plain": float((k - p).abs().max())}
        if exact is not None:
            r.update(kernel_vs_f64=err(k, out["exact"][i]),
                     plain_vs_f64=err(p, out["exact"][i]))
        ok = ok and finite
        if limit is not None:
            lim = limit * scale if relative else limit
            agree, compared = top2_agree(torch.argmax(p[rows], -1),
                                         torch.argmax(k[rows], -1), p[rows],
                                         lim)
            r.update(limit=lim, tokens_agree=agree, tokens_compared=compared)
            ok = ok and agree and (r["kernel_vs_plain"] is None
                                   or r["kernel_vs_plain"] <= lim)
        res[step] = r
    return {"ok": ok, "routing_sets_differ_from_kernel": differ,
            "routing_decisions": {"prefill": L * B * S, "tick1": L * B},
            **res}


def phase_moe_main_path(torch):
    """granite at full width and depth in bf16 (random weights from the
    seed) through the engine's main path (``drive_engine_path``),
    launches held to the schedule; then the kernel path against the
    plain path on the first tick (``compare_moe_first_tick``) on the
    first 1, 2, 4, ... 32 layers of the same weights, each on the rows
    routed alike at every layer: in bf16 at main_vs_plain's limit, in f32
    (upcast; an f64 plain run beside them as a reading) at F32_MODEL_TOL
    up to MOE_F32_DEPTH layers.  Random layers amplify one ulp, and a
    near tie flipped by it, into O(1) logits, so the depths show where
    the paths part.  At 1 and 2 layers in f32 at least half the rows
    must route alike.  Returns the launch counts."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = moe_config()
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    run = drive_engine_path(torch, engine, cfg, np.random.RandomState(SEED))
    emit({"phase": "moe_main_path", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "experts": cfg.num_experts, "padded_experts":
          moe.padded_experts(cfg), "top_k": cfg.num_experts_per_tok,
          "dtype": cfg.dtype, "init_seconds": init_s,
          "path_seconds": run.seconds, "launches": run.counts,
          "expected_launches": run.expected, "generate": run.gen.tolist(),
          "verify": run.guess.tolist(),
          "graphs_captured": graph_count(engine)})
    check(run.counts == run.expected, f"moe_main_path: launch counts "
                                      f"{run.counts} != {run.expected}")

    # the kernel path against the plain path at growing depth: the first
    # `depth` layers of the same weights, in bf16 and in f32 (upcast)
    bf = dict(engine.model.named_parameters())
    del engine, run.cache
    free_card(torch)
    toks32 = np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    plain_flags = RuntimeFlags(use_flash=False, fused_rmsnorm=False,
                               use_fused_decode=False)
    for dtype in ("bfloat16", "float32"):
        weights = bf if dtype == "bfloat16" else \
            {k: v.float() for k, v in bf.items()}
        w64 = None if dtype == "bfloat16" else \
            {k: v.double() for k, v in bf.items()}
        for depth in MOE_DEPTHS:
            cfg_d = dataclasses.replace(cfg, num_layers=depth, dtype=dtype)

            def cut(w):
                return {k: v[:depth] if k.startswith("blocks.") else v
                        for k, v in w.items()}

            exact = None if w64 is None else LLMEngine(
                dataclasses.replace(cfg_d, dtype="float64"), cut(w64),
                max_len=MAX_LEN, flags=plain_flags)
            if w64 is None:
                toks, limit, relative = run.groups[0], 0.1, True
            else:
                toks, relative = toks32, False
                limit = F32_MODEL_TOL if depth <= MOE_F32_DEPTH else None
            cmp = compare_moe_first_tick(
                torch, LLMEngine(cfg_d, cut(weights), max_len=MAX_LEN),
                LLMEngine(cfg_d, cut(weights), max_len=MAX_LEN,
                          flags=plain_flags), toks, limit, relative, exact)
            emit({"phase": "moe_main_vs_plain", "dtype": dtype,
                  "depth": depth, **cmp})
            check(cmp["ok"], f"moe_main_vs_plain {dtype} depth {depth}: "
                             f"logits or tokens disagree with the plain path")
            if w64 is not None and depth <= 2:
                check(2 * cmp["tick1"]["rows_routed_alike"] >= len(toks32),
                      f"moe_main_vs_plain f32 depth {depth}: fewer than "
                      f"half the rows routed alike")
        del weights, w64
        free_card(torch)
    return run.counts


def moe_drops(calls, cfg, N):
    """Dropped (token, expert) pairs summed over the layers of the first
    forward pass among ``calls`` whose calls carry N tokens."""
    from repro_torch.models import moe
    hits = [c for c in calls if c.shape[0] == N][:cfg.num_layers]
    check(len(hits) == cfg.num_layers, f"no forward pass of {N} tokens "
                                       f"recorded")
    C = moe.capacity(cfg, N)
    E_pad = moe.padded_experts(cfg)
    per = [moe.count_dropped(c, E_pad, C) for c in hits]
    return {"tokens": N, "capacity": C, "dropped_pairs": sum(per),
            "layers_with_drops": sum(n > 0 for n in per),
            "pairs": N * cfg.num_experts_per_tok * cfg.num_layers}


def phase_moe_serve(torch):
    """The serve workload at granite's vocab through the Scheduler on a
    PagedBackend (the pressure arena, chunk 256, 4 slots, speculate 4),
    on an engine that captures its steps and on one that runs them
    eagerly, on the same weights: tokens bitwise equal (the same schedule,
    so the same tokens share every call) and launches equal to the
    schedule.  The eager run records the routing of the first 256-row
    chunk and of the first verify tick (4 slots x 5), whose dropped
    pairs are counted.  Returns (the captured engine, launch counts)."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = moe_config()
    requests = serve_requests(cfg.vocab_size)
    blocks, _, _ = pressure_blocks(requests)
    cap = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    eager = LLMEngine(cfg, dict(cap.model.named_parameters()),
                      max_len=SERVE_MAX_LEN,
                      flags=RuntimeFlags(cuda_graphs=False))
    verify_n = SERVE_SLOTS * (SERVE_SPEC + 1)
    runs, counts_all = {}, {}
    for name, e in (("eager", eager), ("captured", cap)):
        # the eager run records its routing; a recorder would add its
        # copies to the captured graphs
        with RouteRecorder(lambda n: n in (SERVE_CHUNK, verify_n)) \
                if name == "eager" else contextlib.nullcontext() as rec:
            got, stats, counts, wall = serve(torch, e, requests, blocks)
            want = expected_serve_launches(cfg, stats, "fused_flash_decode")
            emit({"phase": "moe_serve", "steps": name, "num_blocks": blocks,
                  "seconds": wall, "launches": counts,
                  "expected_launches": want,
                  "graphs_captured": graph_count(e),
                  "stats": {k: stats[k] for k in (
                      "prefill_calls", "extend_prefills", "decode_steps",
                      "spec_steps", "spec_drafted", "spec_accepted",
                      "preemptions", "replayed_tokens", "completed",
                      "admit_seconds", "step_seconds")}})
            check(counts == want, f"moe_serve {name}: launch counts "
                                  f"{counts} != {want}")
            check(stats["completed"] == len(requests)
                  and all(got[i].shape == (SERVE_NEW,) for i in got),
                  f"moe_serve {name}: not every request completed")
        runs[name] = got
        if name == "eager":
            calls = rec.calls
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
    equal = sum(bool(np.array_equal(runs["captured"][i], runs["eager"][i]))
                for i in runs["eager"])
    drops = {"first_chunk": moe_drops(calls, cfg, SERVE_CHUNK),
             "first_verify_tick": moe_drops(calls, cfg, verify_n)}
    emit({"phase": "moe_serve_compare", "requests": len(requests),
          "captured_bitwise_equal_to_eager": equal, "drops": drops})
    check(equal == len(requests), "moe_serve: captured tokens differ from "
                                  "eager")
    del eager
    return cap, counts_all


def phase_moe_serve_layouts(torch, engine):
    """The same requests with no speculation (a verify tick of 20 tokens
    can drop, depending on every row of the tick, Hazard 7; a decode
    tick of 4 cannot) on a roomy arena, no prefix sharing, on a
    PagedBackend and on a SlotBackend with the same chunks: tokens
    bitwise equal, launches equal to the schedule.  Returns the paged
    run's tokens and the launch counts."""
    import numpy as np
    cfg = engine.cfg
    requests = serve_requests(cfg.vocab_size)
    runs, counts_all = {}, {}
    for kind in ("paged", "slot"):
        got, stats, counts, wall = serve(
            torch, engine, requests, ROOMY_BLOCKS, paged=kind == "paged",
            prefix_sharing=False, speculate_k=0)
        want = expected_serve_launches(cfg, stats, "fused_flash_decode")
        check(counts == want, f"moe_serve_layouts {kind}: launch counts "
                              f"{counts} != {want}")
        check(stats["completed"] == len(requests) and stats["preemptions"]
              == 0, f"moe_serve_layouts {kind}: a request did not complete "
                    f"or was preempted")
        runs[kind] = got
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
    equal = sum(bool(np.array_equal(runs["paged"][i], runs["slot"][i]))
                for i in runs["paged"])
    emit({"phase": "moe_serve_layouts", "requests": len(requests),
          "speculate_k": 0, "bitwise_equal": equal,
          "launches": counts_all})
    check(equal == len(requests), "moe_serve_layouts: paged and slot "
                                  "tokens are not bitwise equal")
    return runs["paged"], counts_all


def phase_moe_preempt_decode(torch, engine, want):
    """moe_serve_layouts' paged run again with PREEMPTIONS requests
    preempted after streaming tokens, each replayed through the decode
    step (a tick of 4 tokens, which no capacity can drop): tokens bitwise
    the run's without preemption (``want``), replayed K/V bitwise, launches
    equal to the schedule (``check_forced``).  Returns the launches."""
    cfg = engine.cfg
    requests = serve_requests(cfg.vocab_size)
    forced = ForcedPreemption(torch)
    got, stats, counts, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                                  prefix_sharing=False, speculate_k=0,
                                  hook=forced.install)
    check_forced("paged", forced, stats, got, want, counts,
                 expected_serve_launches(cfg, stats, "fused_flash_decode"),
                 phase="moe_preempt_decode")
    check(len(forced.streamed) == PREEMPTIONS,
          f"moe_preempt_decode: {len(forced.streamed)} preemptions, not "
          f"{PREEMPTIONS}")
    return counts


#: the launcher's runs: its own flags, once with the threaded clients and
#: once through the asyncio front door
LAUNCHER_ARGS = ["--arch", MOE_ARCH, "--no-reduced", "--paged",
                 "--requests", "16", "--clients", "4",
                 "--max-new-tokens", "32"]


def phase_moe_graph_serve(torch, smi):
    """granite served by the port's launcher (``repro_torch.launch.serve.
    main``, in this process, on the card), once per front door: each must
    return 0 (every request answered) with launches equal to the server's
    schedule.  Prints the launcher's own summary lines, and TTFT, time per
    output token and tokens/s from the server's metrics and request
    timelines, beside the card's name and power limit.  Returns the
    launch counts."""
    import contextlib
    import io
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import RequestTimeline
    cfg = moe_config()
    read = []

    class ReadAtClose(launcher.GraphServer):
        """The launcher's server, read before it closes."""

        def close(self, *a, **kw):
            if not read or read[-1][0] is not self:
                read.append((self, self.stats()["scheduler"],
                             RequestTimeline.from_tracer(
                                 self.graph.tracer).records()))
            return super().close(*a, **kw)

    counts_all = {}
    server_cls = launcher.GraphServer
    launcher.GraphServer = ReadAtClose
    try:
        for mode in ("threads", "async"):
            for name in build.launches:
                build.launches[name] = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = launcher.main(LAUNCHER_ARGS + ["--frontend", mode])
            wall = time.perf_counter() - t0
            free_card(torch)
            counts = dict(build.launches)
            _, stats, records = read[-1]
            want = expected_serve_launches(cfg, stats, "fused_flash_decode")
            emit({"phase": "moe_graph_serve", "frontend": mode, "rc": rc,
                  "argv": LAUNCHER_ARGS + ["--frontend", mode],
                  "seconds": wall, "launcher_lines":
                  buf.getvalue().splitlines(), "launches": counts,
                  "expected_launches": want, "stats": {
                      k: stats[k] for k in (
                          "prefill_calls", "decode_steps", "completed",
                          "preemptions", "replay_steps")}})
            check(rc == 0, f"moe_graph_serve {mode}: the launcher returned "
                           f"{rc}")
            check(counts == want, f"moe_graph_serve {mode}: launch counts "
                                  f"{counts} != {want}")
            ttft = [r["ttft_ms"] for r in records]
            tpot = [(r["finished_ms"] - r["first_token_ms"])
                    / (r["tokens"] - 1) for r in records if r["tokens"] > 1]
            tokens = sum(r["tokens"] for r in records)
            span_ms = max(r["finished_ms"] for r in records) - \
                min(r["submitted_ms"] for r in records)
            check(len(records) == 16 and all(np.isfinite(ttft))
                  and all(np.isfinite(tpot)),
                  f"moe_graph_serve {mode}: the timelines miss a request")
            emit({"phase": "moe_graph_serve_reading", "frontend": mode,
                  "ttft_ms_p50": float(np.percentile(ttft, 50)),
                  "ttft_ms_p95": float(np.percentile(ttft, 95)),
                  "tpot_ms_p50": float(np.percentile(tpot, 50)),
                  "tokens_per_s": tokens / (span_ms / 1e3),
                  "tokens": tokens, "span_ms": span_ms, "nvidia_smi": smi})
            for k, v in counts.items():
                counts_all[k] = counts_all.get(k, 0) + v
    finally:
        launcher.GraphServer = server_cls
    return counts_all


def phase_moe_tick(torch, engine, smi):
    """The captured paged decode tick at 4 slots (the first four serve
    requests, 3 ticks of warm-up, TICK_READS read): median, p10-p90 and
    the profiler's device share (``interleaved_ticks``); the captured
    decode graph's device time by CUDA events over queued replays; one
    eager MoE layer at the tick's 4 tokens timed the same way; the MoE
    FFN's share of the device time from the profiler's kernel sums (one
    layer's, times the layers, over the graph's; the events of an eager
    layer also hold the gaps between its ~25 small kernels, which the
    graph closes up).  The bound reads every weight once
    (all padded experts: the gather dispatch multiplies them all) and
    the rows' K/V once."""
    from repro_torch.models import moe
    from repro_torch.models.params import DTYPES
    cfg = engine.cfg
    requests = serve_requests(cfg.vocab_size)
    r = interleaved_ticks(torch, {"captured": engine}, requests,
                          "paged")["captured"]
    graph = [cs for key, cs in engine.graphs.steps.items()
             if key[:2] == ("decode", "paged") and key[3] == SERVE_SLOTS]
    check(len(graph) >= 1, "moe_tick: no captured paged decode graph")
    graph_ms = cuda_ms(torch, graph[-1].graph.replay)[0]
    x = torch.randn(SERVE_SLOTS, 1, cfg.d_model, device=engine.device).to(
        DTYPES[cfg.dtype])
    layer = engine.model.groups[0]["l0"]["ffn"]
    moe_ms = cuda_ms(torch, lambda: moe.moe_apply(layer, cfg, x))[0]

    def kernels(fn, calls=10):
        """The profiler's kernel time of ``fn`` (None where it recorded
        none) and its ten costliest kernels, ms per call."""
        per = profiled_ms(torch, fn, calls)
        return (sum(per.values()) if per else None,
                [(name[:80], t) for name, t in
                 sorted(per.items(), key=lambda kv: -kv[1])[:10]])

    tick_prof, tick_top = kernels(graph[-1].graph.replay)
    moe_prof, moe_top = kernels(lambda: moe.moe_apply(layer, cfg, x))
    weights = sum(p.numel() * p.element_size()
                  for p in engine.model.parameters())
    # the rows' keys at the middle of the ticks read
    keys = sum(p.size + 3 + TICK_READS // 2
               for p in requests[:SERVE_SLOTS])
    kv = 2 * keys * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    bound_ms = (weights + kv) / HBM_BPS * 1e3
    emit({"phase": "moe_tick", **r, "graph_device_ms": graph_ms,
          "graph_busy_share": graph_ms / r["ms_median"],
          "moe_layer_ms": moe_ms,
          "moe_ms_per_tick": moe_ms * cfg.num_layers,
          "graph_profiler_ms": tick_prof,
          "moe_layer_profiler_ms": moe_prof,
          "moe_share_of_device_time": (moe_prof * cfg.num_layers / tick_prof
                                       if tick_prof and moe_prof else None),
          "bound_ms": bound_ms, "bound_bytes": weights + kv,
          "bound_by": "bytes", "median_over_bound": r["ms_median"] / bound_ms,
          "top_kernels_ms_per_tick": tick_top,
          "top_kernels_ms_per_moe_layer": moe_top,
          "nvidia_smi": smi})


# ---------------------------------------------------------------------------
# phase 4 — times at the main path's shapes
# ---------------------------------------------------------------------------

def device_ms_by_kernel(prof, calls):
    """{kernel name: device ms per call} from a profiler run over
    ``calls`` calls, counting device-side events only."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per[e.key] = per.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3 / calls
    return per


def profiled_ms(torch, fn, calls):
    """{kernel name: device ms per call} of ``calls`` calls of ``fn``
    from torch.profiler's device-side events; empty where the profiler
    recorded none, which it does on some machines, so that nothing rests
    on it but the per-kernel breakdowns that read it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_ms_by_kernel(prof, calls)


def device_share(per, tick_ms, ours):
    """A tick's device time, busy share and the port's kernels' part of
    it from the profiler's breakdown ``per``; None where it is empty."""
    device_ms = sum(per.values()) if per else None
    return {"device_ms_per_tick": device_ms,
            "device_busy_share": device_ms / tick_ms if per else None,
            "port_kernels_ms_per_tick": {
                k: sum(v for name, v in per.items() if k in name)
                for k in ours} if per else None,
            "profiler": "device events" if per else
                        "not measured: no device event recorded"}


#: the sleep kernel's cycles per ms at the card's highest clock (H100
#: SXM, 1.98 GHz), so that a sleep lasts at least the ms asked for
SLEEP_CYCLES_PER_MS = 1_980_000


def queued_ms(torch, fn, reps, host_ms):
    """Device ms per call of ``fn``: CUDA events around calls queued
    behind a sleep kernel, so that the card runs them back to back and
    the host's time to launch them is not in the reading.  The sleep
    lasts 4x the calls' host time; the start event, still pending once
    the last call is queued, shows that the calls queued.  The card's
    launch queue is finite, and a plain version of many small kernels
    fills it in fewer than ``reps`` calls, so the calls go in batches,
    halved until each batch queues.  Returns (ms, whether the calls
    queued); where one call alone does not queue, the reading has the
    host's gaps in it."""
    n = reps
    while True:
        total, queued = 0.0, True
        for i in range(0, reps, n):
            k = min(n, reps - i)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(int((4 * k * host_ms + 1.0)
                                  * SLEEP_CYCLES_PER_MS))
            start.record()
            for _ in range(k):
                fn()
            end.record()
            queued = queued and not start.query()
            end.synchronize()
            total += start.elapsed_time(end)
            if not queued and n > 1:
                break
        if queued or n == 1:
            return total / reps, queued
        n = (n + 1) // 2


def cuda_ms(torch, fn, reps=REPS):
    """(device ms, host ms, profiler ms per call, queued): the card's
    time per call over ``reps`` calls queued back to back (CUDA events,
    ``queued_ms``, and whether they queued), the median wall time of one
    synchronised call as the host sees it, and the sum of the calls'
    kernel times as torch.profiler records them (None where it records
    none)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(walls)
    device_ms, queued = queued_ms(torch, fn, reps, host_ms)
    check(device_ms > 0, "CUDA events recorded no device time")
    per = profiled_ms(torch, fn, reps)
    return device_ms, host_ms, sum(per.values()) if per else None, queued


def measure(torch, kernel, plain, library):
    """Device and host times of the kernel, its plain version and the
    library call (``None``: there is none)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        dev, wall, prof, queued = (cuda_ms(torch, fn) if fn is not None
                                   else (None,) * 4)
        out[key + "ms"], out[key + "host_ms"] = dev, wall
        out[key + "profiler_ms"], out[key + "queued"] = prof, queued
    return out


def bound(bytes_, flops, peak_flops):
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_decode import fused_flash_decode_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import paging
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    from repro_torch.configs import get_config
    cfg = get_config("minicpm_2b")
    bf = torch.bfloat16
    d, H, hd, L = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers
    rows = {}

    # K1 at the decode tick's shape: 4 rows of d_model
    x = torch.randn(4, d, device=dev, generator=g).to(bf)
    s = torch.ones(d, device=dev, dtype=bf)
    nbytes = 2 * x.numel() * 2 + d * 2
    b_ms, b_by = bound(nbytes, 4 * x.numel(), F32_FLOPS)
    rows["rmsnorm"] = {
        "shape": [4, d],
        **measure(torch, lambda: rmsnorm_cuda(x, s),
                  lambda: ref.rmsnorm_ref(x, s),
                  (lambda: F.rms_norm(x, (d,), s, 1e-5))
                  if hasattr(F, "rms_norm") else None),
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": 2 * L + 1}
    # K1 where bytes count: the serve workload's prefill chunk, and
    # qwen3_32b's prefill of 1024 rows at d_model 5120
    for shape in RMSNORM_TIMED:
        emit({"phase": "times", "kernel": "rmsnorm",
              **time_rmsnorm(torch, g, shape)})

    # K3 at the serving prefill's shape: 2 rows of 18 tokens, causal
    B, S = 2, GROUPS[1]
    q, k, v = (torch.randn(B, S, H, hd, device=dev, generator=g).to(bf)
               for _ in range(3))
    pairs = B * H * S * (S + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * 2, 4 * hd * pairs, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows["flash_attention"] = {
        "shape": [B, S, H, hd],
        **measure(torch, lambda: flash_attention_cuda(q, k, v),
                  lambda: ref.flash_attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": 0,
        "launches_per_prefill": L}

    # K3 at the serve workload's chunk (256 rows at q_offset 512 over
    # 768 keys) and at qwen3_32b's full prefill of 1024 rows
    for r in time_flash_shapes(torch, g):
        emit({"phase": "times", "kernel": "flash_attention", **r})

    # K2 at the decode tick's shape: 4 slots, max_len 512, S' = 1, rows
    # at the serving run's lengths (32..50 tokens)
    B, page = 4, 8
    pos = torch.tensor([30, 32, 46, 50], dtype=torch.int32, device=dev)
    tables = paging.slot_arena_tables(B, MAX_LEN, page, dev)
    arena = [torch.randn(B * MAX_LEN // page, page, H, hd, device=dev,
                         generator=g).to(bf) for _ in range(2)]
    qd = torch.randn(B, 1, H, hd, device=dev, generator=g).to(bf)
    kn, vn = (torch.randn(B, 1, H, hd, device=dev, generator=g).to(bf)
              for _ in range(2))
    freqs = ref.rope_freqs(hd, 10_000.0, dev)
    keys = int((pos + 1).sum())
    nbytes = (2 * keys * H * hd * 2 + 4 * qd.numel() * 2
              + 2 * qd.numel() * 2 + tables.numel() * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * hd * H * keys, BF16_FLOPS)
    rows["fused_flash_decode"] = {
        "shape": [B, 1, H, hd], "max_len": MAX_LEN,
        **measure(torch, lambda: fused_flash_decode_cuda(
            qd, kn, vn, arena[0], arena[1], tables, pos, freqs),
            lambda: ref.fused_flash_decode_ref(
                qd, kn, vn, arena[0], arena[1], tables, pos, freqs), None),
        "library_note": "no single PyTorch call rotates, scatters into a "
                        "paged arena and attends",
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": L}

    # K2, K4 and K5 on a paged arena: the serve phase's decode tick (4
    # rows, bs 16, rows at the served lengths), then qwen3_32b's
    # attention shape with 4 rows of 4096 keys; S' = 1 and the verify
    # window of 5 (K5 has no window)
    for shape, keys in ((("minicpm_2b", H, H, hd), (300, 520, 700, 930)),
                        (("qwen3_32b", 64, 8, 128), (4096,) * 4),
                        (GRANITE, (300, 520, 700, 930))):
        for Sq in (1, SERVE_SPEC + 1):
            timed = time_paged_kernels(torch, g, shape, keys, Sq)
            for name, r in timed.items():
                if (shape[0] == "minicpm_2b" and Sq == 1
                        and name != "fused_flash_decode"):
                    rows[name] = r
                else:
                    emit({"phase": "times", "kernel": name, **r})
    for name, r in rows.items():
        emit({"phase": "times", "kernel": name, **r})
    return rows


#: (name, B, S, H, KV, hd, q_offset) of K3's further timed shapes: the
#: serve workload's third chunk of a prompt (minicpm_2b, and
#: granite_moe_3b_a800m's G = 3), and qwen3_32b's full causal prefill
FLASH_TIMED = (("serve chunk minicpm_2b", 1, SERVE_CHUNK, 36, 36, 64,
                2 * SERVE_CHUNK),
               ("prefill qwen3_32b", 1, 1024, 64, 8, 128, 0),
               ("serve chunk granite_moe_3b_a800m", 1, SERVE_CHUNK, 24, 8,
                64, 2 * SERVE_CHUNK))


def time_flash_shapes(torch, g):
    """K3 at FLASH_TIMED beside its plain version and SDPA: with an
    explicit boolean mask where q_offset > 0, ``is_causal`` otherwise.
    The bound counts q, k, v read and the output written once, and 4 hd
    operations per (query row, visible key, head)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rows = []
    for name, B, S, H, KV, hd, off in FLASH_TIMED:
        T = off + S
        q = torch.randn(B, S, H, hd, device=dev, generator=g).to(bf)
        k, v = (torch.randn(B, T, KV, hd, device=dev, generator=g).to(bf)
                for _ in range(2))
        pairs = B * H * (S * (off + 1) + S * (S - 1) // 2)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(nbytes, 4 * hd * pairs, BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if off:
            idx = torch.arange(T, device=dev)
            mask = idx[None, :] <= off + torch.arange(S, device=dev)[:, None]

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=KV != H)
        rows.append({
            "case": name, "shape": [B, S, H, hd], "kv_heads": KV,
            "keys": T, "q_offset": off,
            **measure(torch, lambda: flash_attention_cuda(q, k, v,
                                                          q_offset=off),
                      lambda: ref.flash_attention_ref(q, k, v, q_offset=off),
                      library),
            "library_note": "SDPA, explicit boolean mask" if off
                            else "SDPA, is_causal",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


#: [rows, d] of K1's further timed shapes: the serve workload's prefill
#: chunk at minicpm_2b's d_model, qwen3_32b's prefill of 1024 rows, and
#: granite_moe_3b_a800m's decode tick
RMSNORM_TIMED = ((SERVE_CHUNK, 2304), (1024, 5120), (4, 1536))


def time_rmsnorm(torch, g, shape):
    """K1 at ``shape`` = (rows, d) beside its plain version and
    ``F.rms_norm``; the bound reads x and writes the output once."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    rows, d = shape
    x = torch.randn(rows, d, device="cuda", generator=g).to(torch.bfloat16)
    s = torch.ones(d, device="cuda", dtype=torch.bfloat16)
    b_ms, b_by = bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(), F32_FLOPS)
    return {"shape": [rows, d],
            **measure(torch, lambda: rmsnorm_cuda(x, s),
                      lambda: ref.rmsnorm_ref(x, s),
                      (lambda: F.rms_norm(x, (d,), s, 1e-5))
                      if hasattr(F, "rms_norm") else None),
            "bound_ms": b_ms, "bound_by": b_by}


def paged_decode_inputs(torch, g, shape, keys, Sq):
    """K2/K4's bf16 operands on a paged arena of ``shape`` = (name, H,
    KV, hd), block size 16, one row per entry of ``keys`` (keys seen by
    the row's first window query, that query's own included), a window
    of ``Sq`` queries; and the bound of the call.  The bound reads each
    key and value of the row once (the window's are written once
    instead) and q, the new K/V and the output once, and counts 4 hd
    operations per (query, visible key, head): the same bytes at S' = 5,
    about 5x the operations.  Returns (args, (bound ms, bound by),
    (kv bytes, operations))."""
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    name, H, KV, hd = shape
    bs, B = 16, len(keys)
    T_len = -(-(max(keys) + Sq - 1) // bs) * bs
    tbl, pos, NB = paged_layout(torch, dev, g, keys, Sq, bs, T_len // bs)
    tbl, pos = tbl[:B].contiguous(), pos[:B].contiguous()

    def rand(*shp):
        return torch.randn(*shp, device=dev, generator=g).to(torch.bfloat16)

    kp, vp = rand(NB, bs, KV, hd), rand(NB, bs, KV, hd)
    q, kn, vn = rand(B, Sq, H, hd), rand(B, Sq, KV, hd), rand(B, Sq, KV, hd)
    freqs = ref.rope_freqs(hd, 10_000.0, dev)
    io = 2 * (q.numel() * 2 + kn.numel() * 2) + tbl.numel() * 4 + B * 4
    kv_bytes = 2 * sum(n + Sq - 1 for n in keys) * KV * hd * 2
    flops = 4 * hd * H * sum(n + s for n in keys for s in range(Sq))
    return ((q, kn, vn, kp, vp, tbl, pos, freqs),
            bound(kv_bytes + io, flops, BF16_FLOPS), (kv_bytes, flops))


def time_paged_kernels(torch, g, shape, keys, Sq):
    """K2 and K4 (the same function on the same inputs) and, at S' = 1,
    K5 at ``paged_decode_inputs``' shapes.  K5's library call is SDPA
    over K/V gathered beforehand; the gather's time stands beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    name, H, KV, hd = shape
    args, b4, (kv_bytes, flops) = paged_decode_inputs(torch, g, shape, keys,
                                                      Sq)
    common = {"shape": list(args[0].shape), "arch": name, "kv_heads": KV,
              "keys": list(keys), "block_size": args[3].shape[1],
              "library_note": "no single PyTorch call rotates, scatters "
                              "into a paged arena and attends",
              "bound_ms": b4[0], "bound_by": b4[1]}
    k4 = measure(torch, lambda: fused_flash_decode_splitk_cuda(*args),
                 lambda: ref.fused_flash_decode_ref(*args), None)
    k2 = measure(torch, lambda: fused_flash_decode_cuda(*args), None, None)
    # one plain version serves both kernels: they compute one function
    for key in ("plain_ms", "plain_host_ms", "plain_profiler_ms",
                "plain_queued"):
        k2[key] = k4[key]
    out = {"fused_flash_decode_splitk": {**common, **k4},
           "fused_flash_decode": {**common, **k2}}
    if Sq > 1:
        return out

    _, _, _, kp, vp, tbl, pos, _ = args
    B, T_len = tbl.shape[0], tbl.shape[1] * kp.shape[1]
    dev = kp.device
    q5 = torch.randn(B, H, hd, device=dev, generator=g).to(kp.dtype)
    b5 = bound(kv_bytes + 2 * q5.numel() * 2 + tbl.numel() * 4 + B * 4,
               flops, BF16_FLOPS)
    idx = torch.arange(T_len, device=dev)
    mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]

    def gather():
        return (kp[tbl.long()].reshape(B, T_len, KV, hd).transpose(1, 2),
                vp[tbl.long()].reshape(B, T_len, KV, hd).transpose(1, 2))

    kg, vg = gather()
    qs = q5[:, :, None, :]
    gather_ms = cuda_ms(torch, gather)[0]
    out["paged_attention"] = {
        "shape": [B, H, hd], "arch": name, "keys": list(keys),
        "block_size": kp.shape[1],
        **measure(torch, lambda: paged_attention_cuda(q5, kp, vp, tbl, pos),
                  lambda: ref.paged_attention_ref(q5, kp, vp, tbl, pos),
                  lambda: F.scaled_dot_product_attention(
                      qs, kg, vg, attn_mask=mask, enable_gqa=KV != H)),
        "library_note": "SDPA over K/V gathered beforehand; the gather's "
                        "time is gather_ms",
        "gather_ms": gather_ms,
        "bound_ms": b5[0], "bound_by": b5[1]}
    return out


SOURCES = {
    "rmsnorm":("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:88"),
    "fused_flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:225"),
    "fused_flash_decode_splitk": (
        "src/repro_torch/kernels/csrc/flash_decode_splitk.cu",
        "src/repro/kernels/flash_decode.py:166"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
}


def main() -> int:
    torch = setup()
    smi = phase_build(torch)
    errs = phase_kernels(torch)
    phase_gemm_width(torch)
    counts, e2e = phase_main_path(torch)
    serve_counts, serve_tokens = phase_serve(torch)
    graph_counts, graph_tokens = phase_graph_serve(
        torch, serve_tokens["default"], smi)
    preempt_counts, preempt_tokens = phase_serve_preempt_decode(torch)
    phase_captured(torch, {**serve_tokens, "graph_serve": graph_tokens,
                           "serve_preempt_decode": preempt_tokens["default"]},
                   smi)
    # granite_moe_3b_a800m, with the minicpm_2b engines freed
    free_card(torch)
    phase_moe_layer_vs_cpu(torch)
    moe_counts = [phase_moe_main_path(torch)]
    free_card(torch)
    engine, c = phase_moe_serve(torch)
    moe_counts.append(c)
    paged_tokens, c = phase_moe_serve_layouts(torch, engine)
    moe_counts += [c, phase_moe_preempt_decode(torch, engine, paged_tokens),
                   phase_moe_graph_serve(torch, smi)]
    phase_moe_tick(torch, engine, smi)
    del engine
    free_card(torch)
    times = phase_times(torch)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        t = times[name]
        launches = (counts[name] + serve_counts[name] + graph_counts[name]
                    + preempt_counts[name]
                    + sum(c.get(name, 0) for c in moe_counts))
        check(launches > 0, f"{name}: no launch on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
