#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K5) from
``src/repro_torch/kernels/csrc`` with nvcc, holds each against its plain
PyTorch version on the card in bf16 and f32 (K1 at every served width,
512 to 8192, at 1, 4, 5, 256 and 1024 rows, each row's bits the same
at every row count and alone; K3 also at qwen3_32b's and
stablelm_12b's head shapes, its suffixes bitwise equal to the full
prefill's rows, and its window branch at deepseek_7b's 32 heads of 128
(window 8192 over 8704 rows) and qwen3_32b's (window 1000, not a
multiple of the 128-key block), each row alone bitwise equal to its row
of the batch; K2, K4 and K5 at minicpm_2b's, qwen3_32b's and
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
(``moe_tick``), then the recurrent and hybrid stacks: the width rule at
the xLSTM and Mamba products and one full-width mLSTM, sLSTM and Mamba
layer's rows against their batch, chunks and stacks (``recurrent_rows``),
``xlstm_1_3b`` at full width and depth (48 layers, 42 mLSTM + 6 sLSTM,
d_model 2048) through the engine on the state layout
(``xlstm_main_path``), through the Scheduler on a ``StateBackend``
captured against eager, with forced preemptions replayed through the
masked decode and through verify windows with the rewind, in f32
against per-request greedy, and its decode and verify ticks against
their bounds (``xlstm_serve``), through the launcher
(``xlstm_graph_serve``), and ``jamba_1_5_large_398b``'s first two
layers at full width on a ``HybridBackend`` (``hybrid_serve``: K1-K4,
captured against eager, hybrid against state, pressure and forced
preemptions, the tick against its bound), then ``deepseek_v3_671b``'s
first two layers at full width (d_model 7168, 128 heads of MLA with q/kv
latents of 1536/512, a dense layer of 18432 and a MoE layer of 256
experts top-8 + 1 shared, bf16): one MLA layer on the card in bf16 and
f32 against the CPU, prefill, extend, slot and paged decode at S' = 1
and 5, paged bitwise slot (``mla_layer_vs_cpu``), the engine's main path
with K1 at four launches a layer and the final norm, against the plain
path (``mla_main_path``), the serve workload through the Scheduler
captured against eager with its drops counted, slot against paged,
forced preemptions replayed, the captured tick against its bounds and an
f32 engine against per-request greedy (``mla_serve``, ``mla_tick``),
the same requests on the hybrid and state layouts (MLA's latents
paged, and in slot rows) bitwise the paged layout's tokens, and with
speculation at 2 slots, hybrid bitwise paged (``mla_layouts``), then the
sliding windows: ``deepseek_7b`` at full width and depth (30 layers,
d_model 4096, 32 heads of 128) with the window of 8192 that JAX's dry
run serves ``long_500k`` with, three requests of 8176-9000 tokens
through the Scheduler on 2 slots with one forced preemption (K1 and
K3's window branch launches held to the schedule, no decode kernel:
windowed decode is the plain gather path, as in JAX; tokens bitwise
each request's ``generate`` alone, the victim's K/V bitwise what it
held, against a teacher-forced plain forward under the top-2 rule; the
captured tick bitwise the eager one beside its bytes bound; the
9000-token prefill's ms: ``window_main_path``) and deepseek_v3's dense
head layer at that window over an 8300-token prompt (``mla_window``),
then the modality stubs at full width and depth:
``phi_3_vision_4_2b`` (32 layers, d_model 3072, 32 heads of 96) through
``make_prefill_step`` over 576 patch embeddings and 16 tokens, lockstep
decode steps and ``generate`` on the tokens alone, with launches held to
the schedule and an f32 engine's kernel path against its plain path and
an f64 run (``vlm_main_path``), the serve workload's requests through
the Scheduler captured with K2 against eager, with K4, and slot against
paged, and the captured paged tick against its bound (``vlm_serve``),
and ``seamless_m4t_large_v2`` (24 encoder and 24 decoder layers,
d_model 1024) through ``make_prefill_step`` over 256 frame embeddings
and a 16-token prompt and decode steps that read the cross caches, with
the encode, prefill and decode-step times beside the step's bound and
the f32 comparison (``encdec_main_path``); then training on the plain
path (the kernels have no backward and refuse autograd):
``minicpm_2b`` at full width and depth (``train_main_path``: the
no-grad ``forward`` with K1 and K3 against the plain one in f32, 81
K1 and 40 K3 launches; AdamW with WSD over 8 x 256 batches, no kernel
launch in a step, every gradient leaf finite and non-zero, the kernel
flags refused, the step's ms, tokens/s, peak memory and flops bound;
the loss falling on one batch; the TrainState's checkpoint round trip
bitwise; one f32 step at depth 2 on the card against the CPU, each
gradient leaf held; the train
launcher in a subprocess), ``xlstm_1_3b`` at full width
(``train_recurrent``: the chunkwise forward against the token-by-token
prefill over one layer group, one timed step at full depth, the checks
on its first two layers, where the reference's random-init gradient
stays finite, and an mLSTM + sLSTM pair's f32 step on the card against
the CPU, leaf by leaf) and ``jamba_1_5_large_398b``'s first two layers at full width
(``train_hybrid``: Adafactor, its state factored as ``_factored``
admits, the aux loss and the MoE drops); and, after
``serve_preempt_decode``, ROADMAP F2's two replay paths on
minicpm_2b, each replay held bitwise to the run without preemption
(``f2_group_prefill``: a slot layout's group-prefilled prompts replayed
alone; ``f2_prefix_readmit``: a readmission whose prefix sharer is
gone); after ``captured``, tensor-parallel serving on the
one card, two or four ranks on ``cuda:0`` through gloo, eager
(``tp_serve``: minicpm_2b at tp 2, full width and depth, through the
Scheduler with K2 and with K4 on each rank's 18 heads, every rank's
launches held to the schedule, tokens bitwise each request served
alone by the same engine (``own_greedy``), slot = paged, a forced preemption replayed, the eager
tick against the unsharded one with its share in ``all_reduce``;
``tp_f32``: 8 layers in f32, tp 2 against tp 1; ``tp_moe``:
granite_moe_3b_a800m at tp 2, full width and depth, each rank's 12/4
heads and 24 experts, 2 slots, speculation, a forced preemption,
tokens bitwise each request alone, every MoE call's kept pairs the
unsharded plan's and the served chunks routed as alone; ``tp_hybrid``:
jamba's first two layers at tp 2 on a HybridBackend, the verify window
and the rewind over the mirror, hybrid = state; ``tp_state``:
xlstm_1_3b's first 8 layers at tp 2 on a StateBackend; each with its
eager tick against the unsharded one, its all-reduces a tick held to
the layers'; ``tp_mixers_f32``: granite's and xlstm's first 8 layers
in f32, tp 2 against tp 1, granite while the two route alike;
``tp_gqa``: qwen3_32b's first two layers at tp 2 and tp 4, K2, K4 and
K3 on GQA slices, and in f32 against tp 1; the engines of one mesh
share its worker processes, ``TP_POOL``); checks the launch counters
against the schedule and the outputs (slot and paged layouts bitwise
equal; an f32 run against per-request greedy), and times each kernel
with CUDA events over calls queued back to back (K1 also at prefill
rows and at the decode rows of every served width, beside the launch
floor of a 1-element ``fill_``, K3 also at the serve
workload's prefill chunk and qwen3_32b's full prefill, K2, K4 and K5
also on the paged arena at the serve tick's, qwen3_32b's,
granite_moe_3b_a800m's and jamba's shapes, K2 and K4 there at windows
of 1 and 5), and the recurrent updates against their bounds.
Kernels are also held at granite_moe_3b_a800m's head shape (24 heads
over 8 KV heads), at one rank's heads at tp 2 (granite's 12 over 4,
jamba's 32 over 4: K2, K4, K5, K3 and granite's 256-row chunk) and at
the stub models' (K1 at widths 1024 and 3072,
K3 over two rows of phi_3_vision_4_2b's 592-row prefill and of a
16-token prompt, K2, K4 and K5 at 32 heads of 96 and 16 of 64), and
``gemm_width`` reads granite's router and expert products.  Last, phase
``cost_model`` (ROADMAP item 11d) counts four steps the run timed
(minicpm_2b's captured paged tick, granite's, deepseek_7b's captured
window tick, minicpm_2b's 8 x 256 train step) and the ``times`` phase's
kernel rows on ``meta`` tensors with the op counter
(``launch/op_cost.py``), on the host, and holds the counted roofline
below each step's measured ms, each tick's counted bytes above its
phase's bound and each kernel's counted bytes and operations within 1%
of its row's bound.  Every phase and check
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
import math
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
REPS = 10                     # timed calls per kernel and method

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores; ``setup`` reads them from
# ``repro_torch.launch.mesh``, the roofline's one definition
HBM_BPS = BF16_FLOPS = F32_FLOPS = None

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
#: the flags of the plain path, which each kernel path is held against
PLAIN_FLAGS = {"use_flash": False, "fused_rmsnorm": False,
               "use_fused_decode": False}


#: the run's start, for each phase line's elapsed seconds
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def add_counts(total, counts):
    """Add the launch counts ``counts`` into ``total``; returns it."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


#: the steps whose device time a phase measured, for ``cost_model`` to
#: count on ``meta`` at their exact shapes and flags: dicts of the
#: step's name, its phase, ``measured_ms`` and how it was read, the
#: phase's own bound, and ``count`` (runs the step on meta under an op
#: counter: (counter, argument bytes))
COST_STEPS = []
#: the ``times`` phase's kernel calls at its rows' shapes: name -> (the
#: call on meta operands, with host positions, the row's bound bytes and
#: operations)
COST_KERNELS = {}


def setup():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    global HBM_BPS, BF16_FLOPS, F32_FLOPS
    from repro_torch.launch import mesh
    HBM_BPS, BF16_FLOPS, F32_FLOPS = (mesh.HBM_BW, mesh.PEAK_FLOPS_BF16,
                                      mesh.PEAK_FLOPS_F32)
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
        check_rmsnorm(torch, dev, g, dtype, record)
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
        for shape, rows, offsets in STUB_PREFILLS:
            check_flash_shape(torch, dev, g, dtype, shape, record,
                              rows=rows, offsets=offsets, batch=2)
        # K3's window branch (item 12)
        for shape, rows, window in WINDOW_PREFILLS:
            check_flash_shape(torch, dev, g, dtype, shape, record,
                              rows=rows, offsets=(), batch=2, window=window)
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
        # each rank's heads under tensor-parallel serving (item 11a): K2,
        # K4 and K5 with every row alone bitwise its row of the batch,
        # K3 with its suffix and each row alone bitwise
        for shape in TP_HEADS:
            check_paged_kernels(torch, dev, g, dtype, shape, record)
            check_flash_shape(torch, dev, g, dtype, shape, record,
                              rows=SERVE_CHUNK + 64, offsets=(SERVE_CHUNK,),
                              batch=2)
        # K3 over granite's rank chunk at tp 2: 256 rows of 12 heads over 4
        check_flash_shape(torch, dev, g, dtype, TP_HEADS[3], record,
                          rows=SERVE_CHUNK, offsets=(), batch=1)
        # granite_moe_3b_a800m's G = 3: K3's suffixes of a 512-row
        # prefill, K2 and K4's windows against single queries
        check_flash_shape(torch, dev, g, dtype, GRANITE, record,
                          rows=512, offsets=(50, 256))
        for shape in (GRANITE,) + STUB_HEADS:
            check_window_independence(torch, dev, g, shape, dtype)
    for shape in DECODE_SHAPES[:2] + TP_HEADS:
        check_window_independence(torch, dev, g, shape)
    torch.cuda.synchronize()
    return errs


#: K1's rows at the recurrent and hybrid stacks' widths: a decode tick's
#: 4 rows and a prefill chunk's 256
RMSNORM_ROWS = ((4, 2048), (256, 2048), (4, 8192), (256, 8192))

#: the widths K1 serves (deepseek_v3_671b's kv latent,
#: seamless_m4t_large_v2, granite_moe_3b_a800m and deepseek_v3_671b's q
#: latent, xlstm_1_3b, minicpm_2b, phi_3_vision_4_2b, deepseek_7b,
#: qwen3_32b and stablelm_12b, deepseek_v3_671b, jamba_1_5_large_398b)
#: and the row counts it is held at: one row, a decode tick's 4, a verify
#: window's 5, a prefill chunk's 256 and qwen3_32b's 1024-row prefill
RMSNORM_WIDTHS = (512, 1024, 1536, 2048, 2304, 3072, 4096, 5120, 7168,
                  8192)
RMSNORM_ROW_COUNTS = (1, 4, 5, 256, 1024)


def check_rmsnorm(torch, dev, g, dtype, record):
    """K1 at every served width and row count against its plain
    version.  The batch of each row count is the first rows of one x of
    the most rows, so every row's output must be bitwise the same at
    every count; and the first, a middle and the last row of that x
    alone must equal their rows of its batch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    dt = getattr(torch, dtype)
    most = max(RMSNORM_ROW_COUNTS)
    for d in RMSNORM_WIDTHS:
        x = torch.randn(most, d, device=dev, generator=g).to(dt)
        s = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        full = rmsnorm_cuda(x, s)
        for rows in RMSNORM_ROW_COUNTS:
            xr = x[:rows].contiguous()
            out = rmsnorm_cuda(xr, s)
            record("rmsnorm", dtype, f"[{rows},{d}]", out,
                   ref.rmsnorm_ref(xr, s), TOL[dtype])
            check(torch.equal(out, full[:rows]),
                  f"rmsnorm {dtype} d {d}: {rows} rows alone are not "
                  f"bitwise equal to those rows of a {most}-row batch")
        for i in (0, most // 2, most - 1):
            alone = rmsnorm_cuda(x[i:i + 1].contiguous(), s)
            check(torch.equal(alone, full[i:i + 1]),
                  f"rmsnorm {dtype} d {d}: row {i} alone is not bitwise "
                  f"equal to row {i} of a {most}-row batch")
        emit({"phase": "kernel_vs_plain", "kernel": "rmsnorm",
              "dtype": dtype, "case": f"d {d}: rows bitwise at "
              f"{list(RMSNORM_ROW_COUNTS)} and rows 0, {most // 2}, "
              f"{most - 1} alone", "ok": True})

#: (name, H, KV, hd) of the prefill shapes K3 is held at beside
#: minicpm_2b's: qwen3_32b's (GQA, head_dim 128) and stablelm_12b's
#: (head_dim 160, the widest the kernel takes)
PREFILL_SHAPES = (("qwen3_32b", 64, 8, 128), ("stablelm_12b", 32, 8, 160))
PREFILL_ROWS = 768
#: suffix offsets: the serve workload's chunk boundaries and one inside
#: a 128-key block
PREFILL_OFFSETS = (50, 256, 512)
#: (shape, rows, suffix offsets) of the stub models' prefills, two rows
#: each: phi_3_vision_4_2b's 576 patch embeddings and 16 tokens (head_dim
#: 96; its text starts at 576) and seamless_m4t_large_v2's 16-token
#: decoder prompt
STUB_PREFILLS = ((("phi_3_vision_4_2b", 32, 32, 96), 592, (50, 576)),
                 (("seamless_m4t_large_v2", 16, 16, 64), 16, (1, 8)))


def check_flash_shape(torch, dev, g, dtype, shape, record,
                      rows=PREFILL_ROWS, offsets=PREFILL_OFFSETS, batch=1,
                      window=0):
    """K3 at ``shape`` = (name, H, KV, hd): a causal prefill of ``batch``
    x ``rows`` rows (with the sliding ``window`` mask where given)
    against its plain version, and its suffixes at ``offsets`` against
    theirs and bitwise against the full rows; with two or more rows,
    each row alone bitwise its row of the batch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    name, H, KV, hd = shape
    dt = getattr(torch, dtype)
    tol = TOL[dtype]
    S, B = rows, batch

    def rand(*shp):
        return torch.randn(*shp, device=dev, generator=g).to(dt)

    q, k, v = rand(B, S, H, hd), rand(B, S, KV, hd), rand(B, S, KV, hd)
    full = flash_attention_cuda(q, k, v, window=window)
    case = f"{name} [{B},{S},{H},{hd}] kv {KV} causal" + (
        f" window {window}" if window else "")
    record("flash_attention", dtype, case, full,
           ref.flash_attention_ref(q, k, v, window=window), tol)
    for off in offsets:
        suf = flash_attention_cuda(q[:, off:].contiguous(), k, v,
                                   q_offset=off, window=window)
        record("flash_attention", dtype, f"{case} q_offset={off}", suf,
               ref.flash_attention_ref(q[:, off:], k, v, q_offset=off,
                                       window=window), tol)
        check(torch.equal(suf, full[:, off:]),
              f"flash_attention {name}: suffix at q_offset={off} is not "
              f"bitwise equal to the full prefill's rows")
    for b in range(B if B > 1 else 0):
        alone = flash_attention_cuda(*(t[b:b + 1].contiguous()
                                       for t in (q, k, v)), window=window)
        check(torch.equal(alone, full[b:b + 1]),
              f"flash_attention {name}: row {b} alone is not bitwise "
              f"equal to row {b} of the batch")


#: deepseek_7b's bf16 products (K x N), which window_main_path serves a
#: row of alone (``generate``) and in a batch of 2: q/k/v/o, gate and up,
#: down, the untied logits
WINDOW_GEMMS = {"deepseek_7b qkvo": (4096, 4096),
                "deepseek_7b gate_up": (4096, 11008),
                "deepseek_7b down": (11008, 4096),
                "deepseek_7b logits": (4096, 102400)}
#: (shape, rows, window) of K3's window cases, two rows each:
#: deepseek_7b's heads at the window of 8192 over a prompt past it, and
#: qwen3_32b's GQA at a window of 1000, not a multiple of the 128-key
#: block
WINDOW_PREFILLS = ((("deepseek_7b", 32, 32, 128), 8704, 8192),
                   (("qwen3_32b", 64, 8, 128), 2304, 1000))

#: (name, H, KV, hd) of the attention shapes K2, K4 and K5 are held at:
#: minicpm_2b's (the served path), qwen3_32b's (GQA, wide heads: a
#: 5-query window is three 16-row tiles), stablelm_12b's (head_dim 160,
#: the widest bf16 instance), granite_moe_3b_a800m's, and the stub
#: models' (phi_3_vision_4_2b's head_dim 96, seamless_m4t_large_v2's 16
#: heads of 64, both MHA)
DECODE_SHAPES = (("minicpm_2b", 36, 36, 64), ("qwen3_32b", 64, 8, 128),
                 ("stablelm_12b", 32, 8, 160),
                 ("granite_moe_3b_a800m", 24, 8, 64),
                 ("phi_3_vision_4_2b", 32, 32, 96),
                 ("seamless_m4t_large_v2", 16, 16, 64))
#: one rank's bf16 products under tensor-parallel serving (K x N): the
#: q/k/v, output, FFN and logits products of minicpm_2b at tp 2 and of
#: qwen3_32b at tp 2 and tp 4
TP_GEMMS = {"minicpm tp2 q": (2304, 1152), "minicpm tp2 o": (1152, 2304),
            "minicpm tp2 gate_up": (2304, 2880),
            "minicpm tp2 down": (2880, 2304),
            "minicpm tp2 logits": (2304, 61440),
            "qwen3 q": (5120, 8192), "qwen3 kv": (5120, 1024),
            "qwen3 o": (8192, 5120), "qwen3 gate_up": (5120, 25600),
            "qwen3 down": (25600, 5120),
            "qwen3 tp2 q": (5120, 4096), "qwen3 tp2 kv": (5120, 512),
            "qwen3 tp2 o": (4096, 5120), "qwen3 tp2 gate_up": (5120, 12800),
            "qwen3 tp2 down": (12800, 5120),
            "qwen3 tp2 logits": (5120, 75968),
            "qwen3 tp4 q": (5120, 2048), "qwen3 tp4 kv": (5120, 256),
            "qwen3 tp4 o": (2048, 5120), "qwen3 tp4 gate_up": (5120, 6400),
            "qwen3 tp4 down": (6400, 5120),
            "qwen3 tp4 logits": (5120, 37984)}
#: one rank's heads under tensor-parallel serving: minicpm_2b's 36 MHA
#: heads at tp 2, qwen3_32b's 64 over 8 kv heads at tp 2 and tp 4,
#: granite_moe_3b_a800m's 24 over 8, jamba's 64 over 8 and
#: seamless_m4t_large_v2's 16 over 16 at tp 2 (minicpm_2b's at tp 8 are
#: its 36 whole, DECODE_SHAPES[0])
TP_HEADS = (("minicpm_2b tp2", 18, 18, 64), ("qwen3_32b tp2", 32, 4, 128),
            ("qwen3_32b tp4", 16, 2, 128),
            ("granite_moe_3b_a800m tp2", 12, 4, 64),
            ("jamba_1_5_large_398b tp2", 32, 4, 128),
            ("seamless_m4t_large_v2 tp2", 8, 8, 64))
#: granite_moe_3b_a800m's attention shape: 3 query heads per kv head
GRANITE = DECODE_SHAPES[3]
#: the stub models' attention shapes
STUB_HEADS = DECODE_SHAPES[4:]
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
        for name, (K, N) in list(shapes.items()) + (
                list(TP_GEMMS.items()) + list(WINDOW_GEMMS.items())
                if dtype == "bfloat16" else []):
            x = torch.randn(32, K, device=dev, generator=g).to(dt)
            if name in ("logits", "minicpm tp2 logits"):   # tied: the embedding's transpose
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


def schedule(cfg):
    """(RMSNorm launches per forward pass, layers that launch an
    attention kernel): a norm before each mixer, one before each FFN,
    MLA's two latent norms (``q_a_norm``, ``kv_a_norm``) in each of its
    layers, dense head layers included, and the final one.  MLA attends
    in plain PyTorch (``models/mla.py``, as JAX attends outside any
    Pallas kernel) and launches no attention kernel."""
    from repro_torch.models import transformer as tf
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    mla = 2 if cfg.use_mla else 0
    norms = 1 + sum(1 + ("ffn" in tf.layer_template(cfg, k, f))
                    + (mla if k == "attn" else 0) for k, f in kinds)
    return norms, 0 if cfg.use_mla else sum(k == "attn" for k, _ in kinds)


def drive_engine_path(torch, engine, cfg, rng, kind="slot"):
    """The engine's main path with every launch counter at 0 first:
    ``generate`` on GEN_PROMPT prompts for GEN_NEW tokens, then two
    prefill groups inserted into a 4-slot cache of layout ``kind`` (slot
    or state), TICKS decode ticks (slot 3 idle for the first half) and
    one verify window (the state layout's: ``verify_window``, then the
    rewind of row 0 to the window's third position).  Checks the
    tokens' range and the outputs' shapes; returns the launch counts and
    the schedule's, the tokens and the cache."""
    import numpy as np
    from repro_torch.kernels import build
    norms, attn = schedule(cfg)
    prompt = rng.randint(0, cfg.vocab_size, GEN_PROMPT).astype(np.int32)
    groups = [rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
              for S in GROUPS]
    drafts = rng.randint(0, cfg.vocab_size,
                         (4, VERIFY_WIDTH - 1)).astype(np.int32)
    backend = types.SimpleNamespace(kind=kind, num_slots=4)
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
    if kind == "state":
        guess, cache, stacks = engine.verify_window(backend, cache, window,
                                                    pos, np.ones(4, bool))
        cache = engine.state_rewind(cache, stacks, 0, 2)
    else:
        guess, cache = engine.verify(backend, cache, window, pos,
                                     np.ones(4, bool))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(build.launches)
    prefills = 1 + len(GROUPS)
    ticks = (GEN_NEW - 1) + TICKS
    expected = {name: 0 for name in build.launches}
    expected.update({"rmsnorm": norms * (prefills + ticks + 1),
                     "flash_attention": attn * prefills,
                     "fused_flash_decode": attn * (ticks + 1)})
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
    plain_flags = RuntimeFlags(**PLAIN_FLAGS)
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


def pressure_blocks(requests, shared=True):
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
    beside the shared prefix's 16, held once, or with ``shared`` False
    (no prefix sharing, as on the hybrid layout) each request's own."""
    import itertools
    bs = SERVE_BLOCK
    shared = SERVE_PREFIX // SERVE_BLOCK if shared else 0
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
          prefix_sharing=True, speculate_k=SERVE_SPEC, hook=None,
          backend=None, max_new=SERVE_NEW, chunk=SERVE_CHUNK):
    """Serve ``requests`` through the port's ``Scheduler`` to completion,
    with every launch counter at 0 before the first call; ``hook(sched)``
    is called before the requests are submitted.  The backend is a
    PagedBackend of ``num_blocks`` blocks, a SlotBackend (``paged``
    False), or ``backend(engine)``.  Returns ({id: tokens}, scheduler
    stats with the wall seconds spent in ``admit`` (admission and prompt
    ingestion) and in ``step`` (decode and verify ticks), launch counts,
    wall seconds)."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.serving import PagedBackend, Scheduler, SlotBackend
    if backend is not None:
        backend = backend(engine)
    elif paged:
        backend = PagedBackend(engine, SERVE_SLOTS, num_blocks=num_blocks,
                               block_size=SERVE_BLOCK,
                               prefix_sharing=prefix_sharing)
    else:
        backend = SlotBackend(engine, SERVE_SLOTS)
    sched = Scheduler(backend, max_new_tokens=max_new,
                      chunk_size=chunk, speculate_k=speculate_k,
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
    runs ``schedule(cfg)``'s norms; every prefill or extend call one K3
    per attention layer; every decode or verify tick, and every decode
    or verify call of a replay, one ``attend`` per attention layer (none
    where ``attend`` is None: K/V on head_dim or on the sequence decode
    in plain PyTorch)."""
    from repro_torch.kernels import build
    norms, attn = schedule(cfg)
    pre = stats["prefill_calls"]
    ticks = stats["decode_steps"] + stats["replay_steps"]
    want = {name: 0 for name in build.launches}
    want.update({"rmsnorm": norms * (pre + ticks),
                 "flash_attention": attn * pre})
    if attend is not None:
        want[attend] = attn * ticks
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
        add_counts(counts_all, counts)
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


def compare_with_greedy(torch, engine, requests, got, max_len=SERVE_MAX_LEN,
                        new=SERVE_NEW, chunk=None, routes=None):
    """Each request alone through ``engine.model``: prefill, then greedy
    decode steps, keeping the logits.  A served token must equal the
    reference's while the reference's top-2 gap is at least TOP2_GAP; a
    row is compared up to its first near-tie.  With ``chunk`` the prompt
    is prefilled in the served chunks (a first chunk, then extends
    against the row's own cache), so that a MoE call of the reference
    carries a served call's tokens and drops what it drops (Hazard 7).
    ``routes`` (request -> the served run's MoE choices, call by call,
    of the same passes alone) stops a row before the first token whose
    passes were routed otherwise: a choice flipped by rounding moves the
    row's output by O(1), which no gap rule bounds."""
    V = engine.cfg.vocab_size
    dev = engine.device
    rows = tokens = mismatches = 0
    near_ties, rerouted = [], []
    for i, prompt in enumerate(requests):
        x = torch.as_tensor(prompt, device=dev).long()[None]
        rec = RouteRecorder() if routes is not None else \
            contextlib.nullcontext()
        rec.__enter__()
        logits, cache = engine.model.prefill(x[:, :chunk], max_len,
                                             flags=engine.flags)
        for start in range(chunk, prompt.size, chunk) if chunk else ():
            logits = extend_own_row(torch, engine, x, cache, start, chunk,
                                    max_len)
        n = 0
        for j in range(new):
            if routes is not None and not (
                    len(rec.calls) <= len(routes[i])
                    and all(routed_alike(torch, a, b, engine.cfg)
                            for a, b in zip(rec.calls, routes[i]))):
                rerouted.append([i, j])
                break
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
        rec.__exit__(None, None, None)
        rows += n > 0
        tokens += n
    out = {"rows": len(requests), "rows_compared": rows,
           "tokens_compared": tokens, "mismatches": mismatches,
           "near_ties": near_ties, "top2_gap": TOP2_GAP}
    if routes is not None:
        out["rerouted_at"] = rerouted
    return out


def routed_alike(torch, a, b, cfg) -> bool:
    """Two MoE calls' choices [N, k] route every token alike: the same
    set of experts (their rank order moves no output), as many of them
    kept."""
    from repro_torch.models import moe
    if a.shape != b.shape:
        return False
    E, C = moe.padded_experts(cfg), moe.capacity(cfg, a.shape[0])
    return bool((a.sort(-1).values == b.sort(-1).values).all()) and \
        torch.equal(kept(torch, a, E, C).sum(-1), kept(torch, b, E, C).sum(-1))


def extend_own_row(torch, engine, x, cache, start, chunk, max_len):
    """Prefill ``x[:, start:start + chunk]`` against positions ``[0,
    start)`` of the one-row slot ``cache`` and write its rows there, in
    place; returns the logits after the chunk."""
    from repro_torch.models import paging
    from repro_torch.models.params import flatten
    logits, rows = engine.model.prefill_extend(
        x[:, start:start + chunk], cache,
        paging.SlotPrefix(torch.zeros(1, dtype=torch.long,
                                      device=engine.device)),
        start, max_len, flags=engine.flags)
    n = min(chunk, x.shape[1] - start)
    leaves = flatten(cache)
    for path, a in flatten(rows).items():
        ax = 2 if path.startswith("blocks.") else 1     # [R, B, T, ...]
        leaves[path].narrow(ax, start, n).copy_(a.narrow(ax, 0, n))
    return logits


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


def compare_greedy(torch, engine, plain, toks, steps, tol, max_len=MAX_LEN,
                   exact=None, **embeds):
    """Greedy decode on the kernel path; the plain path is teacher-forced
    on its tokens.  Tokens must agree wherever the plain logits' top-2
    gap exceeds ``tol``, and at least half of the rows must be compared
    so; logits are held at ``tol`` too.  With ``exact`` (the plain path
    on the same weights in f64, teacher-forced as well) a step's limit
    is ``tol`` or, where the f32 plain path itself sits further than
    that from the f64 run, that distance: the two f32 paths may part by
    no more than f32 rounding parts the plain path from exact.
    ``embeds`` are the prefill's stub inputs (``prefix_embeds``,
    ``enc_embeds``)."""
    x = torch.as_tensor(toks).long().to(DEVICE)
    B, S = x.shape
    if "prefix_embeds" in embeds:
        S += embeds["prefix_embeds"].shape[1]
    V = engine.cfg.vocab_size
    lk, ck = engine.model.prefill(x, max_len, **embeds)
    lp, cp = plain.model.prefill(x, max_len, flags=plain.flags, **embeds)
    if exact is not None:
        lx, cx = exact.model.prefill(x, max_len, flags=exact.flags, **embeds)
    worst, scale, agree_all, compared = 0.0, 0.0, True, 0
    errs, limits = [], []
    for i in range(steps):
        lk, lp = lk[:, :V], lp[:, :V]
        for a in (lk, lp):
            check(bool(torch.isfinite(a).all()), "non-finite logits")
        errs.append(float((lk - lp).abs().max()))
        limits.append(tol if exact is None else max(
            tol, float((lp.double() - lx[:, :V]).abs().max())))
        worst = max(worst, errs[-1])
        scale = max(scale, float(lp.abs().max()))
        tok = torch.argmax(lk, -1)
        agree, n = top2_agree(torch.argmax(lp, -1), tok, lp, tol)
        agree_all, compared = agree_all and agree, compared + n
        pos = torch.full((B,), S + i, dtype=torch.int32, device=DEVICE)
        lk, ck = engine.model.decode_step(tok[:, None], ck, pos)
        lp, cp = plain.model.decode_step(tok[:, None], cp, pos,
                                         flags=plain.flags)
        if exact is not None:
            lx, cx = exact.model.decode_step(tok[:, None], cx, pos,
                                             flags=exact.flags)
    total = steps * B
    out = {"steps": steps, "rows": B, "max_abs_logit_err": worst,
           "logit_scale": scale, "tol": tol, "tokens_agree": agree_all,
           "tokens_compared": compared, "tokens_total": total,
           "ok": (agree_all and all(e <= m for e, m in zip(errs, limits))
                  and 2 * compared >= total)}
    if exact is not None:
        out.update({"step_errs": errs, "step_limits": limits})
    return out


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

    def __init__(self, torch, limit=PREEMPTIONS):
        self.torch = torch
        self.limit = limit                 # preemptions to force
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
        if len(self.streamed) >= self.limit:
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
        read through its block table on a paged arena (or its slot row on
        the state layout), and its row of each recurrent state slab."""
        from repro_torch.models.params import flatten
        be = self.sched.backend
        model = be.engine.model
        out = []
        for path, leaf in flatten(be.cache).items():
            if not path.startswith("blocks."):            # a head layer's
                leaf = leaf[None]
            if model.layer_kind_of_path(path) != "attn":
                out.append(leaf[:, req.slot].clone())     # [R, ...] state
            elif be.kind in ("paged", "hybrid"):          # [R, NB, bs, ...]
                pages = self.torch.as_tensor(
                    be.tables[req.slot][:-(-n // be.block_size)],
                    device=be.engine.device).long()
                rows = leaf[:, pages].reshape(leaf.shape[0], -1,
                                              *leaf.shape[3:])
                loc = leaf.shape[2]
                if loc < be.block_size:
                    # a tensor-parallel rank 0's offsets [0, loc) of
                    # every block (a leaf cut on the sequence)
                    at = (self.torch.arange(len(pages))[:, None]
                          * be.block_size + self.torch.arange(loc)[None])
                    rows = rows[:, (at.reshape(-1) < n).to(rows.device)]
                out.append(rows[:, :n].clone())
            else:                                         # [R, N, T, ...]
                out.append(leaf[:, req.slot, :n].clone())
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
        add_counts(counts_all, counts)

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
    add_counts(counts_all, run.counts)
    return counts_all, tokens


# ---------------------------------------------------------------------------
# phase 3d' — ROADMAP F2: the two replay paths of Hazard 5 not yet read
# ---------------------------------------------------------------------------

#: f2_group_prefill: prompt lengths shorter than the chunk, two requests
#: each, so that the slot layout prefills them in groups of two (width 2)
#: and a readmitted victim replays its prompt alone (width 1)
F2_GROUP_LENGTHS = (96, 96, 160, 160, 200, 200, 240, 240)
#: f2_prefix_readmit: the shared prefix (6 whole blocks of 16 and 4 more
#: tokens, so that the sharer's chunks start at 96, not at a multiple of
#: the chunk) and the two prompts' lengths
F2_PREFIX = 100
F2_PREFIX_LENGTHS = (520, 600)


def f2_requests(vocab, lengths, prefix=0, seed=SEED + 7):
    import numpy as np
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, prefix)
    return [np.concatenate([shared, rng.randint(0, vocab, n - prefix)])
            .astype(np.int32) for n in lengths]


def f2_report(phase, forced, want, run):
    """Print one F2 reading and hold it: the forced run's tokens bitwise
    the run's without preemption, and the replayed rows' K/V bitwise
    what they held; a replay whose derived token broke the determinism
    check is reported with its error before the run fails."""
    import numpy as np
    got, stats, error = run
    equal = sum(bool(i in got and np.array_equal(got[i], want[i]))
                for i in want)
    r = {"phase": phase, "forced_preemptions": len(forced.streamed),
         "victims_streamed_tokens": forced.streamed,
         "replays_kv_bitwise": sum(forced.kv_equal),
         "replays_checked": len(forced.kv_equal),
         "bitwise_equal_to_unpreempted": equal, "requests": len(want),
         "replay_error": error}
    if stats is not None:
        r["stats"] = {k: stats[k] for k in (
            "preemptions", "replayed_tokens", "replay_steps",
            "prefill_calls", "decode_steps")}
    r["exact"] = error is None and equal == len(want) \
        and all(forced.kv_equal) and len(forced.kv_equal) > 0
    emit(r)
    check(r["exact"], f"{phase}: the replay is not exact")
    return r


def forced_serve(torch, engine, requests, forced, **kw):
    """``serve`` with ``forced`` installed: (tokens, stats, None), or
    (the tokens finished, None, the error) where a replay raised."""
    try:
        got, stats, _, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                                 hook=forced.install, **kw)
        return got, stats, None
    except RuntimeError as e:
        return {}, None, str(e)


class SharerGone(ForcedPreemption):
    """Preempts request 1 once it has streamed PREEMPT_AFTER tokens and
    holds its readmission until request 0, which computed the prefix
    blocks request 1 shares, has finished and released them; records the
    prefix tokens request 1 reused at each admission."""

    def install(self, sched):
        super().install(sched)
        self.prefix_lens = []
        admit, acquire = sched.admit, sched.backend.acquire

        def held_admit():
            alive = any(r is not None and r.id == 0 for r in sched.slots)
            if self.streamed and alive:
                return []
            return admit()

        def recorded_acquire(req, seq):
            acquire(req, seq)
            if req.id == 1:
                self.prefix_lens.append(req.prefix_len)

        sched.admit = held_admit
        sched.backend.acquire = recorded_acquire

    def _preempt(self):
        sched = self.sched
        if self.streamed:
            return
        for req in sched.slots:
            if (req is not None and req.id == 1
                    and req not in sched.ingesting
                    and len(req.tokens) >= PREEMPT_AFTER):
                self._held[req] = self._kv(req, int(sched.positions[req.slot]))
                self.streamed.append(len(req.tokens))
                sched.preempt(req)
                return


def phase_f2(torch):
    """ROADMAP F2 on bf16 minicpm_2b at full width and depth.  (a)
    ``f2_group_prefill``: prompts shorter than the chunk on a SlotBackend,
    which prefills them in groups of two; PREEMPTIONS requests preempted
    after streaming tokens replay their prompts alone.  (b)
    ``f2_prefix_readmit``: on a PagedBackend with prefix sharing, the
    second of two requests sharing a 100-token prefix is preempted and
    readmitted only once the first has finished, so that the shared
    blocks are gone and its prompt is recomputed from position 0 in
    chunks other than its first admission's.  Each is held to the same
    run without preemption: tokens, and the replayed rows' K/V, bitwise
    (``f2_report``)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import LLMEngine
    cfg = get_config("minicpm_2b")
    engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    out = {}
    requests = f2_requests(cfg.vocab_size, F2_GROUP_LENGTHS)
    want, st0, _, _ = serve(torch, engine, requests, 0, paged=False,
                            speculate_k=0)
    check(st0["preemptions"] == 0 and st0["prefill_padded_rows"] == 0,
          "f2_group_prefill: the run without preemption preempted, or "
          "padded a group")
    forced = ForcedPreemption(torch)
    out["group_prefill"] = f2_report(
        "f2_group_prefill", forced, want,
        forced_serve(torch, engine, requests, forced, paged=False,
                     speculate_k=0))

    requests = f2_requests(cfg.vocab_size, F2_PREFIX_LENGTHS, F2_PREFIX)
    want, st0, _, _ = serve(torch, engine, requests, ROOMY_BLOCKS,
                            speculate_k=0)
    check(st0["shared_block_hits"] > 0, "f2_prefix_readmit: the second "
                                        "request shared no prefix block")
    forced = SharerGone(torch)
    r = f2_report("f2_prefix_readmit", forced, want,
                  forced_serve(torch, engine, requests, forced,
                               speculate_k=0))
    emit({"phase": "f2_prefix_readmit_admissions",
          "prefix_tokens_reused": forced.prefix_lens})
    check(len(forced.prefix_lens) == 2 and forced.prefix_lens[0] > 0
          and forced.prefix_lens[1] == 0,
          f"f2_prefix_readmit: the readmission reused prefix blocks "
          f"{forced.prefix_lens}")
    out["prefix_readmit"] = r
    del engine
    free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 3e — the decode and verify steps as CUDA graphs against eager
# ---------------------------------------------------------------------------

#: decode ticks read per engine and layout, in turns (cut from 120)
TICK_READS = 12


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
        ticks = interleaved_ticks(torch, steps, requests, kind)
        if kind == "paged":
            paged = ticks
        for name, r in ticks.items():
            emit({"phase": "captured_tick", "layout": kind, "steps": name,
                  **r, "nvidia_smi": smi})
    emit({"phase": "captured_graphs", **graph_count(steps["captured"])})
    # the captured paged tick's device time (its ``graph_device_ms``),
    # for cost_model, beside the tick's bytes bound (every weight once,
    # each row's K/V at the middle of the ticks read)
    engine = steps["captured"]
    graph_ms = paged["captured"]["graph_device_ms"]
    check(graph_ms is not None, "captured: no captured paged decode graph")
    keys = sum(p.size + 3 + TICK_READS // 2
               for p in requests[:SERVE_SLOTS])
    nbytes = tick_weight_bytes(engine, SERVE_SLOTS) + 2 * keys \
        * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    emit({"phase": "captured_tick_device", "layout": "paged",
          "graph_device_ms": graph_ms, "bound_bytes": nbytes,
          "bound_ms": nbytes / HBM_BPS * 1e3, "bound_by": "bytes"})
    COST_STEPS.append(tick_cost(
        "minicpm_2b captured paged tick, 4 slots", "captured", engine,
        "paged", graph_ms, nbytes))


def interleaved_ticks(torch, engines, requests, kind, ticks=TICK_READS,
                      profiled=3):
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
                     "graph_device_ms": graph_device_ms(
                         torch, engines[name], kind),
                     **device_share(per, med, (
                         "rmsnorm_kernel", "fused_decode_mma_kernel"))}
    return out


def graph_device_ms(torch, engine, kind, slots=SERVE_SLOTS):
    """The captured decode graph's device ms on ``kind``'s layout at
    ``slots`` rows, by CUDA events over queued replays (None for an
    engine without one).  Read while the backend whose cache the graph
    was captured on lives: a replay after it is freed reads freed
    memory."""
    graphs = [cs for key, cs in (engine.graphs.steps.items()
                                 if engine.graphs is not None else ())
              if key[:2] == ("decode", kind) and key[3] == slots]
    return cuda_ms(torch, graphs[-1].graph.replay, profile=False)[0] \
        if graphs else None


# ---------------------------------------------------------------------------
# phase 4b — tensor-parallel serving (ROADMAP item 11a): head-sliced ranks
# on one card, gloo collectives
# ---------------------------------------------------------------------------

#: ranks of the tensor-parallel phases; every rank on the one card (the
#: collectives are gloo, which stages CUDA tensors through the host, so
#: ranks may share a card; NCCL refuses two ranks on one device)
TP = 2
TP_DEVICE = "cuda:0"
#: the tensor-parallel serve run: the serve workload's first requests,
#: each for fewer new tokens (cut from SERVE_REQUESTS and SERVE_NEW)
TP_REQUESTS = 4
TP_NEW = 12
TP_TICKS = 12
#: depth of the f32 comparison of tp 2 against tp 1 (as xlstm_serve's)
TP_F32_DEPTH = 8
#: depth of tp_serve's K4 run, with its forced preemption (cut from 40),
#: and of its K2 run, slot run and ticks (cut from 40 to pay for item
#: 11b-ii's phases)
TP_SPLITK_DEPTH = 6
TP_SERVE_DEPTH = 6
QWEN_ARCH = "qwen3_32b"
QWEN_DEPTH = 2
GQA_MAX_LEN = 512
GQA_REQUESTS = 4
GQA_PROMPT = (300, 380)
GQA_NEW = 8
GQA_BLOCKS = 1 + SERVE_SLOTS * GQA_MAX_LEN // SERVE_BLOCK
#: (tp, run) of tp_gqa: K2 on 32/4 heads a rank, K4 on 16/2 (K2 at 16/2
#: and K4 at 32/4 are held in kernel_vs_plain; the two other engines'
#: start-ups did not fit the run's budget)
GQA_RUNS = ((2, ("default", {}, "fused_flash_decode")),
            (4, ("split_k", {"fused_split_k": True},
                 "fused_flash_decode_splitk")))


#: the tensor-parallel phases' ``WorkerPool``: an engine takes the idle
#: workers a closed one of the same mesh left (``main`` makes it and
#: closes it after the last tp phase), so that a mesh's worker processes
#: start once, not once an engine
TP_POOL = None


def tp_engine(torch, cfg, tp, max_len, weights=None, pool=None, **flags):
    """An engine over ``tp`` ranks on the card (rank 0 here, the others
    in the workers of ``pool``, by default TP_POOL's, or spawned),
    eager: a gloo collective cannot be captured."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    return LLMEngine(cfg, weights, max_len=max_len, seed=SEED,
                     flags=RuntimeFlags(cuda_graphs=False, **flags),
                     mesh=make_serving_mesh(tp, devices=[TP_DEVICE] * tp),
                     pool=pool or TP_POOL)


def tp_serve(torch, engine, cfg, requests, blocks, attend, **kw):
    """``serve`` on a tensor-parallel engine with every rank's launch
    counter at 0 first; every rank's launches held to the schedule.
    Returns (tokens, stats, the ranks' launches summed, wall)."""
    engine.rank_launches(reset=True)
    got, stats, _, wall = serve(torch, engine, requests, blocks, **kw)
    per_rank = engine.rank_launches()
    want = expected_serve_launches(cfg, stats, attend)
    check(all(c == want for c in per_rank),
          f"{cfg.name} tp{engine.tp}: a rank's launches {per_rank} != the "
          f"schedule's {want}")
    total = {}
    for c in per_rank:
        add_counts(total, c)
    return got, stats, total, wall, per_rank, want


def own_greedy(torch, engine, requests, new, backend=None,
               chunk=SERVE_CHUNK):
    """Each request alone through a one-slot Scheduler on the engine's
    slot layout (or ``backend(engine)``, of one slot), greedy, without
    speculation: the served run's prefill and extend chunks (``chunk``),
    then one decode step a token."""
    from repro_torch.serving import SlotBackend
    make = backend or (lambda e: SlotBackend(e, 1))
    return {i: serve(torch, engine, [p], 0, speculate_k=0, max_new=new,
                     backend=make, chunk=chunk)[0][0]
            for i, p in enumerate(requests)}


def bitwise_equal(a, b):
    import numpy as np
    return sum(bool(np.array_equal(a[i], b[i])) for i in b) == len(b) \
        and sorted(a) == sorted(b)


def tp_ticks(torch, engines, requests, ticks=TP_TICKS, make=None,
             chunk=SERVE_CHUNK):
    """Scheduler decode ticks (4 active slots, no speculation; paged and
    roomy, or on ``make(engine)``'s layout) of each engine in turns, 3
    of warm-up then ``ticks`` read: each one's median and p10/p90 ms,
    and for a tensor-parallel engine rank 0's ``all_reduce`` calls a
    tick and their share of the tick (host clock around the
    collectives)."""
    import numpy as np
    from repro_torch.serving import PagedBackend, Scheduler
    scheds = {}
    for name, engine in engines.items():
        be = make(engine) if make is not None else PagedBackend(
            engine, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS,
            block_size=SERVE_BLOCK)
        sched = Scheduler(be, max_new_tokens=4 + 3 + ticks,
                          chunk_size=chunk)
        for i, p in enumerate(requests[:SERVE_SLOTS]):
            sched.submit({"tokens": p, "id": i})
        while sched.ingesting or sched.waiting:
            sched.admit()
        check(sched.active == SERVE_SLOTS, "tp ticks: slots not all active")
        scheds[name] = sched
    times = {name: [] for name in scheds}
    reduce = {name: [0, 0.0] for name in scheds}
    for i in range(3 + ticks):
        for name, sched in scheds.items():
            coll = engines[name].collectives
            c0 = (coll.reduce_calls, coll.reduce_s) if coll else (0, 0.0)
            t0 = time.perf_counter()
            sched.step()
            dt = time.perf_counter() - t0
            if i >= 3:
                times[name].append(dt * 1e3)
                if coll:
                    reduce[name][0] += coll.reduce_calls - c0[0]
                    reduce[name][1] += coll.reduce_s - c0[1]
    out = {}
    for name, ms in times.items():
        med = statistics.median(ms)
        row = {"ticks": len(ms), "ms_median": med,
               "ms_p10": float(np.percentile(ms, 10)),
               "ms_p90": float(np.percentile(ms, 90)),
               "tokens_per_s": SERVE_SLOTS / (med / 1e3)}
        if engines[name].collectives is not None:
            row.update({"all_reduce_per_tick": reduce[name][0] / ticks,
                        "all_reduce_ms_per_tick":
                            reduce[name][1] * 1e3 / ticks,
                        "all_reduce_share": reduce[name][1] * 1e3
                            / sum(ms)})
        out[name] = row
    return out


def phase_tp_serve(torch, smi):
    """minicpm_2b's first TP_SERVE_DEPTH layers at full width (bf16,
    random weights from the seed) on TP ranks of the card: the serve
    workload's first TP_REQUESTS requests for TP_NEW tokens through the
    Scheduler on a PagedBackend (chunk 256, speculate 4, prefix sharing,
    pressure), once with K2 and once, on the first TP_SPLITK_DEPTH
    layers, with K4
    (``fused_split_k``) and one forced preemption of a decoding request: every rank's launches equal to the
    schedule, the tokens bitwise each request served alone, greedy, by
    the same engine (``own_greedy``), the forced victim's K/V (rank 0's heads) replayed
    bitwise; slot = paged bitwise; then the eager tick against the
    unsharded eager tick, with the share of the tick in ``all_reduce``.
    Returns the launch counts of every rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = dataclasses.replace(minicpm_config(), num_layers=TP_SERVE_DEPTH)
    requests = serve_requests(cfg.vocab_size)[:TP_REQUESTS]
    blocks, four, three = pressure_blocks(requests)
    counts_all = {}
    for name, flags, attend in (
            ("split_k", {"fused_split_k": True},
             "fused_flash_decode_splitk"),
            ("default", {}, "fused_flash_decode")):
        # the K4 run on the first TP_SPLITK_DEPTH layers (the run's budget)
        run_cfg = dataclasses.replace(cfg, num_layers=TP_SPLITK_DEPTH) \
            if name == "split_k" else cfg
        t0 = time.perf_counter()
        engine = tp_engine(torch, run_cfg, TP, SERVE_MAX_LEN, **flags)
        start_s = time.perf_counter() - t0
        forced = ForcedPreemption(torch, limit=1)
        got, stats, counts, wall, per_rank, want = tp_serve(
            torch, engine, run_cfg, requests, blocks, attend,
            max_new=TP_NEW,
            hook=forced.install if name == "split_k" else None)
        equal = bitwise_equal(got, own_greedy(torch, engine, requests,
                                              TP_NEW))
        emit({"phase": "tp_serve", "run": name, "tp": TP,
              "layers": run_cfg.num_layers,
              "devices": list(engine.mesh.devices),
              "mesh": engine.mesh_desc, "requests": len(requests),
              "new_tokens": TP_NEW, "num_blocks": blocks,
              "engine_start_s": start_s, "seconds": wall,
              "launches_per_rank": per_rank, "expected_launches": want,
              "bitwise_equal_to_own_greedy": equal,
              "forced_preemptions": len(forced.streamed),
              "victims_streamed_tokens": forced.streamed,
              "replays_kv_bitwise_rank0": sum(forced.kv_equal),
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "spec_drafted", "spec_accepted",
                  "preemptions", "replayed_tokens", "replay_steps",
                  "shared_block_hits", "completed", "admit_seconds",
                  "step_seconds")}})
        check(stats["completed"] == len(requests),
              f"tp_serve {name}: not every request completed")
        check(stats["spec_steps"] > 0, f"tp_serve {name}: no verify step")
        check(equal, f"tp_serve {name}: tokens differ from the engine's "
                     f"requests served alone")
        add_counts(counts_all, counts)
        if name == "split_k":
            check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
                  and forced.kv_equal == [True],
                  "tp_serve: the forced preemption did not replay bitwise")
            engine.close()
            del engine
            free_card(torch)

    # ---- slot = paged (the default run's tokens, its own greedy ones) ----
    engine.rank_launches(reset=True)
    slot, _, _, _ = serve(torch, engine, requests, 0, paged=False,
                          max_new=TP_NEW)
    for c in engine.rank_launches():
        add_counts(counts_all, c)
    emit({"phase": "tp_serve_layouts", "tp": TP,
          "slot_bitwise_equal_to_paged": bitwise_equal(slot, got)})
    check(bitwise_equal(slot, got), "tp_serve: slot and paged tokens are "
                                    "not bitwise equal")

    # ---- the eager tick against the unsharded eager tick -----------------
    plain = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    ticks = tp_ticks(torch, {"tp1_eager": plain, f"tp{TP}_eager": engine},
                     serve_requests(cfg.vocab_size))
    emit({"phase": "tp_tick", "nvidia_smi": smi, **ticks})
    check(ticks[f"tp{TP}_eager"]["all_reduce_per_tick"]
          == 2 * cfg.num_layers + 2,
          "tp_tick: not one all_reduce after each layer's two products, "
          "the embedding and the logits")
    engine.close()
    del plain, engine
    free_card(torch)
    return counts_all


def phase_tp_f32(torch):
    """minicpm_2b's first TP_F32_DEPTH layers at full width in f32: tp 2
    against tp 1 (no mesh) on the same weights from the seed
    (``tp_f32_check``)."""
    cfg = dataclasses.replace(minicpm_config(), dtype="float32",
                              num_layers=TP_F32_DEPTH)
    requests = serve_requests(cfg.vocab_size)[:TP_REQUESTS]
    tp_f32_check(torch, "tp_f32", cfg, requests, SERVE_MAX_LEN,
                 [p[:256] for p in requests],
                 {"num_blocks": ROOMY_BLOCKS, "max_new": TP_NEW},
                 {"new": TP_NEW, "chunk": SERVE_CHUNK})


def tp_f32_check(torch, phase, cfg, requests, max_len, prompts, serve_kw,
                 greedy_kw):
    """``cfg`` (f32) at tp 2 against tp 1 (no mesh) on the same weights
    from the seed: the tp 2 run's Scheduler tokens (``serve(**serve_kw)``;
    with ``serve_kw`` None, each request alone, its MoE routing recorded)
    against tp 1's per-request greedy under the top-2 gap rule
    (``compare_with_greedy(**greedy_kw)``, with the routing: while the
    two routed alike); its first-step logits (on the rows every run
    routed alike, ``routing_rows``) over
    ``prompts`` within F32_MODEL_TOL of tp 1's or, as
    ``f32_against_plain`` holds two f32 paths to the f32 rounding floor,
    no further from an f64 run on the same weights than F32_MODEL_TOL or
    the f32 paths without a mesh (the plain one, tp 1) sit from it."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    t0 = time.perf_counter()
    one = LLMEngine(cfg, max_len=max_len, seed=SEED)
    tp = tp_engine(torch, cfg, TP, max_len)
    if serve_kw is None:
        # a MoE stack: each request alone on both sides, its routing
        # recorded, so that the rows are compared while routed alike
        got, routes = {}, {}
        for i, p in enumerate(requests):
            with RouteRecorder() as rec:
                got[i] = own_greedy(torch, tp, [p], greedy_kw["new"],
                                    chunk=greedy_kw["chunk"])[0]
            routes[i] = rec.calls
        stats = {"spec_steps": 0}
        greedy_kw = dict(greedy_kw, routes=routes)
    else:
        got, stats, _, _ = serve(torch, tp, requests, **serve_kw)
    exact = compare_with_greedy(torch, one, requests, got, max_len=max_len,
                                **greedy_kw)
    toks = np.stack(prompts)
    w32 = dict(one.model.named_parameters())
    plain = LLMEngine(cfg, w32, max_len=max_len,
                      flags=RuntimeFlags(**PLAIN_FLAGS))
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    x64 = LLMEngine(cfg64, {k: v.double() for k, v in w32.items()},
                    max_len=max_len, flags=RuntimeFlags(**PLAIN_FLAGS))
    lg, calls = {}, {}
    for name, e in (("tp1", one), ("tp2", tp), ("plain", plain),
                    ("f64", x64)):
        with RouteRecorder() as rec:
            lg[name] = e.prefill_logits(toks)
        calls[name] = rec.calls
    V, B = cfg.vocab_size, toks.shape[0]
    # the rows every run routed alike (all rows without a MoE layer)
    rows = torch.ones(B, dtype=torch.bool)
    for a, b in (("tp2", "tp1"), ("tp2", "f64"), ("tp1", "f64"),
                 ("plain", "f64")):
        if calls[a] or calls[b]:
            rows &= routing_rows(torch, calls[a], calls[b], B,
                                 moe_padded(cfg), cfg)[0]
    rows = rows.numpy()
    check(rows.any(), f"{phase} {cfg.name}: no row routed alike")

    def dist(a, b):
        return float(np.abs(lg[a][rows, :V] - lg[b][rows, :V]).max())

    err = dist("tp2", "tp1")
    # the f32 floor: how far the f32 runs without a mesh sit from f64.
    # Through a MoE stack one rounding of the same function lands about
    # as far again from f64 as another: granite's f32 paths without a
    # mesh, on rows every run routed alike, sit 0.0042 (kernels) and
    # 0.0105 (plain) from f64, logit scale 3.69 (measured on one H100),
    # so a third rounding, tp 2's, is held to twice the floor there
    floor = max(dist("plain", "f64"), dist("tp1", "f64"))
    limit = max(F32_MODEL_TOL, floor * (2 if any(calls.values()) else 1))
    emit({"phase": phase, "arch": cfg.name, "tp": TP,
          "depth": cfg.num_layers, "spec_steps": stats["spec_steps"],
          **exact, "logits_tp2_vs_tp1": err, "tp2_vs_f64": dist("tp2", "f64"),
          "tp1_vs_f64": dist("tp1", "f64"),
          "plain_f32_vs_f64": dist("plain", "f64"), "limit": limit,
          "logit_scale": float(np.abs(lg["f64"][:, :V]).max()),
          "logit_rows_routed_alike": int(rows.sum()), "logit_rows": B,
          "seconds": time.perf_counter() - t0})
    check(exact["rows_compared"] > 0 and exact["mismatches"] == 0,
          f"{phase} {cfg.name}: a tp 2 token differs from tp 1's greedy "
          f"where the top-2 gap is wide")
    check(err <= F32_MODEL_TOL or dist("tp2", "f64") <= limit,
          f"{phase} {cfg.name}: logits {err} from tp 1's and "
          f"{dist('tp2', 'f64')} from the f64 run, beyond {limit}")
    tp.close()
    del one, tp, plain, x64, w32
    free_card(torch)


def qwen_config():
    """qwen3_32b's first QWEN_DEPTH layers at full width."""
    from repro_torch.configs import get_config
    cfg = get_config(QWEN_ARCH)
    check((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.qk_norm) == (5120, 64, 8, 128, True),
          f"{QWEN_ARCH} is not at full width")
    return dataclasses.replace(cfg, num_layers=QWEN_DEPTH)


def gqa_requests(vocab: int):
    """GQA_REQUESTS prompts sharing SERVE_PREFIX tokens, bodies of a
    repeated motif, lengths in GQA_PROMPT."""
    import numpy as np
    rng = np.random.RandomState(SEED + 11)
    prefix = rng.randint(0, vocab, SERVE_PREFIX)
    out = []
    for n in rng.randint(GQA_PROMPT[0], GQA_PROMPT[1] + 1, GQA_REQUESTS):
        motif = rng.randint(0, vocab, SERVE_MOTIF)
        body = np.tile(motif, -(-(n - SERVE_PREFIX) // SERVE_MOTIF))
        out.append(np.concatenate([prefix, body[:n - SERVE_PREFIX]])
                   .astype(np.int32))
    return out


def phase_tp_gqa(torch, smi):
    """qwen3_32b's first two layers at full width (64 heads over 8 kv
    heads of 128, qk-norm; bf16) on the one card: the requests through
    the Scheduler on a PagedBackend (chunk 256, speculate 4, prefix
    sharing) at tp 2 with K2 on each rank's 32/4 heads and at tp 4 with
    K4 on 16/2 (``GQA_RUNS``), launches per rank = the schedule, tokens
    bitwise each request served alone by the same engine
    (``own_greedy``); then in f32 the tp 4
    mesh's tokens against tp 1's greedy under the top-2 gap rule.
    Returns the launch counts of every rank."""
    from repro_torch.serving import LLMEngine
    cfg = qwen_config()
    requests = gqa_requests(cfg.vocab_size)
    counts_all = {}
    for tp, (name, flags, attend) in GQA_RUNS:
        t0 = time.perf_counter()
        engine = tp_engine(torch, cfg, tp, GQA_MAX_LEN, **flags)
        start_s = time.perf_counter() - t0
        got, stats, counts, wall, per_rank, want = tp_serve(
            torch, engine, cfg, requests, GQA_BLOCKS, attend,
            max_new=GQA_NEW)
        equal = bitwise_equal(got, own_greedy(torch, engine, requests,
                                              GQA_NEW))
        emit({"phase": "tp_gqa", "run": name, "tp": tp,
              "heads_per_rank": [cfg.num_heads // tp,
                                 cfg.num_kv_heads // tp],
              "engine_start_s": start_s, "seconds": wall,
              "launches_per_rank": per_rank, "expected_launches": want,
              "bitwise_equal_to_own_greedy": equal,
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "shared_block_hits", "completed")}})
        check(stats["completed"] == len(requests)
              and stats["spec_steps"] > 0,
              f"tp_gqa tp{tp} {name}: the run did not complete or "
              f"verify")
        check(equal, f"tp_gqa tp{tp} {name}: tokens differ from the "
                     f"requests served alone")
        add_counts(counts_all, counts)
        engine.close()
        del engine
        free_card(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    one = LLMEngine(cfg32, max_len=GQA_MAX_LEN, seed=SEED)
    engine = tp_engine(torch, cfg32, 4, GQA_MAX_LEN)
    got, _, _, _ = serve(torch, engine, requests, GQA_BLOCKS,
                         max_new=GQA_NEW)
    exact = compare_with_greedy(torch, one, requests, got,
                                max_len=GQA_MAX_LEN, new=GQA_NEW,
                                chunk=SERVE_CHUNK)
    emit({"phase": "tp_gqa_f32", "tp": 4, **exact})
    check(exact["rows_compared"] > 0 and exact["mismatches"] == 0,
          "tp_gqa f32 tp4: a token differs from tp 1's greedy where the "
          "top-2 gap is wide")
    engine.close()
    del engine, one
    free_card(torch)
    return counts_all


# ---------------------------------------------------------------------------
# tensor-parallel serving of the MoE FFN and the recurrent mixers (item
# 11b-i): granite_moe_3b_a800m at full width and depth, jamba's first two
# layers at full width, xlstm_1_3b at full width, two ranks on the card
# ---------------------------------------------------------------------------

#: slots of the tp runs whose stacks hold a MoE FFN: a 4-slot verify tick
#: (20 tokens) overflows granite's experts' capacity of 8 rows, so that a
#: token's output would follow its batch (Hazard 7) and no longer be the
#: token it gets served alone; 2 slots (10 tokens) stay under it
TP_MOE_SLOTS = 2
#: new tokens of the state and hybrid tp runs: the forced preemption
#: wants a request that has streamed PREEMPT_AFTER tokens with 4 to go
TP_STATE_NEW = 16
#: xlstm_1_3b's depth at tp (cut from 48: one layer group, 7 mLSTM + 1
#: sLSTM), and granite's in the f32 check (cut from 32)
TP_STATE_DEPTH = 8
TP_MIXER_F32_DEPTH = 4
#: granite's depth in tp_moe (cut from 32 to pay for item 11b-ii's phases)
TP_MOE_DEPTH = 8
#: granite's f32 prompts: few tokens, so that few routing choices can flip
TP_MIXER_PROMPT = 16


def moe_padded(cfg) -> int:
    from repro_torch.models import moe
    return moe.padded_experts(cfg)


def tp_moe_drops(torch, calls, cfg, ticks_n):
    """The recorded MoE calls of one run (rank 0's choices over every
    expert): whether each rank's plan (its E/tp experts, the global
    capacity) keeps, together, exactly the pairs the unsharded plan
    keeps; the dropped pairs of the prefill chunks (SERVE_CHUNK tokens)
    and of the decode and verify ticks (at most ``ticks_n`` tokens), and
    the chunks' choices (``chunks``: their bytes, a call's fingerprint)."""
    from repro_torch.models import moe
    E = moe.padded_experts(cfg)
    E_l = E // TP
    exact, chunks, dropped = True, set(), {"chunk": 0, "tick": 0}
    for idx in calls:
        C = moe.capacity(cfg, idx.shape[0])
        whole = kept(torch, idx, E, C).int()
        ranks = sum(kept(torch, idx, E_l, C, r * E_l).int()
                    for r in range(TP))
        exact = exact and torch.equal(ranks, whole)
        n = moe.count_dropped(idx, E, C)
        if idx.shape[0] == SERVE_CHUNK:
            chunks.add(idx.cpu().numpy().tobytes())
            dropped["chunk"] += n
        elif idx.shape[0] <= ticks_n:
            dropped["tick"] += n
    return {"calls": len(calls), "ranks_keep_the_unsharded_pairs": exact,
            "chunk_dropped": dropped["chunk"],
            "tick_dropped": dropped["tick"]}, chunks


def tp_tick_line(phase, ticks, smi, cfg, per_layer):
    """Print ``tp_ticks``' rows, with rank 0's all-reduces a decode tick
    held to ``per_layer(kind, ffn)`` summed over the layers, plus the
    embedding's and the logits'."""
    want = 2 + sum(per_layer(k, f)
                   for k, f in zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    emit({"phase": phase, "arch": cfg.name, "nvidia_smi": smi,
          "expected_all_reduce_per_tick": want, **ticks})
    for name, row in ticks.items():
        if "all_reduce_per_tick" in row:
            check(row["all_reduce_per_tick"] == want,
                  f"{phase} {name}: {row['all_reduce_per_tick']} "
                  f"all-reduces a tick, not {want}")


def phase_tp_moe(torch, smi):
    """granite_moe_3b_a800m's first TP_MOE_DEPTH layers at full width
    (bf16, random weights from the seed) at tp 2 on the card: a rank
    holds 12 of the 24 heads over 4 of the 8 kv heads, 24 of the 48
    padded experts and half the vocabulary.  The serve workload's first TP_REQUESTS requests for
    TP_NEW tokens through the Scheduler on a roomy PagedBackend of
    TP_MOE_SLOTS slots (chunk 256, speculate 4, prefix sharing) with one
    forced preemption: every rank's launches equal to the schedule, the
    tokens bitwise each request served alone by the same engine
    (``own_greedy``), the victim's K/V (rank 0's heads) replayed bitwise;
    every MoE call's pairs kept by the ranks' plans are the unsharded
    plan's, and every served prefill chunk routes (and so drops) as the
    same chunk of its request alone; the ticks' drops are printed (a
    verify tick of 2 x 5 tokens has the capacity of a lone decode step,
    8 rows an expert).  Then the eager tick against the
    unsharded eager tick.  Returns the launch counts of every rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, PagedBackend
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(moe_config(), num_layers=TP_MOE_DEPTH)
    requests = serve_requests(cfg.vocab_size)[:TP_REQUESTS]
    blocks = 1 + TP_MOE_SLOTS * SERVE_MAX_LEN // SERVE_BLOCK
    t0 = time.perf_counter()
    engine = tp_engine(torch, cfg, TP, SERVE_MAX_LEN)
    start_s = time.perf_counter() - t0
    forced = ForcedPreemption(torch, limit=1)
    with RouteRecorder() as rec:
        got, stats, counts, wall, per_rank, want = tp_serve(
            torch, engine, cfg, requests, 0, "fused_flash_decode",
            max_new=TP_NEW, hook=forced.install,
            backend=lambda e: PagedBackend(e, TP_MOE_SLOTS,
                                           num_blocks=blocks,
                                           block_size=SERVE_BLOCK))
    with RouteRecorder() as alone_rec:
        alone = own_greedy(torch, engine, requests, TP_NEW)
    equal = bitwise_equal(got, alone)
    ticks_n = TP_MOE_SLOTS * (SERVE_SPEC + 1)
    served, chunks = tp_moe_drops(torch, rec.calls, cfg, ticks_n)
    ref, ref_chunks = tp_moe_drops(torch, alone_rec.calls, cfg, ticks_n)
    # each served chunk routed (and so dropped) as the same chunk alone
    chunks_alike = bool(chunks) and chunks <= ref_chunks
    emit({"phase": "tp_moe", "arch": cfg.name, "tp": TP,
          "slots": TP_MOE_SLOTS, "heads_per_rank": [
              cfg.num_heads // TP, cfg.num_kv_heads // TP],
          "experts_per_rank": moe_padded(cfg) // TP,
          "engine_start_s": start_s,
          "seconds": wall, "launches_per_rank": per_rank,
          "expected_launches": want, "bitwise_equal_to_own_greedy": equal,
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_kv_bitwise_rank0": sum(forced.kv_equal),
          "drops_served": served, "drops_alone": ref,
          "served_chunks_drop_as_alone": chunks_alike,
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "shared_block_hits",
              "completed", "admit_seconds", "step_seconds")}})
    check(stats["completed"] == len(requests) and stats["spec_steps"] > 0,
          "tp_moe: the run did not complete or verify")
    check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
          and forced.kv_equal == [True],
          "tp_moe: the forced preemption did not replay bitwise")
    check(served["ranks_keep_the_unsharded_pairs"]
          and ref["ranks_keep_the_unsharded_pairs"],
          "tp_moe: the ranks' plans keep other pairs than the unsharded "
          "plan")
    check(chunks_alike, "tp_moe: the served prefill chunks drop other "
                        "pairs than the requests' chunks alone")
    check(equal, "tp_moe: tokens differ from the engine's requests served "
                 "alone")
    plain = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    tp_tick_line("tp_moe_tick", tp_ticks(
        torch, {"tp1_eager": plain, f"tp{TP}_eager": engine},
        serve_requests(cfg.vocab_size)), smi, cfg,
        lambda k, f: 1 + 2 * (f == "moe") + (f == "dense"))
    engine.close()
    del plain, engine
    free_card(torch)
    emit({"phase": "tp_moe_done", "seconds": time.perf_counter() - t_phase})
    return counts


def phase_tp_hybrid(torch, smi):
    """jamba's first two layers at full width (attention + dense FFN,
    Mamba + MoE FFN; bf16, random weights from the seed) at tp 2 on the
    card, ~11.9 GB a rank: a rank holds 32 of the 64 heads over 4 of the
    8 kv heads, half of Mamba's d_inner and of the dense FFN, 8 of the
    16 experts.  The serve workload's first TP_REQUESTS requests for
    TP_STATE_NEW tokens through the Scheduler on a roomy HybridBackend of
    TP_MOE_SLOTS slots (chunk 256, speculate 4: ``verify_window`` and
    ``state_rewind`` over the mirror) with one forced preemption: launches
    per rank = the schedule, tokens bitwise each request served alone
    (a one-slot HybridBackend) and bitwise the same run on a
    StateBackend (attention in slot rows), the victim's K/V and state
    (rank 0's) replayed bitwise, every MoE call's pairs kept by the
    ranks' plans the unsharded plan's.  Then the eager tick against the
    unsharded eager tick, one engine at a time.  Returns the launch
    counts of every rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import HybridBackend, LLMEngine, StateBackend
    t_phase = time.perf_counter()
    cfg = jamba_config()
    requests = serve_requests(cfg.vocab_size)[:TP_REQUESTS]

    def hybrid(slots):
        return lambda e: HybridBackend(
            e, slots, num_blocks=1 + slots * SERVE_MAX_LEN // SERVE_BLOCK,
            block_size=SERVE_BLOCK, spec_window=STATE_SPEC_WINDOW)

    t0 = time.perf_counter()
    engine = tp_engine(torch, cfg, TP, SERVE_MAX_LEN)
    start_s = time.perf_counter() - t0
    forced = ForcedPreemption(torch, limit=1)
    with RouteRecorder() as rec:
        got, stats, counts, wall, per_rank, want = tp_serve(
            torch, engine, cfg, requests, 0, "fused_flash_decode",
            max_new=TP_STATE_NEW, hook=forced.install,
            backend=hybrid(TP_MOE_SLOTS))
    state, sstats, scounts, _ = serve(
        torch, engine, requests, 0, max_new=TP_STATE_NEW,
        backend=lambda e: StateBackend(e, TP_MOE_SLOTS,
                                       spec_window=STATE_SPEC_WINDOW))
    alone = own_greedy(torch, engine, requests, TP_STATE_NEW,
                       backend=hybrid(1))
    drops = tp_moe_drops(torch, rec.calls, cfg,
                         TP_MOE_SLOTS * (SERVE_SPEC + 1))[0]
    equal, layouts = bitwise_equal(got, alone), bitwise_equal(got, state)
    emit({"phase": "tp_hybrid", "arch": cfg.name, "layers": cfg.num_layers,
          "tp": TP, "slots": TP_MOE_SLOTS,
          "rank_param_gb": sum(p.numel() * p.element_size() for p in
                               engine.model.parameters()) / 1e9,
          "engine_start_s": start_s, "seconds": wall,
          "launches_per_rank": per_rank, "expected_launches": want,
          "bitwise_equal_to_own_greedy": equal,
          "hybrid_bitwise_equal_to_state": layouts,
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_kv_bitwise_rank0": sum(forced.kv_equal), "drops": drops,
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "completed",
              "state_slabs_peak", "admit_seconds", "step_seconds")},
          "state_spec_steps": sstats["spec_steps"]})
    check(stats["completed"] == len(requests) and stats["spec_steps"] > 0
          and sstats["spec_steps"] > 0,
          "tp_hybrid: a run did not complete or verify")
    check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
          and forced.kv_equal == [True],
          "tp_hybrid: the forced preemption did not replay bitwise")
    check(drops["ranks_keep_the_unsharded_pairs"],
          "tp_hybrid: the ranks' plans keep other pairs than the unsharded "
          "plan")
    check(equal, "tp_hybrid: tokens differ from the engine's requests "
                 "served alone")
    check(layouts, "tp_hybrid: hybrid and state tokens are not bitwise "
                   "equal")
    add_counts(counts, scounts)
    # the ticks one engine at a time: both hold 23.8 GB of weights
    ticks = tp_ticks(torch, {f"tp{TP}_eager": engine}, requests,
                     make=hybrid(SERVE_SLOTS))
    engine.close()
    del engine
    free_card(torch)
    plain = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    ticks.update(tp_ticks(torch, {"tp1_eager": plain}, requests,
                          make=hybrid(SERVE_SLOTS)))
    tp_tick_line("tp_hybrid_tick", ticks, smi, cfg,
                 lambda k, f: 1 + (k == "mamba") + 1 + (f == "moe"))
    del plain
    free_card(torch)
    emit({"phase": "tp_hybrid_done",
          "seconds": time.perf_counter() - t_phase})
    return counts


def phase_tp_state(torch, smi):
    """xlstm_1_3b at full width, its first TP_STATE_DEPTH layers (7 mLSTM
    + 1 sLSTM; bf16, random weights from the seed) at tp 2 on the card:
    a rank holds its half of each mLSTM head's dk (of C and n), 2 of its
    4 heads' m, half of each sLSTM gate block and of its state.  The
    xlstm workload's first TP_REQUESTS requests for TP_STATE_NEW tokens
    through the Scheduler on a StateBackend (4 slots, chunk 32, speculate
    4: ``verify_window`` and ``state_rewind`` over the mirror) with one
    forced preemption: launches per rank = the schedule, tokens bitwise
    each request served alone (a one-slot StateBackend), the victim's
    state (rank 0's) replayed bitwise.  Then the eager tick against the
    unsharded eager tick.  Returns the launch counts of every rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, StateBackend
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(xlstm_config(), num_layers=TP_STATE_DEPTH)
    requests = state_requests(cfg.vocab_size)[:TP_REQUESTS]
    t0 = time.perf_counter()
    engine = tp_engine(torch, cfg, TP, STATE_MAX_LEN)
    start_s = time.perf_counter() - t0
    forced = ForcedPreemption(torch, limit=1)
    got, stats, counts, wall, per_rank, want = tp_serve(
        torch, engine, cfg, requests, 0, "fused_flash_decode",
        max_new=TP_STATE_NEW, hook=forced.install, backend=state_backend(),
        chunk=STATE_CHUNK)
    alone = own_greedy(torch, engine, requests, TP_STATE_NEW,
                       backend=lambda e: StateBackend(e, 1),
                       chunk=STATE_CHUNK)
    equal = bitwise_equal(got, alone)
    emit({"phase": "tp_state", "arch": cfg.name, "layers": cfg.num_layers,
          "tp": TP, "engine_start_s": start_s, "seconds": wall,
          "launches_per_rank": per_rank, "expected_launches": want,
          "bitwise_equal_to_own_greedy": equal,
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_state_bitwise_rank0": sum(forced.kv_equal),
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "completed",
              "state_slabs_in_use", "admit_seconds", "step_seconds")}})
    check(stats["completed"] == len(requests) and stats["spec_steps"] > 0,
          "tp_state: the run did not complete or verify")
    check(stats["state_slabs_in_use"] == 0, "tp_state: slabs held after "
                                            "the run")
    check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
          and forced.kv_equal == [True],
          "tp_state: the forced preemption did not replay bitwise")
    check(equal, "tp_state: tokens differ from the engine's requests "
                 "served alone")
    plain = LLMEngine(cfg, max_len=STATE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    tp_tick_line("tp_state_tick", tp_ticks(
        torch, {"tp1_eager": plain, f"tp{TP}_eager": engine}, requests,
        make=lambda e: StateBackend(e, SERVE_SLOTS), chunk=STATE_CHUNK),
        smi, cfg, lambda k, f: 3 if k == "mlstm" else 2)
    engine.close()
    del plain, engine
    free_card(torch)
    emit({"phase": "tp_state_done", "seconds": time.perf_counter() - t_phase})
    return counts


def phase_tp_mixers_f32(torch):
    """In f32, tp 2 against tp 1 (``tp_f32_check``), one model at a time:
    granite's first TP_MIXER_F32_DEPTH layers at full width, the serve
    requests' last TP_MIXER_PROMPT tokens each alone at both, compared
    while the two route alike; and xlstm_1_3b's first TP_STATE_DEPTH
    layers served on a StateBackend.  (In f32 a routing choice among
    granite's 40 experts flips on rounding and moves the token's output,
    and through attention and the capacity its neighbours', by O(1):
    over prompts of 256 tokens every row of tp 2 routed otherwise than
    tp 1 in the first pass, and the f32 paths sat 0.97-1.29 from an f64
    run, logit scale 3.4; measured on one H100.)"""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(moe_config(), dtype="float32",
                              num_layers=TP_MIXER_F32_DEPTH)
    requests = [p[-TP_MIXER_PROMPT:] for p in
                serve_requests(cfg.vocab_size)]
    tp_f32_check(torch, "tp_mixers_f32", cfg, requests, SERVE_MAX_LEN,
                 requests, None, {"new": TP_NEW, "chunk": SERVE_CHUNK})
    cfg = dataclasses.replace(xlstm_config(), dtype="float32",
                              num_layers=TP_STATE_DEPTH)
    requests = state_requests(cfg.vocab_size)[:TP_REQUESTS]
    tp_f32_check(torch, "tp_mixers_f32", cfg, requests, STATE_MAX_LEN,
                 [p[:STATE_PROMPT[0]] for p in requests],
                 {"num_blocks": 0, "max_new": TP_STATE_NEW,
                  "backend": state_backend(), "chunk": STATE_CHUNK},
                 {"new": TP_STATE_NEW})
    emit({"phase": "tp_mixers_f32_done",
          "seconds": time.perf_counter() - t_phase})


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

        def recorded(params, cfg, xf, *rest, **kw):
            out = route(params, cfg, xf, *rest, **kw)
            if self.keep(xf.shape[0]):
                self.calls.append(out[1].clone())
            return out

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def kept(torch, idx, E_pad, C, e_offset=0):
    """[N, k] bool: which (token, choice) pairs of one call keep a
    capacity row (the others are dropped) in the plan over the E_pad
    experts from ``e_offset`` (a tensor-parallel rank's)."""
    from repro_torch.models import moe
    order, _, keep = moe.dispatch_plan(idx, E_pad, C, e_offset)
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
    V, L = cfg.vocab_size, moe_layers(cfg)
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
    plain_flags = RuntimeFlags(**PLAIN_FLAGS)
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


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg``: one ``moe.route`` call each per forward
    pass."""
    return cfg.ffn_kinds().count("moe")


def moe_drops(calls, cfg, N):
    """Dropped (token, expert) pairs summed over the layers of the first
    forward pass among ``calls`` whose calls carry N tokens."""
    from repro_torch.models import moe
    L = moe_layers(cfg)
    hits = [c for c in calls if c.shape[0] == N][:L]
    check(len(hits) == L, f"no forward pass of {N} tokens recorded")
    C = moe.capacity(cfg, N)
    E_pad = moe.padded_experts(cfg)
    per = [moe.count_dropped(c, E_pad, C) for c in hits]
    return {"tokens": N, "capacity": C, "dropped_pairs": sum(per),
            "layers_with_drops": sum(n > 0 for n in per),
            "pairs": N * cfg.num_experts_per_tok * L}


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
        add_counts(counts_all, counts)
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
        add_counts(counts_all, counts)
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
    """granite served by the port's launcher (``launcher_serve``).
    Returns the launch counts."""
    return launcher_serve(torch, smi, LAUNCHER_ARGS, moe_config(),
                          "fused_flash_decode", "moe_graph_serve")


def launcher_serve(torch, smi, argv, cfg, attend, phase):
    """The port's launcher (``repro_torch.launch.serve.main``, in this
    process, on the card) with ``argv``, once per front door: each must
    return 0 (every request answered) with launches equal to the
    server's schedule (``attend`` the decode attention kernel).  Prints
    the launcher's own summary lines, and TTFT, time per output token
    and tokens/s from the server's metrics and request timelines, beside
    the card's name and power limit.  Returns the launch counts."""
    import contextlib
    import io
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import RequestTimeline
    read = []
    n_req = int(argv[argv.index("--requests") + 1])

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
                rc = launcher.main(argv + ["--frontend", mode])
            wall = time.perf_counter() - t0
            free_card(torch)
            counts = dict(build.launches)
            _, stats, records = read[-1]
            want = expected_serve_launches(cfg, stats, attend)
            emit({"phase": phase, "frontend": mode, "rc": rc,
                  "argv": argv + ["--frontend", mode],
                  "seconds": wall, "launcher_lines":
                  buf.getvalue().splitlines(), "launches": counts,
                  "expected_launches": want, "stats": {
                      k: stats[k] for k in (
                          "prefill_calls", "decode_steps", "completed",
                          "preemptions", "replay_steps")}})
            check(rc == 0, f"{phase} {mode}: the launcher returned {rc}")
            check(counts == want, f"{phase} {mode}: launch counts "
                                  f"{counts} != {want}")
            ttft = [r["ttft_ms"] for r in records]
            tpot = [(r["finished_ms"] - r["first_token_ms"])
                    / (r["tokens"] - 1) for r in records if r["tokens"] > 1]
            tokens = sum(r["tokens"] for r in records)
            span_ms = max(r["finished_ms"] for r in records) - \
                min(r["submitted_ms"] for r in records)
            check(len(records) == n_req and all(np.isfinite(ttft))
                  and all(np.isfinite(tpot)),
                  f"{phase} {mode}: the timelines miss a request")
            emit({"phase": phase + "_reading", "frontend": mode,
                  "ttft_ms_p50": float(np.percentile(ttft, 50)),
                  "ttft_ms_p95": float(np.percentile(ttft, 95)),
                  "tpot_ms_p50": float(np.percentile(tpot, 50)),
                  "tokens_per_s": tokens / (span_ms / 1e3),
                  "tokens": tokens, "span_ms": span_ms, "nvidia_smi": smi})
            add_counts(counts_all, counts)
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
    graph_ms = r["graph_device_ms"]
    x = torch.randn(SERVE_SLOTS, 1, cfg.d_model, device=engine.device).to(
        DTYPES[cfg.dtype])
    layer = engine.model.groups[0]["l0"]["ffn"]
    moe_ms = cuda_ms(torch, lambda: moe.moe_apply(layer, cfg, x),
                     profile=False)[0]

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
    COST_STEPS.append(tick_cost(
        "granite_moe_3b_a800m captured paged tick, 4 slots", "moe_tick",
        engine, "paged", graph_ms, weights + kv))


# ---------------------------------------------------------------------------
# phase 6 — the recurrent and hybrid stacks: xlstm_1_3b, and jamba's first
# two layers
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm_1_3b"
JAMBA_ARCH = "jamba_1_5_large_398b"
#: jamba is cut to its first two layers (attention + dense FFN, Mamba +
#: MoE FFN), which hold every kind of layer it has
JAMBA_DEPTH = 2
#: the xlstm serve workload: 8 requests of 48-96 tokens, 24 new tokens
#: each, 4 slots, chunks of 32, speculation of 4 with state stacks capped
#: at 8 positions
STATE_MAX_LEN = 256
#: the depth of xlstm_serve's f32 exactness check: one layer group
XLSTM_F32_DEPTH = 8
#: depth of xlstm_serve's forced preemptions (cut from 48)
XLSTM_PREEMPT_DEPTH = 8
#: depth of xlstm_serve's captured-against-eager run (cut from 48)
XLSTM_SERVE_DEPTH = 12
#: depth of xlstm_serve's ticks and of train_recurrent's bf16 step (cut
#: from 48 to three layer groups: the script's time limit)
XLSTM_TICK_DEPTH = 24
STATE_CHUNK = 32
STATE_NEW = 24
STATE_PROMPT = (48, 96)
STATE_SPEC_WINDOW = 8
#: recurrent_rows: tokens fed to each layer, in chunks of ROWS_CHUNK (the
#: widest row count at which bf16 products were measured row-invariant)
ROWS_TOKENS = 64
ROWS_CHUNK = 32
#: where these phases put their own tensors
DEVICE = "cuda"


def xlstm_config():
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM_ARCH)
    kinds = cfg.layer_kinds()
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, kinds.count("mlstm"),
           kinds.count("slstm"), cfg.padded_vocab)
          == (48, 2048, 4, 42, 6, 51200), f"{XLSTM_ARCH} is not at full "
                                          f"width and depth")
    return cfg


def jamba_config():
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA_ARCH)
    check((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.num_experts, cfg.num_experts_per_tok, cfg.d_inner,
           cfg.ssm_state_dim, cfg.padded_vocab)
          == (8192, 64, 8, 128, 24576, 16, 2, 16384, 16, 65536),
          f"{JAMBA_ARCH} is not at full width")
    cfg = dataclasses.replace(cfg, num_layers=JAMBA_DEPTH)
    check(list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
          == [("attn", "dense"), ("mamba", "moe")],
          f"{JAMBA_ARCH}'s first two layers")
    return cfg


def tick_weight_bytes(engine, rows):
    """The weight bytes a tick of ``rows`` tokens reads: every parameter
    once, but of an untied embedding table only the rows it looks up (a
    tied one is the LM head as well, read whole), and none of the
    multi-token prediction head's or an encoder's, which no tick runs."""
    total = 0
    for name, p in engine.model.named_parameters():
        if name.startswith(("mtp.", "encoder.")):
            continue
        if name == "embed.embedding" and not engine.cfg.tie_embeddings:
            total += rows * p.shape[-1] * p.element_size()
        else:
            total += p.numel() * p.element_size()
    return total


def tree_bytes(tree, keep=lambda path: True):
    from repro_torch.models.params import flatten
    return sum(a.numel() * a.element_size()
               for path, a in flatten(tree).items() if keep(path))


# ---- recurrent_rows --------------------------------------------------------

def mixer_layer(torch, kind, dtype):
    """(cfg, params, window) of one full-width layer's mixer of ``kind``
    (mlstm and slstm from xlstm_1_3b, mamba from jamba), random weights
    from the seed."""
    from repro_torch.models import mamba, xlstm
    from repro_torch.models.params import init_params
    cfg = jamba_config() if kind == "mamba" else xlstm_config()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    template, window, zero = {
        "mlstm": (xlstm.mlstm_template, xlstm.mlstm_window,
                  xlstm.mlstm_cache),
        "slstm": (xlstm.slstm_template, xlstm.slstm_window,
                  xlstm.slstm_cache),
        "mamba": (mamba.mamba_template, mamba.mamba_window,
                  mamba.mamba_cache)}[kind]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(template(cfg), gen, dtype, DEVICE)
    return cfg, params, window, zero


def check_mixer_rows(torch, kind, dtype):
    """One layer of ``kind`` at 4 rows: its live state is that of 16
    random tokens from the zero state.  (1) Each row alone equals its row
    of the batch, bitwise, at a decode call and at a 5-token window with
    stacks.  (2) Row 0 fed ROWS_TOKENS tokens as chunks of ROWS_CHUNK
    (with stacks) and as one decode call per token: the outputs, the
    final states and every stack entry against the state after the
    decode call at its position, bitwise.  (3) A decode call committed
    under a mask of rows 0 and 2 leaves rows 1 and 3 as they were,
    bitwise.  Read beside them: a ROWS_TOKENS-token window against the
    chunks (its products have more rows than were measured).  Returns
    the readings."""
    from repro_torch.models.params import DTYPES
    from repro_torch.models.transformer import commit_state
    cfg, p, win, zero = mixer_layer(torch, kind, dtype)
    dt = DTYPES[dtype]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    x = torch.randn(4, ROWS_TOKENS, cfg.d_model, device=DEVICE,
                    generator=gen).to(dt)
    x0 = torch.randn(4, 16, cfg.d_model, device=DEVICE, generator=gen).to(dt)
    _, live = win(p, cfg, x0, zero(cfg, 4, DEVICE))

    def clone(st, rows=slice(None)):
        return {k: v[rows].clone() for k, v in st.items()}

    def stacks(B, L):
        return {k: torch.zeros((B, L) + v.shape[1:], dtype=v.dtype,
                               device=DEVICE) for k, v in live.items()}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    out = {}
    for L in (1, VERIFY_WIDTH + 1):
        stk = stacks(4, L) if L > 1 else None
        y, fin = win(p, cfg, x[:, :L], clone(live), stk)
        ok = True
        for b in range(4):
            s1 = stacks(1, L) if L > 1 else None
            y1, f1 = win(p, cfg, x[b:b + 1, :L], clone(live, slice(b, b + 1)),
                         s1)
            ok = ok and torch.equal(y1, y[b:b + 1]) and same(
                f1, clone(fin, slice(b, b + 1))) and (
                s1 is None or same(s1, clone(stk, slice(b, b + 1))))
        out[f"rows_alone_L{L}"] = ok

    # row 0: chunks with stacks, then decode calls against them
    one = clone(live, slice(0, 1))
    ys, st, chunk_stacks = [], clone(one), []
    for a in range(0, ROWS_TOKENS, ROWS_CHUNK):
        stk = stacks(1, ROWS_CHUNK)
        y, st = win(p, cfg, x[:1, a:a + ROWS_CHUNK], st, stk)
        ys.append(y)
        chunk_stacks.append(stk)
    y_chunks, st_chunks = torch.cat(ys, 1), st
    st, stack_equal, y_equal = clone(one), 0, True
    for t in range(ROWS_TOKENS):
        y, st = win(p, cfg, x[:1, t:t + 1], st)
        y_equal = y_equal and torch.equal(y, y_chunks[:, t:t + 1])
        entry = {k: v[:, t % ROWS_CHUNK]
                 for k, v in chunk_stacks[t // ROWS_CHUNK].items()}
        stack_equal += same(st, entry)
    out["chunks_final_equal_decode_calls"] = same(st, st_chunks)
    out["chunks_y_equal_decode_calls"] = y_equal
    out["stack_entries_equal_decode_states"] = stack_equal
    y_whole, st_whole = win(p, cfg, x[:1], clone(one))
    out["window64_equal_chunks"] = bool(torch.equal(y_whole, y_chunks)
                                        and same(st_whole, st_chunks))

    # masked commit
    state = clone(live)
    _, new = win(p, cfg, x[:, :1], state)
    mask = torch.tensor([True, False, True, False], device=DEVICE)
    commit_state(state, new, mask)
    out["masked_rows_untouched"] = same(clone(state, slice(1, None, 2)),
                                        clone(live, slice(1, None, 2)))
    out["unmasked_rows_committed"] = same(clone(state, slice(0, None, 2)),
                                          clone(new, slice(0, None, 2)))
    return out


#: (name, K, N, dtypes) of the recurrent stacks' products
RECURRENT_GEMMS = (("mlstm up_proj", 2048, 8192, ("bfloat16",)),
                   ("mlstm head", 1024, 1024, ("bfloat16",)),
                   ("mlstm gate", 4096, 4, ("bfloat16",)),
                   ("mlstm down_proj", 4096, 2048, ("bfloat16",)),
                   ("slstm w_x", 2048, 8192, ("bfloat16",)),
                   ("slstm rec", 512, 2048, ("float32",)),
                   ("mamba in_proj", 8192, 32768, ("bfloat16",)),
                   ("mamba x_proj", 16384, 544, ("bfloat16",)),
                   ("mamba dt_proj", 512, 16384, ("bfloat16",)),
                   ("mamba out_proj", 16384, 8192, ("bfloat16",)))
#: row counts of a decode tick (1, 4), a verify tick (5, 20), a chunk (32)
#: and a whole prompt (64, 96)
RECURRENT_WIDTHS = (1, 4, 5, 20, 32, 64, 96)


def recurrent_gemm_widths(torch):
    """For each product of RECURRENT_GEMMS: are the first rows of
    ``x[:M] @ W`` bitwise those of ``x[:4] @ W`` (read: cuBLAS picks its
    kernel by M), and the first rows of ``layers.linear(x[:M], W,
    blocked=True)``, the mixers' products, those at 4 rows (held: the
    width rule)?"""
    from repro_torch.models.layers import linear
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    for name, K, N, dtypes in RECURRENT_GEMMS:
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            x = torch.randn(max(RECURRENT_WIDTHS), K, device=DEVICE,
                            generator=g).to(dt)
            w = torch.randn(K, N, device=DEVICE, generator=g).to(dt)
            raw, ruled = {}, {}
            for M in RECURRENT_WIDTHS:
                n = min(M, 4)
                raw[M] = bool(torch.equal((x[:M] @ w)[:n], (x[:4] @ w)[:n]))
                ruled[M] = bool(torch.equal(
                    linear(x[:M], w, blocked=True)[:n],
                    linear(x[:4], w, blocked=True)[:n]))
            emit({"phase": "gemm_width", "gemm": name, "K": K, "N": N,
                  "dtype": dtype, "raw_rows_equal_to_width_4": raw,
                  "linear_rows_equal_to_width_4": ruled})
            check(all(ruled.values()), f"gemm_width {name} {dtype}: "
                                       f"linear's rows depend on M")


def phase_recurrent_rows(torch):
    """The width rule at the recurrent stacks' products
    (``recurrent_gemm_widths``), then ``check_mixer_rows`` for one
    full-width mLSTM, sLSTM and Mamba layer, in bf16 (held bitwise) and
    f32 (read)."""
    recurrent_gemm_widths(torch)
    for dtype in ("bfloat16", "float32"):
        for kind in ("mlstm", "slstm", "mamba"):
            r = check_mixer_rows(torch, kind, dtype)
            held = dtype == "bfloat16"
            emit({"phase": "recurrent_rows", "kind": kind, "dtype": dtype,
                  "held": held, "tokens": ROWS_TOKENS, "chunk": ROWS_CHUNK,
                  **r})
            if held:
                bad = [k for k, v in r.items() if k != "window64_equal_chunks"
                       and v is not True and v != ROWS_TOKENS]
                check(not bad, f"recurrent_rows {kind} {dtype}: {bad}")
            free_card(torch)


# ---- xlstm_main_path -------------------------------------------------------

def phase_xlstm_main_path(torch):
    """xlstm_1_3b at full width and depth in bf16 (random weights from
    the seed) through the engine's main path on the state layout
    (``drive_engine_path``): K1's launches held to the schedule; then the
    first tick against the plain path (the kernel path differs from it
    in K1 alone), as ``compare_first_tick`` holds minicpm_2b's; then the
    4-slot decode tick.  Returns the launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = xlstm_config()
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    run = drive_engine_path(torch, engine, cfg, rng, kind="state")
    emit({"phase": "xlstm_main_path", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params": sum(p.numel() for p in engine.model.parameters()),
          "dtype": cfg.dtype, "init_seconds": init_s,
          "path_seconds": run.seconds, "launches": run.counts,
          "expected_launches": run.expected, "generate": run.gen.tolist(),
          "verify": run.guess.tolist(),
          "graphs_captured": graph_count(engine)})
    check(run.counts == run.expected, f"xlstm_main_path: launch counts "
                                      f"{run.counts} != {run.expected}")
    plain_flags = RuntimeFlags(fused_rmsnorm=False)
    plain = LLMEngine(cfg, dict(engine.model.named_parameters()),
                      max_len=MAX_LEN, flags=plain_flags)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    w32 = {k: v.float() for k, v in engine.model.named_parameters()}
    p32 = LLMEngine(cfg32, w32, max_len=MAX_LEN, flags=plain_flags)
    cmp = compare_first_tick(torch, engine, plain, p32, run.groups[0], cfg)
    emit({"phase": "xlstm_main_vs_plain", **cmp})
    check(cmp["ok"], "xlstm: first-tick logits disagree with the plain path")
    del plain, p32, w32
    e2e = time_decode(torch, engine, run.backend, run.cache, run.last,
                      run.pos)
    emit({"phase": "xlstm_e2e_decode", **e2e})
    return run.counts


# ---- xlstm_serve -----------------------------------------------------------

def state_requests(vocab: int):
    """The xlstm serve workload's prompts: SERVE_REQUESTS random prompts
    of STATE_PROMPT tokens, from the seed."""
    import numpy as np
    rng = np.random.RandomState(SEED + 5)
    lo, hi = STATE_PROMPT
    return [rng.randint(0, vocab, int(n)).astype(np.int32)
            for n in rng.randint(lo, hi + 1, SERVE_REQUESTS)]


def state_backend():
    from repro_torch.serving import StateBackend
    return lambda e: StateBackend(e, SERVE_SLOTS,
                                  spec_window=STATE_SPEC_WINDOW)


def serve_state(torch, engine, requests, spec, hook=None):
    return serve(torch, engine, requests, 0, speculate_k=spec, hook=hook,
                 backend=state_backend(), max_new=STATE_NEW,
                 chunk=STATE_CHUNK)


def phase_xlstm_serve(torch, smi):
    """The xlstm serve workload through the Scheduler on a StateBackend
    at full width (bf16): on the first XLSTM_SERVE_DEPTH layers, captured
    steps against eager ones on the same weights (tokens bitwise,
    launches equal to the schedule, slabs back to 0); on the first
    XLSTM_TICK_DEPTH layers, the decode and the verify tick against their
    bounds (``state_ticks``); on the first XLSTM_PREEMPT_DEPTH layers,
    PREEMPTIONS requests preempted after streaming tokens
    (``ForcedPreemption``), once with speculation off (replayed through
    the masked decode) and once on (verify windows and the rewind of
    the row), each against the same run without preemption: tokens and
    slab rows bitwise; in f32 (the first layer group), the served tokens
    against per-request greedy under the top-2 gap rule.  Returns the
    launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = xlstm_config()
    requests = state_requests(cfg.vocab_size)
    emit({"phase": "xlstm_serve_workload", "prompt_lengths":
          [int(p.size) for p in requests], "max_len": STATE_MAX_LEN,
          "chunk": STATE_CHUNK, "new_tokens": STATE_NEW,
          "speculate_k": SERVE_SPEC, "spec_window": STATE_SPEC_WINDOW})
    # captured against eager on the first XLSTM_SERVE_DEPTH layers (the
    # eager token-by-token prefill of the full depth took ~45 s)
    cfg_s = dataclasses.replace(cfg, num_layers=XLSTM_SERVE_DEPTH)
    cap_s = LLMEngine(cfg_s, max_len=STATE_MAX_LEN, seed=SEED)
    eager = LLMEngine(cfg_s, dict(cap_s.model.named_parameters()),
                      max_len=STATE_MAX_LEN,
                      flags=RuntimeFlags(cuda_graphs=False))
    runs, counts_all = {}, {}

    for name, e in (("eager", eager), ("captured", cap_s)):
        got, stats, counts, wall = serve_state(torch, e, requests, SERVE_SPEC)
        want = expected_serve_launches(cfg_s, stats, "fused_flash_decode")
        emit({"phase": "xlstm_serve", "steps": name, "seconds": wall,
              "launches": counts, "expected_launches": want,
              "graphs_captured": graph_count(e),
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "spec_drafted", "spec_accepted",
                  "completed", "state_slabs_peak", "state_slabs_in_use",
                  "admit_seconds", "step_seconds")}})
        check(counts == want, f"xlstm_serve {name}: launch counts {counts} "
                              f"!= {want}")
        check(stats["completed"] == len(requests)
              and all(got[i].shape == (STATE_NEW,) for i in got),
              f"xlstm_serve {name}: not every request completed")
        check(stats["state_slabs_in_use"] == 0,
              f"xlstm_serve {name}: slabs held after the run")
        runs[name] = got
        add_counts(counts_all, counts)
    equal = sum(bool(np.array_equal(runs["captured"][i], runs["eager"][i]))
                for i in runs["eager"])
    emit({"phase": "xlstm_serve_compare", "requests": len(requests),
          "captured_bitwise_equal_to_eager": equal})
    check(equal == len(requests), "xlstm_serve: captured tokens differ "
                                  "from eager")
    del eager, cap_s
    free_card(torch)
    # the ticks on the first XLSTM_TICK_DEPTH layers, and the f32 check's
    # weights
    cap = LLMEngine(dataclasses.replace(cfg, num_layers=XLSTM_TICK_DEPTH),
                    max_len=STATE_MAX_LEN, seed=SEED)

    # ---- the ticks against their bounds ---------------------------------
    for spec in (0, SERVE_SPEC):
        emit({"phase": "xlstm_tick", **state_ticks(torch, cap, requests,
                                                   spec), "nvidia_smi": smi})
    # the f32 check's weights: the first layer group (XLSTM_F32_DEPTH
    # layers: 7 mLSTM + 1 sLSTM), which keeps the run within its budget
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=XLSTM_F32_DEPTH)
    w32 = {k: (v[:1] if k.startswith("blocks.") else v).float()
           for k, v in cap.model.named_parameters()}
    del cap
    free_card(torch)

    # ---- forced preemptions, decode replay then verify replay, on the
    # first XLSTM_PREEMPT_DEPTH layers (one group: 7 mLSTM + 1 sLSTM,
    # weights from the seed; the full depth took 76 s of the run's
    # budget, 12 layers 24 s)
    pre = LLMEngine(dataclasses.replace(cfg, num_layers=XLSTM_PREEMPT_DEPTH),
                    max_len=STATE_MAX_LEN, seed=SEED)
    for spec in (0, SERVE_SPEC):
        want = serve_state(torch, pre, requests, spec)[0]
        forced = ForcedPreemption(torch)
        got, stats, counts, _ = serve_state(torch, pre, requests, spec,
                                            hook=forced.install)
        check_forced(f"speculate_k={spec}", forced, stats, got, want, counts,
                     expected_serve_launches(pre.cfg, stats,
                                             "fused_flash_decode"),
                     phase="xlstm_preempt")
        check(stats["state_slabs_in_use"] == 0,
              "xlstm_preempt: slabs held after the run")
        add_counts(counts_all, counts)
    del pre
    free_card(torch)

    # ---- exactness in f32 against per-request greedy ---------------------
    e32 = LLMEngine(cfg32, w32, max_len=STATE_MAX_LEN)
    got, stats, _, _ = serve_state(torch, e32, requests, SERVE_SPEC)
    exact = compare_with_greedy(torch, e32, requests, got,
                                max_len=STATE_MAX_LEN, new=STATE_NEW)
    emit({"phase": "xlstm_serve_f32_exact",
          "spec_steps": stats["spec_steps"], **exact})
    check(exact["rows_compared"] > 0, "xlstm f32 exactness: no row compared")
    check(exact["mismatches"] == 0, "xlstm f32 exactness: a served token "
                                    "differs from the greedy reference's")
    del e32, w32
    return counts_all


def state_ticks(torch, engine, requests, spec, ticks=12, profiled=2):
    """The captured tick of the StateBackend at 4 active slots (the first
    four xlstm requests): decode (``spec`` 0) or a verify window of
    1 + ``spec`` with the stacks and a rewind per row.  3 ticks of
    warm-up, ``ticks`` read: median, p10 and p90 wall ms; the captured
    graph's device ms by CUDA events over queued replays and its busy
    share; the profiler's kernel sum; one ``state_rewind``'s device ms;
    the graphs' pool bytes and the stacks' bytes.  The bound reads every
    weight once (of the untied embedding only the window's rows:
    ``tick_weight_bytes``) and each row's state once and writes it
    once; a verify tick also writes the stacks (the state after each
    window position)."""
    import numpy as np
    from repro_torch.serving import Scheduler
    be = state_backend()(engine)
    longest = max(p.size for p in requests[:SERVE_SLOTS])
    sched = Scheduler(be, max_new_tokens=STATE_MAX_LEN - longest - 1,
                      chunk_size=STATE_CHUNK, speculate_k=spec,
                      draft_fn=always_draft)
    for i, p in enumerate(requests[:SERVE_SLOTS]):
        sched.submit({"tokens": p, "id": i})
    while sched.ingesting or sched.waiting:
        sched.admit()
    check(sched.active == SERVE_SLOTS, "state tick: slots not all active")
    for _ in range(3):
        sched.step()
    times = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        sched.step()
        times.append((time.perf_counter() - t0) * 1e3)
    per = profiled_ms(torch, sched.step, profiled)
    check(sched.active == SERVE_SLOTS, "state tick: a request finished")
    graph_ms = captured_ms(torch, engine,
                           "verify_stacks" if spec else "decode", "state")
    med = statistics.median(times)
    model = engine.model
    slabs = tree_bytes(be.cache,
                       lambda path: model.layer_kind_of_path(path) != "attn")
    weights = tick_weight_bytes(engine, SERVE_SLOTS * (spec + 1))
    out = {"speculate_k": spec, "slots": SERVE_SLOTS, "ticks": ticks,
           "ms_median": med, "ms_p10": float(np.percentile(times, 10)),
           "ms_p90": float(np.percentile(times, 90)), "ms_min": min(times),
           "graph_device_ms": graph_ms, "graph_busy_share": graph_ms / med,
           **device_share(per, med, ("rmsnorm_kernel",)),
           "weight_bytes": weights, "slab_bytes": slabs,
           "graphs_captured": graph_count(engine)}
    bytes_ = weights + 2 * slabs
    if spec:
        stack_bytes = tree_bytes(engine._stacks["state", SERVE_SLOTS])
        view = engine._stack_views("state", be.cache, SERVE_SLOTS, spec + 1)
        rewind_ms = cuda_ms(torch, lambda: engine.state_rewind(
            be.cache, view, 0, 2), profile=False)[0]
        bytes_ += tree_bytes(view)
        out.update(stack_bytes=stack_bytes, rewind_ms=rewind_ms,
                   rewind_ms_per_tick=SERVE_SLOTS * rewind_ms)
    out.update(bound_ms=bytes_ / HBM_BPS * 1e3, bound_bytes=bytes_,
               bound_by="bytes",
               median_over_bound=med / (bytes_ / HBM_BPS * 1e3))
    return out


def captured_ms(torch, engine, step, kind):
    """Device ms of one replay of the engine's newest captured ``step``
    graph on layout ``kind`` at SERVE_SLOTS slots, by CUDA events over
    queued replays."""
    graphs = [cs for key, cs in engine.graphs.steps.items()
              if key[:2] == (step, kind) and key[3] == SERVE_SLOTS]
    check(len(graphs) >= 1, f"no captured {step} graph on {kind}")
    # a verify graph holds ~10^4 kernels: few replays keep the profiler's
    # pass over them short
    return cuda_ms(torch, graphs[-1].graph.replay, reps=5, profile=False)[0]


def phase_xlstm_graph_serve(torch, smi):
    """xlstm_1_3b at full width served by the port's launcher on the
    state layout (``launcher_serve``).  Returns the launch counts."""
    argv = ["--arch", XLSTM_ARCH, "--no-reduced", "--backend", "state",
            "--requests", "16", "--clients", "4", "--max-new-tokens", "32"]
    return launcher_serve(torch, smi, argv, xlstm_config(),
                          "fused_flash_decode", "xlstm_graph_serve")


# ---- hybrid_serve ----------------------------------------------------------

def hybrid_backend(blocks):
    from repro_torch.serving import HybridBackend
    return lambda e: HybridBackend(e, SERVE_SLOTS, num_blocks=blocks,
                                   block_size=SERVE_BLOCK,
                                   spec_window=STATE_SPEC_WINDOW)


class SlabWatch:
    """Wraps a scheduler's ``admit`` and ``step``: after each, the slabs
    held must be the occupied slots' and the pool's invariants hold; at
    the end slabs and blocks are back to 0 (``done``)."""

    def __init__(self):
        self.calls = self.faults = 0

    def install(self, sched):
        self.sched = sched
        for name in ("admit", "step"):
            call = getattr(sched, name)

            def watched(call=call):
                out = call()
                self.calls += 1
                held = sum(r is not None for r in sched.slots)
                self.faults += sched.backend.slabs_in_use != held
                sched.pool.check_invariants()
                return out

            setattr(sched, name, watched)

    def done(self):
        return (self.faults == 0 and self.sched.backend.slabs_in_use == 0
                and self.sched.pool.blocks_in_use == 0)


def phase_hybrid_serve(torch, smi):
    """jamba's first two layers at full width (bf16, random weights from
    the seed) on the serve workload through the Scheduler on a
    HybridBackend: on the pressure arena (sized as ``pressure_blocks``
    without prefix sharing) with speculation, captured against eager
    (tokens bitwise; launches of K1, K2 and K3 equal to the schedule;
    pressure preemptions, with slabs and blocks freed together at every
    tick and both back to 0), then with K4 (``fused_split_k``); on a
    roomy arena without speculation against a StateBackend, whose
    attention keeps slot rows (tokens bitwise), and with PREEMPTIONS
    requests preempted after streaming tokens (``check_forced``: tokens,
    K/V and slab rows bitwise); then the captured decode tick against
    its bound (``tick_weight_bytes``, the rows' K/V and their state).
    Returns the launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, StateBackend
    cfg = jamba_config()
    requests = serve_requests(cfg.vocab_size)
    blocks, four, three = pressure_blocks(requests, shared=False)
    emit({"phase": "hybrid_workload", "arch": cfg.name,
          "layers": cfg.num_layers, "prompt_lengths":
          [int(p.size) for p in requests], "num_blocks": blocks,
          "blocks_four_prompts": four, "blocks_three_ends": three})
    t0 = time.perf_counter()
    cap = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = dict(cap.model.named_parameters())
    counts_all, runs = {}, {}

    engines = (("eager", LLMEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                   flags=RuntimeFlags(cuda_graphs=False)),
                "fused_flash_decode"),
               ("captured", cap, "fused_flash_decode"),
               ("split_k", LLMEngine(cfg, params, max_len=SERVE_MAX_LEN,
                                     flags=RuntimeFlags(fused_split_k=True)),
                "fused_flash_decode_splitk"))
    for name, e, attend in engines:
        watch = SlabWatch()
        got, stats, counts, wall = serve(torch, e, requests, 0,
                                         backend=hybrid_backend(blocks),
                                         hook=watch.install)
        want = expected_serve_launches(cfg, stats, attend)
        emit({"phase": "hybrid_serve", "steps": name, "seconds": wall,
              "init_seconds": init_s, "params": sum(
                  p.numel() for p in params.values()),
              "launches": counts, "expected_launches": want,
              "graphs_captured": graph_count(e),
              "slab_watch": {"calls": watch.calls, "faults": watch.faults},
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "spec_drafted", "spec_accepted",
                  "preemptions", "replayed_tokens", "replay_steps",
                  "completed", "state_slabs_peak", "blocks_peak",
                  "admit_seconds", "step_seconds")}})
        check(counts == want, f"hybrid_serve {name}: launch counts {counts} "
                              f"!= {want}")
        check(stats["completed"] == len(requests)
              and all(got[i].shape == (SERVE_NEW,) for i in got),
              f"hybrid_serve {name}: not every request completed")
        check(stats["preemptions"] > 0, f"hybrid_serve {name}: no "
                                        f"preemption")
        check(watch.done(), f"hybrid_serve {name}: slabs and blocks were "
                            f"not freed together")
        runs[name] = got
        add_counts(counts_all, counts)
    del engines
    free_card(torch)
    equal = sum(bool(np.array_equal(runs["captured"][i], runs["eager"][i]))
                for i in runs["eager"])
    emit({"phase": "hybrid_serve_compare", "requests": len(requests),
          "captured_bitwise_equal_to_eager": equal})
    check(equal == len(requests), "hybrid_serve: captured tokens differ "
                                  "from eager")

    # ---- the layout check: hybrid against state (slot-row attention) ----
    layouts = {}
    for kind, make in (("hybrid", hybrid_backend(ROOMY_BLOCKS)),
                       ("state", lambda e: StateBackend(e, SERVE_SLOTS))):
        got, stats, counts, _ = serve(torch, cap, requests, 0, backend=make,
                                      speculate_k=0)
        want = expected_serve_launches(cfg, stats, "fused_flash_decode")
        check(counts == want, f"hybrid_serve_layouts {kind}: launch counts "
                              f"{counts} != {want}")
        check(stats["completed"] == len(requests)
              and stats["preemptions"] == 0,
              f"hybrid_serve_layouts {kind}: a request did not complete or "
              f"was preempted")
        layouts[kind] = got
        add_counts(counts_all, counts)
    equal = sum(bool(np.array_equal(layouts["hybrid"][i], layouts["state"][i]))
                for i in layouts["hybrid"])
    emit({"phase": "hybrid_serve_layouts", "requests": len(requests),
          "speculate_k": 0, "bitwise_equal": equal})
    check(equal == len(requests), "hybrid_serve_layouts: hybrid and state "
                                  "tokens are not bitwise equal")

    # ---- forced preemptions mid-decode, replayed through the decode step -
    forced = ForcedPreemption(torch)
    got, stats, counts, _ = serve(torch, cap, requests, 0,
                                  backend=hybrid_backend(ROOMY_BLOCKS),
                                  speculate_k=0, hook=forced.install)
    check_forced("hybrid", forced, stats, got, layouts["hybrid"], counts,
                 expected_serve_launches(cfg, stats, "fused_flash_decode"),
                 phase="hybrid_preempt_decode")
    add_counts(counts_all, counts)

    # ---- the decode tick against its bound -------------------------------
    r = layout_ticks(torch, cap, requests, hybrid_backend(ROOMY_BLOCKS))
    keys = sum(p.size + 3 + r["ticks"] // 2
               for p in requests[:SERVE_SLOTS])
    kv = 2 * keys * cfg.num_kv_heads * cfg.head_dim * 2
    weights = tick_weight_bytes(cap, SERVE_SLOTS)
    bytes_ = weights + kv + 2 * r["slab_bytes"]
    emit({"phase": "hybrid_tick", **r, "weight_bytes": weights,
          "bound_bytes": bytes_, "bound_ms": bytes_ / HBM_BPS * 1e3,
          "bound_by": "bytes",
          "median_over_bound": r["ms_median"] / (bytes_ / HBM_BPS * 1e3),
          "nvidia_smi": smi})
    return counts_all


def layout_ticks(torch, engine, requests, make, ticks=20, profiled=3):
    """The captured decode tick at 4 active slots (the first four
    requests, no speculation) on ``make(engine)``'s layout: 3 of warm-up,
    ``ticks`` read; median, p10, p90 wall ms, the captured graph's device
    ms by CUDA events and its busy share, the profiler's share, and the
    recurrent slabs' bytes."""
    import numpy as np
    from repro_torch.serving import Scheduler
    be = make(engine)
    sched = Scheduler(be, max_new_tokens=4 + 3 + ticks + profiled,
                      chunk_size=SERVE_CHUNK)
    for i, p in enumerate(requests[:SERVE_SLOTS]):
        sched.submit({"tokens": p, "id": i})
    while sched.ingesting or sched.waiting:
        sched.admit()
    check(sched.active == SERVE_SLOTS, "tick timing: slots not all active")
    for _ in range(3):
        sched.step()
    times = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        sched.step()
        times.append((time.perf_counter() - t0) * 1e3)
    per = profiled_ms(torch, sched.step, profiled)
    graph_ms = captured_ms(torch, engine, "decode", be.kind)
    med = statistics.median(times)
    model = engine.model
    return {"layout": be.kind, "slots": SERVE_SLOTS, "ticks": ticks,
            "ms_median": med, "ms_p10": float(np.percentile(times, 10)),
            "ms_p90": float(np.percentile(times, 90)), "ms_min": min(times),
            "tokens_per_s": SERVE_SLOTS / (med / 1e3),
            "graph_device_ms": graph_ms, "graph_busy_share": graph_ms / med,
            **device_share(per, med, ("rmsnorm_kernel",
                                      "fused_decode_mma_kernel")),
            "slab_bytes": tree_bytes(
                be.cache, lambda path: model.layer_kind_of_path(path)
                != "attn"),
            "graphs_captured": graph_count(engine)}


# ---------------------------------------------------------------------------
# phase 7 — deepseek_v3_671b: MLA, its dense head and MTP, at full width
# ---------------------------------------------------------------------------

DEEPSEEK_ARCH = "deepseek_v3_671b"
#: deepseek is cut to two layers, its first (dense) one and one MoE layer,
#: which hold every kind of layer it has: MLA + the dense FFN (18432), and
#: MLA + 256 routed experts top-8 + 1 shared.  Its own first_k_dense is 3,
#: so the cut also sets it to 1
DEEPSEEK_DEPTH = 2
#: mla_layer_vs_cpu: tokens of the prefill and of the extend's prefix and
#: suffix, the slot rows' length (the paged table's P x block size), and
#: the outputs' limit on the card against the CPU's f32, relative to the
#: output's scale (bf16 rounds weights, inputs and the products' outputs)
MLA_TOKENS = 256
MLA_ROWS_LEN = 512
MLA_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the rows' positions of mla_layer_vs_cpu's decode windows (the last
#: row's 5-token window ends at the row's last position but one)
MLA_POSITIONS = (100, 257, 384, MLA_ROWS_LEN - 6)


def deepseek_config():
    from repro_torch.configs import get_config
    cfg = get_config(DEEPSEEK_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.q_lora_rank,
           cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
           cfg.v_head_dim, cfg.d_ff, cfg.dense_d_ff, cfg.num_experts,
           cfg.num_experts_per_tok, cfg.num_shared_experts,
           cfg.first_k_dense, cfg.mtp_depth, cfg.padded_vocab)
          == (61, 7168, 128, 1536, 512, 128, 64, 128, 2048, 18432, 256, 8,
              1, 3, 1, 131072),
          f"{DEEPSEEK_ARCH} is not at full width")
    cfg = dataclasses.replace(cfg, num_layers=DEEPSEEK_DEPTH,
                              first_k_dense=1)
    check(list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
          == [("attn", "dense"), ("attn", "moe")],
          f"{DEEPSEEK_ARCH}'s two layers")
    return cfg


def phase_mla_layer_vs_cpu(torch):
    """One full-width MLA layer (random weights from the seed) on the
    card in bf16 and in f32 against the port's CPU f32 on the same
    weights: a MLA_TOKENS-token prefill (output and latents), an extend
    of MLA_TOKENS after a prefix of as many, slot decode at S' = 1 and 5
    over MLA_ROWS_LEN-position rows of 4 slots, and paged decode at
    S' = 1 and 5 over the same rows in a shuffled arena of SERVE_BLOCK-
    token blocks: each within MLA_TOL of the CPU output's scale, and on
    the card paged bitwise equal to slot (the slot rows' length is the
    table's P x block size)."""
    from repro_torch.models import mla
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.transformer import DEFAULT_FLAGS
    cfg = deepseek_config()
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(mla.mla_template(cfg), gen, "float32", "cpu")
    S, T, bs = MLA_TOKENS, MLA_ROWS_LEN, SERVE_BLOCK
    B, P = SERVE_SLOTS, MLA_ROWS_LEN // SERVE_BLOCK
    x = torch.randn(1, 2 * S, cfg.d_model, generator=gen)
    pos = torch.arange(2 * S)[None]
    rows = {"c_kv": torch.randn(B, T, cfg.kv_lora_rank, generator=gen),
            "k_rope": torch.randn(B, T, cfg.qk_rope_head_dim,
                                  generator=gen)}
    win = {n: torch.randn(B, n, cfg.d_model, generator=gen) for n in (1, 5)}
    at = torch.tensor(MLA_POSITIONS, dtype=torch.int32)
    tables = (1 + torch.randperm(B * P, generator=gen)).view(B, P).int()

    def run(dev, dtype):
        """Every case's output on ``dev`` in ``dtype``, as CPU f32."""
        dt = getattr(torch, dtype)
        to = (lambda t: t.to(dev, dt) if t.is_floating_point()
              else t.to(dev))
        p = tree_map(to, params)
        out = {}
        y, c_kv, k_rope = mla.mla_forward(p, cfg, to(x[:, :S]),
                                          to(pos[:, :S]), DEFAULT_FLAGS)
        out["prefill"], out["prefill_c_kv"] = y, c_kv
        y, _ = mla.prefill_extend_into_cache(
            p, cfg, to(x[:, S:]), to(pos[:, S:]),
            {"c_kv": c_kv, "k_rope": k_rope}, S, DEFAULT_FLAGS)
        out["extend"] = y
        for n, xw in win.items():
            slot = tree_map(to, rows)
            out[f"slot_decode_{n}"] = mla.slot_decode(
                p, cfg, to(xw), slot, to(at), DEFAULT_FLAGS)
            arena = {k: torch.zeros((1 + B * P, bs) + a.shape[2:],
                                    device=dev, dtype=dt)
                     for k, a in rows.items()}
            for k, a in arena.items():
                a[tables.view(-1).long().to(dev)] = to(rows[k]).view(
                    B * P, bs, -1)
            out[f"paged_decode_{n}"] = mla.paged_decode(
                p, cfg, to(xw), arena, to(at), to(tables), DEFAULT_FLAGS)
        return out

    want = run("cpu", "float32")
    for dtype in ("float32", "bfloat16"):
        got = run(DEVICE, dtype)
        res = {}
        for name, w in want.items():
            g = got[name].float().cpu()
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            res[name] = {"max_abs_err": err, "scale": scale,
                         "ok": bool(torch.isfinite(g).all())
                         and err <= MLA_TOL[dtype] * scale}
        paged_eq = {n: torch.equal(got[f"paged_decode_{n}"],
                                   got[f"slot_decode_{n}"]) for n in win}
        emit({"phase": "mla_layer_vs_cpu", "dtype": dtype,
              "tokens": S, "rows_len": T, "block_size": bs,
              "positions": list(MLA_POSITIONS), "tol_rel": MLA_TOL[dtype],
              "cases": res, "paged_bitwise_slot": paged_eq})
        for name, r in res.items():
            check(r["ok"], f"mla_layer_vs_cpu {dtype} {name}: {r}")
        check(all(paged_eq.values()), f"mla_layer_vs_cpu {dtype}: paged "
                                      f"decode differs from slot decode")
        del got


def phase_mla_main_path(torch):
    """deepseek's two layers at full width in bf16 (random weights from
    the seed) through the engine's main path (``drive_engine_path``: K1
    launches held to the schedule, four a layer and the final norm; the
    decode and verify steps captured), then the first tick against the
    plain path (``fused_rmsnorm`` off, the same weights) on the rows
    routed alike (``compare_moe_first_tick``).  Returns the launch
    counts."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = deepseek_config()
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    run = drive_engine_path(torch, engine, cfg, np.random.RandomState(SEED))
    steps = captured_steps(engine)
    emit({"phase": "mla_main_path", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "experts": cfg.num_experts,
          "padded_experts": moe.padded_experts(cfg),
          "top_k": cfg.num_experts_per_tok, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in engine.model.parameters()),
          "norms_per_pass": schedule(cfg)[0], "init_seconds": init_s,
          "path_seconds": run.seconds, "launches": run.counts,
          "expected_launches": run.expected, "generate": run.gen.tolist(),
          "verify": run.guess.tolist(), "captured_steps": steps,
          "graphs_captured": graph_count(engine)})
    check(run.counts == run.expected, f"mla_main_path: launch counts "
                                      f"{run.counts} != {run.expected}")
    check({"generate", "decode", "verify"} <= set(steps),
          f"mla_main_path: captured steps {steps}")
    plain = LLMEngine(cfg, dict(engine.model.named_parameters()),
                      max_len=MAX_LEN, flags=RuntimeFlags(fused_rmsnorm=False))
    cmp = compare_moe_first_tick(torch, engine, plain, run.groups[0], 0.1,
                                 True)
    emit({"phase": "mla_main_vs_plain", "dtype": cfg.dtype, **cmp})
    check(cmp["ok"], "mla_main_vs_plain: logits or tokens disagree with "
                     "the plain path")
    return run.counts


def captured_steps(engine):
    """The names of the engine's captured steps (``generate``,
    ``decode``, ``verify``, ...)."""
    return sorted({key[0] for key in engine.graphs.steps})


def phase_mla_serve(torch, smi):
    """deepseek's two layers at full width in bf16 on the serve
    workload through the Scheduler: on a PagedBackend (the pressure
    arena, prefix sharing, chunk 256, speculate 4) captured against
    eager (tokens bitwise, K1 launches equal to the schedule, the drops
    of the first 256-row chunk and the first verify tick of 20 counted
    by ``RouteRecorder``); on a roomy PagedBackend and a SlotBackend
    with no speculation and no sharing (tokens bitwise); with
    PREEMPTIONS requests preempted after streaming tokens, replayed
    through the decode step with speculation off (``check_forced``);
    the captured decode tick against its bounds (``mla_tick``); and an
    f32 engine (its own weights from the seed) on the pressure arena
    without speculation against per-request greedy prefilled in the
    same chunks, under the top-2-gap rule.  Returns the launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = deepseek_config()
    requests = serve_requests(cfg.vocab_size)
    blocks, four, three = pressure_blocks(requests)
    cap = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    eager = LLMEngine(cfg, dict(cap.model.named_parameters()),
                      max_len=SERVE_MAX_LEN,
                      flags=RuntimeFlags(cuda_graphs=False))
    verify_n = SERVE_SLOTS * (SERVE_SPEC + 1)
    runs, counts_all = {}, {}

    for name, e in (("eager", eager), ("captured", cap)):
        with RouteRecorder(lambda n: n in (SERVE_CHUNK, verify_n)) \
                if name == "eager" else contextlib.nullcontext() as rec:
            got, stats, counts, wall = serve(torch, e, requests, blocks)
        want = expected_serve_launches(cfg, stats, "fused_flash_decode")
        emit({"phase": "mla_serve", "steps": name, "num_blocks": blocks,
              "seconds": wall, "launches": counts,
              "expected_launches": want, "graphs_captured": graph_count(e),
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "spec_drafted", "spec_accepted",
                  "preemptions", "replayed_tokens", "shared_block_hits",
                  "completed", "admit_seconds", "step_seconds")}})
        check(counts == want, f"mla_serve {name}: launch counts {counts} "
                              f"!= {want}")
        check(stats["completed"] == len(requests)
              and all(got[i].shape == (SERVE_NEW,) for i in got),
              f"mla_serve {name}: not every request completed")
        check(stats["shared_block_hits"] > 0, f"mla_serve {name}: no "
                                              f"prefix shared")
        runs[name] = got
        if name == "eager":
            calls = rec.calls
        add_counts(counts_all, counts)
    del eager
    equal = sum(bool(np.array_equal(runs["captured"][i], runs["eager"][i]))
                for i in runs["eager"])
    drops = {"first_chunk": moe_drops(calls, cfg, SERVE_CHUNK),
             "first_verify_tick": moe_drops(calls, cfg, verify_n)}
    emit({"phase": "mla_serve_compare", "requests": len(requests),
          "captured_bitwise_equal_to_eager": equal, "drops": drops})
    check(equal == len(requests), "mla_serve: captured tokens differ from "
                                  "eager")

    # ---- the layout check: paged and slot, no sharing, no speculation --
    layouts = {}
    for kind in ("paged", "slot"):
        got, stats, counts, _ = serve(
            torch, cap, requests, ROOMY_BLOCKS, paged=kind == "paged",
            prefix_sharing=False, speculate_k=0)
        want = expected_serve_launches(cfg, stats, "fused_flash_decode")
        check(counts == want, f"mla_serve_layouts {kind}: launch counts "
                              f"{counts} != {want}")
        check(stats["completed"] == len(requests)
              and stats["preemptions"] == 0,
              f"mla_serve_layouts {kind}: a request did not complete or "
              f"was preempted")
        layouts[kind] = got
        add_counts(counts_all, counts)
    equal = sum(bool(np.array_equal(layouts["paged"][i], layouts["slot"][i]))
                for i in layouts["paged"])
    emit({"phase": "mla_serve_layouts", "requests": len(requests),
          "speculate_k": 0, "bitwise_equal": equal})
    check(equal == len(requests), "mla_serve_layouts: paged and slot "
                                  "tokens are not bitwise equal")
    add_counts(counts_all, phase_mla_layouts(torch, cap, requests,
                                             layouts["paged"]))

    # ---- forced preemptions mid-decode, replayed through the decode step -
    forced = ForcedPreemption(torch)
    got, stats, counts, _ = serve(torch, cap, requests, ROOMY_BLOCKS,
                                  prefix_sharing=False, speculate_k=0,
                                  hook=forced.install)
    check_forced("paged", forced, stats, got, layouts["paged"], counts,
                 expected_serve_launches(cfg, stats, "fused_flash_decode"),
                 phase="mla_preempt_decode")
    check(len(forced.streamed) == PREEMPTIONS,
          f"mla_preempt_decode: {len(forced.streamed)} preemptions, not "
          f"{PREEMPTIONS}")
    add_counts(counts_all, counts)

    phase_mla_tick(torch, cap, requests, smi)
    # the loop's engine and the forced run's scheduler hold cap too
    del cap, e, forced
    free_card(torch)

    # ---- f32 against per-request greedy -------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    e32 = LLMEngine(cfg32, max_len=SERVE_MAX_LEN, seed=SEED)
    got, stats, counts, _ = serve(torch, e32, requests, blocks,
                                  speculate_k=0)
    add_counts(counts_all, counts)
    exact = compare_with_greedy(torch, e32, requests, got,
                                chunk=SERVE_CHUNK)
    emit({"phase": "mla_serve_f32_exact", "preemptions": stats["preemptions"],
          "replayed_tokens": stats["replayed_tokens"],
          "weight_bytes": sum(p.numel() * p.element_size()
                              for p in e32.model.parameters()), **exact})
    check(exact["rows_compared"] > 0, "mla f32 exactness: no row compared")
    check(exact["mismatches"] == 0, "mla f32 exactness: a served token "
                                    "differs from the greedy reference's")
    del e32
    free_card(torch)
    return counts_all


def phase_mla_tick(torch, engine, requests, smi):
    """The captured paged decode tick at 4 slots (``layout_ticks``)
    against two bytes bounds: every weight a tick reads once
    (``tick_weight_bytes``: all padded experts, which the gather dispatch
    multiplies every tick) and the rows' latents once; and the same with
    only the experts the tick's tokens can hit (at most 4 x top-8 = 32),
    the gap between the two being ROADMAP item 14's.  Beside them the
    latent arena's bytes a token (c_kv and k_rope, every layer)."""
    from repro_torch.models import moe
    from repro_torch.serving import PagedBackend
    cfg = engine.cfg
    r = layout_ticks(torch, engine, requests, lambda e: PagedBackend(
        e, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS, block_size=SERVE_BLOCK))
    keys = sum(p.size + 3 + r["ticks"] // 2 for p in requests[:SERVE_SLOTS])
    latent_token = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2 \
        * cfg.num_layers
    weights = tick_weight_bytes(engine, SERVE_SLOTS)
    E_pad = moe.padded_experts(cfg)
    expert = 3 * cfg.d_model * cfg.d_ff * 2 * moe_layers(cfg)
    hit = min(E_pad, SERVE_SLOTS * cfg.num_experts_per_tok)
    all_bytes = weights + keys * latent_token
    hit_bytes = all_bytes - (E_pad - hit) * expert
    bound = all_bytes / HBM_BPS * 1e3
    emit({"phase": "mla_tick", **r, "weight_bytes": weights,
          "latent_bytes_per_token": latent_token, "keys": keys,
          "bound_bytes": all_bytes, "bound_ms": bound, "bound_by": "bytes",
          "median_over_bound": r["ms_median"] / bound,
          "experts_hit_at_most": hit,
          "bound_bytes_hit_experts": hit_bytes,
          "bound_ms_hit_experts": hit_bytes / HBM_BPS * 1e3,
          "nvidia_smi": smi})


# ---------------------------------------------------------------------------
# phase 7b — sliding windows (ROADMAP item 12): deepseek_7b at window 8192
# at full width and depth, deepseek_v3's MLA with the window; and MLA on
# the state and hybrid layouts (item 15)
# ---------------------------------------------------------------------------

WINDOW_ARCH = "deepseek_7b"
#: the window JAX's dry run serves ``long_500k`` with (``LONG_WINDOW``),
#: which deepseek_7b's config names
LONG_WINDOW = 8192
#: the window phase's requests: one whose decode crosses the window, two
#: past it at prefill; the positions limit holds the longest with its
#: new tokens (the slot rows hold the window's 8192)
WINDOW_PROMPTS = (8176, 8704, 9000)
WINDOW_NEW = 32
WINDOW_MAX_LEN = 9216
WINDOW_SLOTS = 2
#: decode ticks read for the captured-against-eager check and the times
WINDOW_TICKS = 12
#: the top-2 gap, relative to the logits' scale, above which a served
#: token must be the teacher-forced plain forward's (bf16 rounds the
#: decode path and the plain forward at different points)
WINDOW_TOP2 = 0.1
#: deepseek_v3's windowed phase: its dense head layer, one prompt past
#: the window
MLA_WINDOW_PROMPT = 8300
MLA_WINDOW_NEW = 16
#: mla_layouts' speculative runs: 2 slots of 1 + 3 tokens make verify
#: ticks of 8, within every expert's 8 rows (Hazard 7)
MLA_SPEC_SLOTS = 2
MLA_SPEC = 3


def window_config():
    from repro_torch.configs import get_config
    cfg = get_config(WINDOW_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (30, 4096, 32, 32, 128, 11008, 102400),
          f"{WINDOW_ARCH} is not at full width")
    return dataclasses.replace(cfg, sliding_window=LONG_WINDOW)


def teacher_forced(torch, engine, prompt, tokens, rel=WINDOW_TOP2):
    """Tokens served after ``prompt`` against a teacher-forced forward
    over ``prompt`` ++ ``tokens[:-1]`` on the plain path (the plain
    chunked attention with the window mask, the plain RMSNorm: no
    kernel launches): equal wherever the forward's top-2 gap exceeds
    ``rel`` of its logits' scale (``top2_agree``)."""
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.models.transformer import RuntimeFlags
    flags = RuntimeFlags(**PLAIN_FLAGS, remat="none")
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    before = dict(build.launches)
    with torch.no_grad():
        logits = engine.model.forward(
            torch.as_tensor(seq[None], device=engine.device),
            flags=flags)[0]
    check(dict(build.launches) == before, "the plain forward launched a "
                                          "kernel")
    lg = logits[0, prompt.size - 1:, :engine.cfg.vocab_size].float()
    del logits
    scale = float(lg.abs().max())
    agree, n = top2_agree(torch.argmax(lg, -1), tokens, lg, rel * scale)
    same = int((torch.argmax(lg, -1).cpu()
                == torch.as_tensor(tokens).long()).sum())
    return {"tokens": int(tokens.size), "argmax_equal": same,
            "gap_limit": rel * scale, "tokens_compared": n,
            "tokens_agree": agree, "logit_scale": scale,
            "ok": agree and bool(torch.isfinite(lg).all())}


def window_ticks(torch, engines, requests, ticks=WINDOW_TICKS):
    """Decode ticks of WINDOW_SLOTS rows (``requests`` prefilled and
    inserted, past the window) on each engine's slot layout, the engines
    in turns: 3 of warm-up, then ``ticks`` read.  Returns ({engine: the
    median and min wall ms}, {engine: the ticks' tokens}, {engine: the
    cache})."""
    import numpy as np
    from repro_torch.serving import SlotBackend
    state = {}
    for name, e in engines.items():
        be = SlotBackend(e, WINDOW_SLOTS)
        cache = e.new_cache(be)
        last = np.zeros(WINDOW_SLOTS, np.int32)
        pos = np.zeros(WINDOW_SLOTS, np.int32)
        for slot, p in enumerate(requests):
            first, rows = e.prefill(p[None])
            cache = e.insert(be, cache, rows, 0, slot)
            last[slot], pos[slot] = first[0], p.size
        state[name] = [be, cache, last, pos, [], []]
    active = np.ones(WINDOW_SLOTS, bool)
    for i in range(3 + ticks):
        for name, e in engines.items():
            be, cache, last, pos, toks, times = state[name]
            t0 = time.perf_counter()
            tok, cache = e.decode(be, cache, last, pos, active)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            state[name][1:4] = [cache, tok, pos + 1]
    ms = {name: {"ms_median": statistics.median(st[5]),
                 "ms_min": min(st[5])} for name, st in state.items()}
    return (ms, {name: np.stack(st[4]) for name, st in state.items()},
            {name: st[1] for name, st in state.items()})


def window_tick_bytes(engine, positions):
    """A windowed decode tick's bytes bound: every weight once
    (``tick_weight_bytes``) and each row's live slots' K and V once,
    every layer."""
    cfg = engine.cfg
    per_slot = 2 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    live = sum(min(int(p) + 1, cfg.sliding_window) for p in positions)
    return tick_weight_bytes(engine, len(positions)) + live * per_slot


def phase_window_main_path(torch, smi):
    """deepseek_7b at full width and depth (30 layers, d 4096, 32 heads
    of 128, MHA, bf16, random weights from the seed) with the window
    8192: the Scheduler on a SlotBackend of WINDOW_SLOTS slots (no
    chunking, no speculation, as JAX serves a window) serves
    WINDOW_PROMPTS with one forced preemption replayed through the
    decode step: K1 and K3 (its window branch) launches held to the
    schedule and no decode kernel (windowed decode is the plain gather
    path, as in JAX), each request's tokens bitwise the engine's own
    ``generate`` of it alone and the victim's K/V bitwise what it held,
    and each against a teacher-forced plain forward (``teacher_forced``);
    then the captured decode tick bitwise the eager one's tokens and
    cache, both times beside the tick's bytes bound, and the prefill of
    the longest prompt.  Returns the launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, SlotBackend
    cfg = window_config()
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=WINDOW_MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 11)
    requests = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                for n in WINDOW_PROMPTS]
    forced = ForcedPreemption(torch, limit=1)
    got, stats, counts, wall = serve(
        torch, engine, requests, 0, speculate_k=0, chunk=None,
        max_new=WINDOW_NEW, hook=forced.install,
        backend=lambda e: SlotBackend(e, WINDOW_SLOTS))
    want = expected_serve_launches(cfg, stats, None)
    kv_equal, victims = forced.kv_equal, forced.streamed
    del forced                   # it holds the scheduler and its cache
    alone = [engine.generate(p[None], WINDOW_NEW)[0] for p in requests]
    equal = sum(bool(np.array_equal(got[i], a)) for i, a in enumerate(alone))
    cache_rows = abstract_rows(cfg, WINDOW_MAX_LEN)
    emit({"phase": "window_main_path", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "window": cfg.sliding_window,
          "max_len": WINDOW_MAX_LEN, "cache_rows": cache_rows,
          "prompts": list(WINDOW_PROMPTS), "new": WINDOW_NEW,
          "slots": WINDOW_SLOTS, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in engine.model.parameters()),
          "init_seconds": init_s, "serve_seconds": wall,
          "launches": counts, "expected_launches": want,
          "victims_streamed_tokens": victims,
          "replays_kv_bitwise": sum(kv_equal),
          "bitwise_equal_to_generate_alone": equal,
          "stats": {k: stats[k] for k in (
              "prefill_calls", "decode_steps", "preemptions",
              "replayed_tokens", "replay_steps", "completed",
              "admit_seconds", "step_seconds")}})
    check(cache_rows == LONG_WINDOW, f"window_main_path: slot rows of "
                                     f"{cache_rows}, not the window's")
    check(counts == want, f"window_main_path: launch counts {counts} != "
                          f"{want}")
    check(stats["completed"] == len(requests), "window_main_path: not "
                                               "every request completed")
    check(stats["preemptions"] == 1 and stats["replay_steps"] > 0
          and kv_equal == [True], "window_main_path: the forced "
          "preemption's replay did not restore the victim's K/V bitwise")
    check(equal == len(requests), "window_main_path: served tokens differ "
                                  "from generate alone")
    for i, p in enumerate(requests):
        r = teacher_forced(torch, engine, p, got[i])
        emit({"phase": "window_vs_plain_forward", "request": i,
              "prompt": int(p.size), "rel_gap": WINDOW_TOP2, **r})
        check(r["ok"], f"window_vs_plain_forward {i}: {r}")

    # ---- the captured tick against the eager one ----------------------
    eager = LLMEngine(cfg, dict(engine.model.named_parameters()),
                      max_len=WINDOW_MAX_LEN,
                      flags=RuntimeFlags(cuda_graphs=False))
    pair = [requests[0], requests[2]]
    ms, toks, caches = window_ticks(torch, {"captured": engine,
                                            "eager": eager}, pair)
    same_cache = all(torch.equal(a, b) for a, b in zip(
        flatten_leaves(caches["captured"]), flatten_leaves(caches["eager"])))
    positions = [p.size + 3 + WINDOW_TICKS // 2 for p in pair]
    nbytes = window_tick_bytes(engine, positions)
    bound_ms = nbytes / HBM_BPS * 1e3
    graphs = [g for key, g in (engine.graphs.steps.items()
                               if engine.graphs is not None else ())
              if key[:2] == ("decode", "slot") and key[3] == WINDOW_SLOTS]
    graph_ms = cuda_ms(torch, graphs[-1].graph.replay, reps=5,
                       profile=False)[0] if graphs else None
    del eager, caches
    free_card(torch)
    long = requests[2][None]
    engine.prefill(long)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(long)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "window_tick", "slots": WINDOW_SLOTS,
          "rows_at": positions, "ticks": WINDOW_TICKS, **{
              f"{name}_{k}": v for name, r in ms.items()
              for k, v in r.items()},
          "captured_graph_device_ms": graph_ms,
          "captured_bitwise_eager": bool(np.array_equal(
              toks["captured"], toks["eager"])) and same_cache,
          "bound_bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
          "captured_over_bound": ms["captured"]["ms_median"] / bound_ms,
          "prefill_tokens": int(long.shape[1]), "prefill_ms": prefill_ms,
          "nvidia_smi": smi})
    check(bool(np.array_equal(toks["captured"], toks["eager"]))
          and same_cache, "window_tick: the captured tick's tokens or "
                          "cache differ from the eager tick's")
    if graph_ms is not None:
        COST_STEPS.append(tick_cost(
            "deepseek_7b captured window tick, 2 slots", "window_tick",
            engine, "slot", graph_ms, nbytes, slots=WINDOW_SLOTS))
    del engine
    free_card(torch)
    return counts


def abstract_rows(cfg, max_len):
    """The positions a slot row of the model's attention layers holds
    (its abstract cache: nothing is allocated)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import flatten
    rows = {a.shape[-3 if path.endswith((".k", ".v")) else -2]
            for path, a in flatten(tf.abstract_cache(cfg, 1, max_len)).items()
            if path.endswith((".mixer.k", ".mixer.c_kv"))}
    check(len(rows) == 1, f"{cfg.name}: slot rows {rows}")
    return rows.pop()


def flatten_leaves(tree):
    from repro_torch.models.params import flatten
    return [a for _, a in sorted(flatten(tree).items())]


def phase_mla_window(torch, smi):
    """deepseek_v3_671b at full width, cut to its dense head layer (no
    MoE, so no capacity drop: Hazard 7), with the window 8192: one
    prompt of MLA_WINDOW_PROMPT tokens (past the window at prefill) and
    MLA_WINDOW_NEW new tokens through the Scheduler on a one-slot
    SlotBackend: K1 launches held to the schedule (MLA attends in plain
    PyTorch, as in JAX), the tokens bitwise ``generate``'s and against a
    teacher-forced plain forward (``teacher_forced``).  Returns the
    launch counts."""
    import numpy as np
    from repro_torch.serving import LLMEngine, SlotBackend
    cfg = dataclasses.replace(deepseek_config(), num_layers=1,
                              sliding_window=LONG_WINDOW)
    check(list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
          == [("attn", "dense")], "mla_window: not the dense head layer")
    max_len = MLA_WINDOW_PROMPT + MLA_WINDOW_NEW + 4
    engine = LLMEngine(cfg, max_len=max_len, seed=SEED)
    prompt = np.random.RandomState(SEED + 12).randint(
        0, cfg.vocab_size, MLA_WINDOW_PROMPT).astype(np.int32)
    got, stats, counts, wall = serve(
        torch, engine, [prompt], 0, speculate_k=0, chunk=None,
        max_new=MLA_WINDOW_NEW, backend=lambda e: SlotBackend(e, 1))
    want = expected_serve_launches(cfg, stats, None)
    alone = engine.generate(prompt[None], MLA_WINDOW_NEW)[0]
    r = teacher_forced(torch, engine, prompt, got[0])
    rows = abstract_rows(cfg, max_len)
    emit({"phase": "mla_window", "arch": cfg.name, "layers": 1,
          "window": cfg.sliding_window, "prompt": int(prompt.size),
          "new": MLA_WINDOW_NEW, "latent_rows": rows,
          "seconds": wall, "launches": counts, "expected_launches": want,
          "bitwise_equal_to_generate": bool(np.array_equal(got[0], alone)),
          "rel_gap": WINDOW_TOP2, **r, "nvidia_smi": smi})
    check(rows == LONG_WINDOW, "mla_window: latent rows are not the "
                               "window's")
    check(counts == want, f"mla_window: launch counts {counts} != {want}")
    check(np.array_equal(got[0], alone), "mla_window: served tokens differ "
                                         "from generate")
    check(r["ok"], f"mla_window against the plain forward: {r}")
    del engine
    free_card(torch)
    return counts


def phase_mla_layouts(torch, engine, requests, paged):
    """deepseek's two layers at full width on the layouts of item 15:
    mla_serve's requests (SERVE_SLOTS slots, chunk 256, no speculation,
    no prefix sharing, a roomy arena) on a HybridBackend (the latents
    paged, ``mla.paged_decode``) and a StateBackend (slot rows of
    latents), each bitwise the paged layout's tokens ``paged``; then
    the first four requests at MLA_SPEC_SLOTS slots with speculation
    MLA_SPEC (verify ticks within every expert's rows, Hazard 7) on a
    paged and a hybrid arena (the verify window and its rewind),
    bitwise.  K1 launches held to the schedule.  Returns the launch
    counts."""
    import numpy as np
    from repro_torch.serving import HybridBackend, PagedBackend, StateBackend
    cfg = engine.cfg
    counts_all = {}
    runs = {
        "hybrid": lambda e: HybridBackend(e, SERVE_SLOTS,
                                          num_blocks=ROOMY_BLOCKS,
                                          block_size=SERVE_BLOCK),
        "state": lambda e: StateBackend(e, SERVE_SLOTS)}
    for kind, make in runs.items():
        got, stats, counts, wall = serve(torch, engine, requests, 0,
                                         backend=make, speculate_k=0)
        want = expected_serve_launches(cfg, stats, None)
        equal = sum(bool(np.array_equal(got[i], paged[i])) for i in paged)
        emit({"phase": "mla_layouts", "layout": kind, "slots": SERVE_SLOTS,
              "speculate_k": 0, "seconds": wall, "launches": counts,
              "expected_launches": want, "bitwise_equal_to_paged": equal,
              "requests": len(requests)})
        check(counts == want, f"mla_layouts {kind}: launch counts {counts} "
                              f"!= {want}")
        check(stats["completed"] == len(requests)
              and stats["preemptions"] == 0,
              f"mla_layouts {kind}: a request did not complete or was "
              f"preempted")
        check(equal == len(requests), f"mla_layouts {kind}: tokens differ "
                                      f"from the paged layout's")
        add_counts(counts_all, counts)
    spec = {}
    for kind, make in (
            ("paged", lambda e: PagedBackend(
                e, MLA_SPEC_SLOTS, num_blocks=ROOMY_BLOCKS,
                block_size=SERVE_BLOCK, prefix_sharing=False)),
            ("hybrid", lambda e: HybridBackend(
                e, MLA_SPEC_SLOTS, num_blocks=ROOMY_BLOCKS,
                block_size=SERVE_BLOCK))):
        got, stats, counts, wall = serve(torch, engine, requests[:4], 0,
                                         backend=make, speculate_k=MLA_SPEC)
        check(counts == expected_serve_launches(cfg, stats, None),
              f"mla_layouts spec {kind}: launch counts {counts}")
        check(stats["spec_steps"] > 0 and stats["completed"] == 4,
              f"mla_layouts spec {kind}: no verify tick, or not complete")
        spec[kind] = (got, stats)
        add_counts(counts_all, counts)
    equal = sum(bool(np.array_equal(spec["hybrid"][0][i], spec["paged"][0][i]))
                for i in range(4))
    emit({"phase": "mla_layouts", "layout": "hybrid against paged",
          "slots": MLA_SPEC_SLOTS, "speculate_k": MLA_SPEC,
          "bitwise_equal": equal, "requests": 4,
          "stats": {kind: {k: st[k] for k in (
              "spec_steps", "spec_drafted", "spec_accepted", "decode_steps")}
              for kind, (_, st) in spec.items()}})
    check(equal == 4, "mla_layouts: hybrid tokens with speculation differ "
                      "from the paged layout's")
    return counts_all


# ---------------------------------------------------------------------------
# phase 8 — the modality stubs at full width and depth: phi_3_vision_4_2b
# (576 patch embeddings before the prompt) and seamless_m4t_large_v2 (an
# encoder over frame embeddings, cross-attention caches)
# ---------------------------------------------------------------------------

VLM_ARCH = "phi_3_vision_4_2b"
ENCDEC_ARCH = "seamless_m4t_large_v2"
#: rows and text tokens of each stub prompt, the lockstep decode steps
#: after its prefill, and the frames of seamless_m4t_large_v2's encoder
#: input
STUB_ROWS = 2
STUB_TOKENS = 16
STUB_STEPS = 8
ENC_FRAMES = 256
#: seamless_m4t_large_v2's encoder and decoder depth in encdec_main_path
#: (cut from 24 each: the script's time limit)
ENCDEC_DEPTH = 12


def vlm_config():
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.num_prefix_embeddings,
           cfg.padded_vocab, cfg.dtype)
          == (32, 3072, 32, 32, 96, 8192, 576, 32768, "bfloat16"),
          f"{VLM_ARCH} is not at full width and depth")
    return cfg


def encdec_config():
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    check((cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
           cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.padded_vocab, cfg.tie_embeddings, cfg.dtype)
          == (24, 24, 1024, 16, 16, 64, 8192, 258048, False, "bfloat16"),
          f"{ENCDEC_ARCH} is not at full width and depth")
    return cfg


def stub_inputs(torch, cfg):
    """(tokens [STUB_ROWS, STUB_TOKENS], the stub embeddings as the
    prefill's keyword) from the seed, drawn as ``data/pipeline.py``
    draws them: frame embeddings of unit scale for an encoder-decoder,
    patch embeddings x 0.02 otherwise."""
    import numpy as np
    rng = np.random.RandomState(SEED + 5)
    toks = rng.randint(0, cfg.vocab_size,
                       (STUB_ROWS, STUB_TOKENS)).astype(np.int32)
    if cfg.is_encoder_decoder:
        key, e = "enc_embeds", rng.randn(STUB_ROWS, ENC_FRAMES, cfg.d_model)
    else:
        key, e = "prefix_embeds", rng.randn(
            STUB_ROWS, cfg.num_prefix_embeddings, cfg.d_model) * 0.02
    return toks, {key: torch.as_tensor(e.astype(np.float32), device=DEVICE)}


def stub_path(torch, engine, toks, embeds, max_len):
    """The stub model's main path with every launch counter at 0 first:
    ``make_prefill_step`` over ``toks`` and ``embeds``, then STUB_STEPS
    lockstep decode steps (``make_decode_step``, eager) at the positions
    after the prompt.  Returns the tokens [STUB_ROWS, 1 + STUB_STEPS],
    the launch counts, the cache, the cross caches as the prefill left
    them, the prefill's wall seconds and the steps' wall ms."""
    from repro_torch.kernels import build
    from repro_torch.models.params import flatten
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    prefill = make_prefill_step(engine.model, max_len, engine.flags)
    decode = make_decode_step(engine.model, engine.flags)
    x = torch.as_tensor(toks, device=DEVICE).long()
    S = x.shape[1] + (embeds["prefix_embeds"].shape[1]
                      if "prefix_embeds" in embeds else 0)
    for name in build.launches:
        build.launches[name] = 0
    t0 = time.perf_counter()
    first, cache = prefill(x, **embeds)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cross = {p: a.clone() for p, a in flatten(cache).items()
             if ".cross." in p}
    out, cur, step_ms = [first], first[:, None], []
    for i in range(STUB_STEPS):
        pos = torch.full((x.shape[0],), S + i, dtype=torch.int32,
                         device=DEVICE)
        t0 = time.perf_counter()
        cur, cache = decode(cur.long(), cache, pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(cur[:, 0])
    counts = dict(build.launches)
    toks_out = torch.stack(out, dim=1).cpu().numpy()
    check(toks_out.shape == (x.shape[0], 1 + STUB_STEPS)
          and ((toks_out >= 0) & (toks_out < engine.cfg.vocab_size)).all(),
          f"{engine.cfg.name}: stub path tokens")
    return types.SimpleNamespace(tokens=toks_out, counts=counts, cache=cache,
                                 cross=cross, prefill_s=prefill_s,
                                 step_ms=step_ms, rows=S)


def stub_launches(attn, prefill_norms, step_norms, steps):
    """The launch counts of one prefill and ``steps`` decode steps:
    ``prefill_norms`` and ``step_norms`` K1 launches, one K3 per
    attention layer at the prefill and one K2 per attention layer a
    step."""
    from repro_torch.kernels import build
    want = {name: 0 for name in build.launches}
    want.update({"rmsnorm": prefill_norms + step_norms * steps,
                 "flash_attention": attn,
                 "fused_flash_decode": attn * steps})
    return want


def text_generate(torch, engine, toks, norms, attn):
    """``LLMEngine.generate`` on the tokens alone, as JAX serves a stub
    model, for GEN_NEW tokens: launches held to ``norms`` K1 a pass.
    Returns (tokens, launch counts)."""
    from repro_torch.kernels import build
    for name in build.launches:
        build.launches[name] = 0
    gen = engine.generate(toks, GEN_NEW)
    counts = dict(build.launches)
    want = stub_launches(attn, norms, norms, GEN_NEW - 1)
    check(gen.shape == (toks.shape[0], GEN_NEW)
          and ((gen >= 0) & (gen < engine.cfg.vocab_size)).all(),
          f"{engine.cfg.name}: generate's tokens")
    check(counts == want, f"{engine.cfg.name} generate: launch counts "
                          f"{counts} != {want}")
    return gen, counts


def f32_against_plain(torch, cfg, max_len, toks, embeds):
    """An f32 engine (its own weights from the seed) on the kernel path
    against the plain path on the same weights: ``compare_greedy`` over
    the stub prompt, STUB_STEPS steps, held at F32_MODEL_TOL or, where
    the f32 plain path sits further from the plain path in f64 on the
    same weights, at that distance.  (On an H100 the f32 plain path sat
    4.0e-3-9.7e-3 from the f64 run on phi_3_vision_4_2b and
    1.4e-2-8.1e-2 on seamless_m4t_large_v2, at logit scales of 4.8 and
    5.0: ``step_limits``.)"""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    k32 = LLMEngine(cfg32, max_len=max_len, seed=SEED)
    w32 = dict(k32.model.named_parameters())
    p32 = LLMEngine(cfg32, w32, max_len=max_len,
                    flags=RuntimeFlags(**PLAIN_FLAGS))
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    x64 = LLMEngine(cfg64, {k: v.double() for k, v in w32.items()},
                    max_len=max_len, flags=RuntimeFlags(**PLAIN_FLAGS))
    out = compare_greedy(torch, k32, p32, toks, steps=STUB_STEPS,
                         tol=F32_MODEL_TOL, max_len=max_len, exact=x64,
                         **embeds)
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in k32.model.parameters())
    return out


def phase_vlm_main_path(torch):
    """phi_3_vision_4_2b at full width and depth in bf16 (random weights
    from the seed): ``make_prefill_step`` over 576 patch embeddings and
    16 tokens (592 rows: K3 at head_dim 96), then STUB_STEPS lockstep
    decode steps at positions from 592 (K2), launches held to the
    schedule; ``generate`` on the tokens alone, as JAX serves it; then
    an f32 engine's kernel path against its plain path over the same
    prefix.  Returns the launch counts."""
    from repro_torch.serving import LLMEngine
    cfg = vlm_config()
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, embeds = stub_inputs(torch, cfg)
    run = stub_path(torch, engine, toks, embeds, SERVE_MAX_LEN)
    norms, attn = schedule(cfg)
    want = stub_launches(attn, norms, norms, STUB_STEPS)
    gen, gen_counts = text_generate(torch, engine, toks, norms, attn)
    emit({"phase": "vlm_main_path", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in engine.model.parameters()),
          "prefix_embeddings": cfg.num_prefix_embeddings,
          "prompt_rows": run.rows, "init_seconds": init_s,
          "prefill_seconds": run.prefill_s,
          "decode_step_ms": run.step_ms, "launches": run.counts,
          "expected_launches": want, "tokens": run.tokens.tolist(),
          "generate_text_only": gen.tolist(),
          "generate_launches": gen_counts})
    check(run.rows == cfg.num_prefix_embeddings + STUB_TOKENS,
          "vlm_main_path: prompt rows")
    check(run.counts == want, f"vlm_main_path: launch counts {run.counts} "
                              f"!= {want}")
    counts = add_counts(dict(run.counts), gen_counts)
    del engine, run
    free_card(torch)
    cmp32 = f32_against_plain(torch, cfg, SERVE_MAX_LEN, toks, embeds)
    emit({"phase": "vlm_f32_vs_plain", **cmp32})
    check(cmp32["ok"], "vlm f32 greedy tokens or logits disagree with the "
                       "plain path")
    free_card(torch)
    return counts


def phase_vlm_serve(torch, smi):
    """The serve workload's requests (``serve_requests``, re-drawn in
    phi_3_vision_4_2b's vocab, text only) through the Scheduler at full
    width and depth in bf16: on the pressure PagedBackend (prefix
    sharing, chunk 256, speculate 4) captured with K2 against eager
    (tokens bitwise), and captured with K4; on a roomy PagedBackend
    against a SlotBackend (no sharing; tokens bitwise); every run's
    launches held to its schedule; then the captured paged decode tick
    at 4 slots (``layout_ticks``) against its bytes bound: every decoder
    weight once, 4 embedding rows, and the rows' K/V once.  Returns the
    launch counts."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, PagedBackend
    cfg = vlm_config()
    requests = serve_requests(cfg.vocab_size)
    blocks, _, _ = pressure_blocks(requests)
    cap = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED)
    weights = dict(cap.model.named_parameters())
    runs, total = {}, {}
    for name, flags, attend in (
            ("captured", None, "fused_flash_decode"),
            ("eager", {"cuda_graphs": False}, "fused_flash_decode"),
            ("split_k", {"fused_split_k": True},
             "fused_flash_decode_splitk")):
        e = cap if flags is None else LLMEngine(
            cfg, weights, max_len=SERVE_MAX_LEN, flags=RuntimeFlags(**flags))
        got, stats, counts, wall = serve(torch, e, requests, blocks)
        want = expected_serve_launches(cfg, stats, attend)
        emit({"phase": "vlm_serve", "run": name, "num_blocks": blocks,
              "seconds": wall, "launches": counts,
              "expected_launches": want,
              "stats": {k: stats[k] for k in (
                  "prefill_calls", "extend_prefills", "decode_steps",
                  "spec_steps", "preemptions", "replayed_tokens",
                  "shared_block_hits", "completed", "admit_seconds",
                  "step_seconds")}})
        check(counts == want, f"vlm_serve {name}: launch counts {counts} "
                              f"!= {want}")
        check(stats["completed"] == len(requests)
              and sorted(got) == list(range(len(requests)))
              and all(got[i].shape == (SERVE_NEW,) for i in got),
              f"vlm_serve {name}: not every request completed")
        check(stats["preemptions"] > 0 and stats["shared_block_hits"] > 0,
              f"vlm_serve {name}: no preemption or no prefix shared")
        runs[name] = got
        add_counts(total, counts)
        del e
    equal = sum(bool(np.array_equal(runs["captured"][i], runs["eager"][i]))
                for i in runs["eager"])
    emit({"phase": "vlm_serve_compare", "requests": len(requests),
          "captured_bitwise_equal_to_eager": equal})
    check(equal == len(requests), "vlm_serve: captured tokens differ from "
                                  "eager")

    # ---- the layout check: paged and slot, no sharing, no pressure -----
    layouts = {}
    for kind in ("paged", "slot"):
        got, stats, counts, _ = serve(torch, cap, requests, ROOMY_BLOCKS,
                                      paged=kind == "paged",
                                      prefix_sharing=False)
        want = expected_serve_launches(cfg, stats, "fused_flash_decode")
        check(counts == want, f"vlm_serve_layouts {kind}: launch counts "
                              f"{counts} != {want}")
        check(stats["completed"] == len(requests)
              and stats["preemptions"] == 0,
              f"vlm_serve_layouts {kind}: a request did not complete or "
              f"was preempted")
        layouts[kind] = got
        add_counts(total, counts)
    equal = sum(bool(np.array_equal(layouts["paged"][i], layouts["slot"][i]))
                for i in layouts["paged"])
    emit({"phase": "vlm_serve_layouts", "requests": len(requests),
          "bitwise_equal": equal})
    check(equal == len(requests), "vlm_serve_layouts: paged and slot "
                                  "tokens are not bitwise equal")

    # ---- the captured paged tick against its bound ---------------------
    r = layout_ticks(torch, cap, requests, lambda e: PagedBackend(
        e, SERVE_SLOTS, num_blocks=ROOMY_BLOCKS, block_size=SERVE_BLOCK))
    keys = sum(p.size + 3 + r["ticks"] // 2 for p in requests[:SERVE_SLOTS])
    kv_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    weight_bytes = tick_weight_bytes(cap, SERVE_SLOTS)
    nbytes = weight_bytes + keys * kv_token
    b_ms = nbytes / HBM_BPS * 1e3
    emit({"phase": "vlm_tick", **r, "weight_bytes": weight_bytes,
          "kv_bytes_per_token": kv_token, "keys": keys,
          "bound_bytes": nbytes, "bound_ms": b_ms, "bound_by": "bytes",
          "median_over_bound": r["ms_median"] / b_ms, "nvidia_smi": smi})
    del cap, weights
    free_card(torch)
    return total


def phase_encdec_main_path(torch, smi):
    """seamless_m4t_large_v2 at full width, ENCDEC_DEPTH encoder and
    decoder layers, in bf16 (random
    weights from the seed): ``make_prefill_step`` over 256 frame
    embeddings (the encoder: K1 at its norms, its bidirectional
    attention in plain PyTorch) and a 16-token decoder prompt (K3), then
    STUB_STEPS lockstep decode steps that read the cross caches (K2),
    launches held to the schedule (K1: 2 an encoder layer and its final
    norm, 3 a decoder layer with memory and the final norm), the cross
    caches bitwise what the prefill wrote; ``generate`` without memory,
    as JAX serves it; the encode, prefill and eager decode-step times
    beside the step's bytes bound (decoder and LM head weights, 2
    embedding rows, the cross and self K/V once); then an f32 engine's
    kernel path against its plain path over the same frames.  Returns
    the launch counts."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import flatten
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    from repro_torch.serving import LLMEngine
    cfg = dataclasses.replace(encdec_config(), num_layers=ENCDEC_DEPTH,
                              num_encoder_layers=ENCDEC_DEPTH)
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, embeds = stub_inputs(torch, cfg)
    run = stub_path(torch, engine, toks, embeds, MAX_LEN)
    norms, attn = schedule(cfg)            # a decoder pass without memory
    enc_norms = 2 * cfg.num_encoder_layers + 1
    step_norms = norms + cfg.num_layers    # and a cross_norm a layer
    want = stub_launches(attn, enc_norms + step_norms, step_norms,
                         STUB_STEPS)
    cache = flatten(run.cache)
    cross_shape = (cfg.num_layers, STUB_ROWS, ENC_FRAMES, cfg.num_kv_heads,
                   cfg.head_dim)
    cross_kept = all(torch.equal(cache[p], a) for p, a in run.cross.items())
    gen, gen_counts = text_generate(torch, engine, toks, norms, attn)

    # ---- times beside the decode step's bound: each call launches ~10^3
    # kernels, more than the card's launch queue holds, so the calls do
    # not queue (``cuda_ms``'s ``queue``); the host's wall time and the
    # profiler's sum, the device's busy time, are read
    params = engine.model.params
    enc = embeds["enc_embeds"]
    enc_ms = cuda_ms(torch, lambda: tf.encode(params, cfg, enc,
                                              engine.flags), 5, False)
    prefill = make_prefill_step(engine.model, MAX_LEN, engine.flags)
    x = torch.as_tensor(toks, device=DEVICE).long()
    pre_ms = cuda_ms(torch, lambda: prefill(x, enc_embeds=enc), 5, False)
    decode = make_decode_step(engine.model, engine.flags)
    cur = torch.as_tensor(run.tokens[:, -1:], device=DEVICE).long()
    pos = torch.full((STUB_ROWS,), run.rows + STUB_STEPS, dtype=torch.int32,
                     device=DEVICE)
    dec_ms = cuda_ms(torch, lambda: decode(cur, run.cache, pos), 5, False)
    kv = sum(a.numel() * a.element_size() for p, a in cache.items()
             if ".cross." in p)
    self_kv = (2 * cfg.num_layers * STUB_ROWS * (run.rows + STUB_STEPS + 1)
               * cfg.num_kv_heads * cfg.head_dim * 2)
    weight_bytes = tick_weight_bytes(engine, STUB_ROWS)
    nbytes = weight_bytes + kv + self_kv
    b_ms = nbytes / HBM_BPS * 1e3
    emit({"phase": "encdec_main_path", "arch": cfg.name,
          "layers": cfg.num_layers,
          "encoder_layers": cfg.num_encoder_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "padded_vocab": cfg.padded_vocab,
          "dtype": cfg.dtype,
          "params": sum(p.numel() for p in engine.model.parameters()),
          "encoder_frames": ENC_FRAMES, "prompt_rows": run.rows,
          "init_seconds": init_s, "path_prefill_seconds": run.prefill_s,
          "path_decode_step_ms": run.step_ms, "launches": run.counts,
          "expected_launches": want, "tokens": run.tokens.tolist(),
          "cross_shape": list(cache["blocks.l0.cross.k"].shape),
          "cross_bitwise_kept": cross_kept,
          "generate_without_memory": gen.tolist(),
          "generate_launches": gen_counts,
          **{f"{name}_{key}": t[i] for name, t in (
              ("encode", enc_ms), ("prefill", pre_ms),
              ("decode_step", dec_ms))
             for i, key in ((1, "host_ms"), (2, "profiler_ms"))},
          "decode_weight_bytes": weight_bytes, "cross_kv_bytes": kv,
          "self_kv_bytes": self_kv, "decode_bound_ms": b_ms,
          "bound_by": "bytes", "nvidia_smi": smi})
    check(run.counts == want, f"encdec_main_path: launch counts "
                              f"{run.counts} != {want}")
    check(tuple(cache["blocks.l0.cross.k"].shape) == cross_shape
          and len(run.cross) == 2, "encdec_main_path: the cross caches")
    check(cross_kept, "encdec_main_path: a decode step wrote the cross "
                      "caches")
    counts = add_counts(dict(run.counts), gen_counts)
    del engine, run, cache, params, prefill, decode
    free_card(torch)
    cmp32 = f32_against_plain(torch, cfg, MAX_LEN, toks, embeds)
    emit({"phase": "encdec_f32_vs_plain", **cmp32})
    check(cmp32["ok"], "encdec f32 greedy tokens or logits disagree with "
                       "the plain path")
    free_card(torch)
    return counts


# ---------------------------------------------------------------------------
# tensor-parallel serving of the contractions and of the widths tp does
# not divide (item 11b-ii): deepseek_v3_671b's MLA at tp 2, minicpm_2b at
# tp 8 (heads and kv heads whole, K/V on head_dim), seamless_m4t_large_v2
# at tp 2 through ``generate`` with its encoder's frames
# ---------------------------------------------------------------------------

#: minicpm_2b at tp 8: its 36 heads and 36 kv heads stay whole on every
#: rank and K/V lie on head_dim (64 / 8 lanes a rank); depth cut from 40,
#: the serve workload's first 2 requests
TP_HD = 8
TP_HD_DEPTH = 2
TP_HD_REQUESTS = 2
#: seamless_m4t_large_v2's depth (encoder and decoder) in tp_encdec's f32
#: check (cut from 24 each)
TP_ENCDEC_F32_DEPTH = 4
#: tp_encdec's encoder and decoder layers (cut from 24 + 24 to fit the
#: run's time limit)
TP_ENCDEC_DEPTH = 12


def mla_tick_reduces(kind, ffn):
    """Rank 0's all-reduces a decode tick of one deepseek layer at tp 2:
    MLA's gather of every head's absorbed query, its scores (the lora
    lanes' partials and the rope terms), its latent output's lanes and
    the heads' output sum; a dense FFN's sum; a MoE FFN's router gather
    and its experts' sum."""
    return 4 + (ffn == "dense") + 2 * (ffn == "moe")


def phase_tp_mla(torch, smi):
    """deepseek's two layers at full width in bf16 (random weights from
    the seed: each rank draws the unsharded model's leaves and keeps its
    slice) at tp 2 on the card, ~14.7 GB a rank: a rank holds 64 of the
    128 heads of ``wq_b``, ``wk_b``, ``wv_b`` and ``wo``, the latent
    projections whole, half the dense FFN, 128 of the 256 experts and
    half the vocabulary; its caches 256 of ``c_kv``'s 512 lora lanes and
    8 of every 16-position block's ``k_rope`` offsets.  The serve
    workload's first TP_REQUESTS requests for TP_NEW tokens through the
    Scheduler on a roomy PagedBackend of TP_MOE_SLOTS slots (chunk 256,
    speculate 4, prefix sharing; Hazard 7: a verify tick carries 10
    tokens) with one forced preemption: every rank's launches equal to
    the schedule (K1 alone: MLA attends in plain PyTorch), the tokens
    bitwise each request served alone by the same engine
    (``own_greedy``), rank 0's latents replayed bitwise, every MoE
    call's pairs kept by the ranks' plans the unsharded plan's (drops
    counted a call); a SlotBackend of as many slots gives the same
    tokens.  Then the eager tick against the unsharded eager tick, and
    the dense head layer alone in f32 at tp 2 against tp 1
    (``tp_f32_check``).  Returns the launch counts of every rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine, PagedBackend, SlotBackend
    t_phase = time.perf_counter()
    cfg = deepseek_config()
    requests = serve_requests(cfg.vocab_size)[:TP_REQUESTS]
    blocks = 1 + TP_MOE_SLOTS * SERVE_MAX_LEN // SERVE_BLOCK
    t0 = time.perf_counter()
    engine = tp_engine(torch, cfg, TP, SERVE_MAX_LEN)
    start_s = time.perf_counter() - t0
    forced = ForcedPreemption(torch, limit=1)
    with RouteRecorder() as rec:
        got, stats, counts, wall, per_rank, want = tp_serve(
            torch, engine, cfg, requests, 0, "fused_flash_decode",
            max_new=TP_NEW, hook=forced.install,
            backend=lambda e: PagedBackend(e, TP_MOE_SLOTS,
                                           num_blocks=blocks,
                                           block_size=SERVE_BLOCK))
    alone = own_greedy(torch, engine, requests, TP_NEW)
    equal = bitwise_equal(got, alone)
    served, _ = tp_moe_drops(torch, rec.calls, cfg,
                             TP_MOE_SLOTS * (SERVE_SPEC + 1))
    engine.rank_launches(reset=True)
    slot, _, _, _ = serve(torch, engine, requests, 0, max_new=TP_NEW,
                          backend=lambda e: SlotBackend(e, TP_MOE_SLOTS))
    for c in engine.rank_launches():
        add_counts(counts, c)
    emit({"phase": "tp_mla", "arch": cfg.name, "tp": TP,
          "layers": cfg.num_layers, "slots": TP_MOE_SLOTS,
          "heads_per_rank": cfg.num_heads // TP,
          "lora_lanes_per_rank": cfg.kv_lora_rank // TP,
          "rope_offsets_per_block": SERVE_BLOCK // TP,
          "experts_per_rank": moe_padded(cfg) // TP,
          "cache_shards": engine.cache_shards(),
          "engine_start_s": start_s, "seconds": wall,
          "launches_per_rank": per_rank, "expected_launches": want,
          "bitwise_equal_to_own_greedy": equal,
          "slot_bitwise_equal_to_paged": bitwise_equal(slot, got),
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_latents_bitwise_rank0": sum(forced.kv_equal),
          "drops_served": served,
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "shared_block_hits",
              "completed", "admit_seconds", "step_seconds")}})
    check(stats["completed"] == len(requests) and stats["spec_steps"] > 0,
          "tp_mla: the run did not complete or verify")
    check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
          and forced.kv_equal == [True],
          "tp_mla: the forced preemption did not replay bitwise")
    check(served["ranks_keep_the_unsharded_pairs"],
          "tp_mla: the ranks' plans keep other pairs than the unsharded "
          "plan")
    check(equal, "tp_mla: tokens differ from the engine's requests served "
                 "alone")
    check(bitwise_equal(slot, got), "tp_mla: slot and paged tokens are not "
                                    "bitwise equal")
    check(engine.cache_shards() == TP, "tp_mla: cache_shards is not tp")
    plain = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    tp_tick_line("tp_mla_tick", tp_ticks(
        torch, {"tp1_eager": plain, f"tp{TP}_eager": engine},
        serve_requests(cfg.vocab_size)), smi, cfg, mla_tick_reduces)
    engine.close()
    del plain, engine, forced
    free_card(torch)
    # the dense head layer alone in f32 (~10 GB whole)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=1)
    tp_f32_check(torch, "tp_mla_f32", cfg32, requests, SERVE_MAX_LEN,
                 [p[:SERVE_CHUNK] for p in requests],
                 {"num_blocks": ROOMY_BLOCKS, "max_new": TP_NEW},
                 {"new": TP_NEW, "chunk": SERVE_CHUNK})
    emit({"phase": "tp_mla_done", "seconds": time.perf_counter() - t_phase})
    return counts


def phase_tp_hd(torch, smi, pool=None):
    """minicpm_2b's first TP_HD_DEPTH layers at full width (bf16, random
    weights from the seed) on TP_HD ranks of the card: the ranks do not
    divide its 36 heads or 36 kv heads, so every rank holds ``wq``,
    ``wk``, ``wv`` and ``wo`` whole and computes every head, while its
    caches hold 8 of head_dim's 64 lanes; its FFN columns and vocabulary
    rows are cut 8 ways.  Prefill and extend run K3 over every head and
    store the rank's lanes; decode and verify run the plain attention of
    the head_dim arm (partial scores summed over the ranks, the value
    contraction local, the output's lanes through their rows of ``wo``):
    K2 and K4 are not launched.  The serve workload's first
    TP_HD_REQUESTS requests for TP_NEW tokens through the Scheduler on a
    PagedBackend
    (chunk 256, speculate 4, prefix sharing) with one forced preemption:
    every rank's launches equal to the schedule with no decode kernel,
    the tokens bitwise each request served alone (``own_greedy``), rank
    0's lanes of the victim's K/V replayed bitwise.  Then the eager tick
    against the unsharded eager tick.  The 7 worker ranks start for this
    phase and stop after it, or go back to ``pool`` (the next phase's
    8-rank training mesh takes them).  Returns the launch counts of every
    rank."""
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    from repro_torch.sharding.group import WorkerPool
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(minicpm_config(), num_layers=TP_HD_DEPTH)
    check(cfg.num_heads % TP_HD and cfg.num_kv_heads % TP_HD
          and cfg.head_dim % TP_HD == 0,
          "tp_hd: minicpm_2b's heads no longer leave K/V on head_dim")
    requests = serve_requests(cfg.vocab_size)[:TP_HD_REQUESTS]
    blocks = 1 + SERVE_SLOTS * SERVE_MAX_LEN // SERVE_BLOCK
    own = pool is None
    pool = pool or WorkerPool()
    t0 = time.perf_counter()
    engine = tp_engine(torch, cfg, TP_HD, SERVE_MAX_LEN, pool=pool)
    start_s = time.perf_counter() - t0
    forced = ForcedPreemption(torch, limit=1)
    got, stats, counts, wall, per_rank, want = tp_serve(
        torch, engine, cfg, requests, blocks, None, max_new=TP_NEW,
        hook=forced.install)
    equal = bitwise_equal(got, own_greedy(torch, engine, requests, TP_NEW))
    emit({"phase": "tp_hd", "arch": cfg.name, "tp": TP_HD,
          "layers": cfg.num_layers, "heads_per_rank": cfg.num_heads,
          "kv_heads_per_rank": cfg.num_kv_heads,
          "head_dim_lanes_per_rank": cfg.head_dim // TP_HD,
          "cache_shards": engine.cache_shards(),
          "engine_start_s": start_s, "seconds": wall,
          "launches_per_rank": per_rank, "expected_launches": want,
          "bitwise_equal_to_own_greedy": equal,
          "forced_preemptions": len(forced.streamed),
          "victims_streamed_tokens": forced.streamed,
          "replays_kv_bitwise_rank0": sum(forced.kv_equal),
          "stats": {k: stats[k] for k in (
              "prefill_calls", "extend_prefills", "decode_steps",
              "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
              "replayed_tokens", "replay_steps", "shared_block_hits",
              "completed", "admit_seconds", "step_seconds")}})
    check(stats["completed"] == len(requests) and stats["spec_steps"] > 0,
          "tp_hd: the run did not complete or verify")
    check(len(forced.streamed) == 1 and stats["replay_steps"] > 0
          and forced.kv_equal == [True],
          "tp_hd: the forced preemption did not replay bitwise")
    check(equal, "tp_hd: tokens differ from the engine's requests served "
                 "alone")
    check(engine.cache_shards() == TP_HD, "tp_hd: cache_shards is not tp")
    plain = LLMEngine(cfg, max_len=SERVE_MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    # a layer: the head_dim arm's scores and its lanes' output sum, and
    # the FFN's sum
    tp_tick_line("tp_hd_tick", tp_ticks(
        torch, {"tp1_eager": plain, f"tp{TP_HD}_eager": engine},
        serve_requests(cfg.vocab_size)), smi, cfg, lambda k, f: 3)
    engine.close()
    if own:
        pool.close()
    del plain, engine, forced
    free_card(torch)
    emit({"phase": "tp_hd_done", "seconds": time.perf_counter() - t_phase})
    return counts


def greedy_gaps(torch, engine, toks, enc, steps):
    """An unsharded engine's greedy tokens over ``toks`` [B, S] with the
    encoder's frames ``enc``, and each step's logits: its prefill with
    ``enc_embeds``, then ``steps - 1`` decode steps."""
    x = torch.as_tensor(toks, device=engine.device).long()
    e = torch.as_tensor(enc, device=engine.device)
    logits, cache = engine.model.prefill(x, MAX_LEN, flags=engine.flags,
                                         enc_embeds=e)
    out, lg = [], []
    for i in range(steps):
        lg.append(logits[:, :engine.cfg.vocab_size].float())
        tok = torch.argmax(lg[-1], -1)
        out.append(tok)
        if i + 1 < steps:
            pos = torch.full((x.shape[0],), x.shape[1] + i,
                             dtype=torch.int32, device=engine.device)
            logits, cache = engine.model.decode_step(tok[:, None], cache,
                                                     pos, flags=engine.flags)
    return torch.stack(out, 1).cpu().numpy(), lg


def phase_tp_encdec(torch, smi):
    """seamless_m4t_large_v2 at full width, its first TP_ENCDEC_DEPTH
    encoder and decoder layers (bf16, random weights from the seed) at
    tp 2 on the card: a rank holds 8 of the
    16 heads and kv heads of every encoder, decoder and cross attention,
    half of each FFN and of the vocabulary, and its cross caches 8 kv
    heads of the 256 frames.  ``generate`` over encdec_main_path's 256
    stub frames and 16-token prompt for STUB_STEPS tokens: every rank's
    launches (K1 at every norm, K3 at each decoder layer's prefill, K2
    at each decode step's) held to the schedule, each row's tokens
    bitwise that row generated alone; the eager decode step's host ms
    and all-reduces.  Then TP_ENCDEC_F32_DEPTH encoder and decoder
    layers in f32 at tp 2 against tp 1: tokens equal where tp 1's top-2
    gap is wide, first-step logits within F32_MODEL_TOL or no further
    from an f64 run than tp 1 sits.  Returns the launch counts of every
    rank."""
    import numpy as np
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(encdec_config(), num_layers=TP_ENCDEC_DEPTH,
                              num_encoder_layers=TP_ENCDEC_DEPTH)
    toks, embeds = stub_inputs(torch, cfg)
    enc = embeds["enc_embeds"].cpu().numpy()
    engine = tp_engine(torch, cfg, TP, MAX_LEN)
    engine.rank_launches(reset=True)
    coll = engine.collectives
    c0 = coll.reduce_calls
    t0 = time.perf_counter()
    got = engine.generate(toks, STUB_STEPS, enc_embeds=enc)
    gen_s = time.perf_counter() - t0
    reduces = coll.reduce_calls - c0
    per_rank = engine.rank_launches(reset=True)
    alone = np.concatenate([engine.generate(toks[b:b + 1], STUB_STEPS,
                                            enc_embeds=enc[b:b + 1])
                            for b in range(toks.shape[0])])
    counts = {}
    for c in per_rank + engine.rank_launches():
        add_counts(counts, c)
    norms, attn = schedule(cfg)
    step_norms = norms + cfg.num_layers
    want = stub_launches(attn, 2 * cfg.num_encoder_layers + 1 + step_norms,
                         step_norms, STUB_STEPS - 1)
    # a decode step: the embedding, each decoder layer's self attention,
    # cross attention and FFN, the logits
    want_reduces = (2 + 2 * cfg.num_encoder_layers + 3 * cfg.num_layers
                    + (STUB_STEPS - 1) * (2 + 3 * cfg.num_layers))
    emit({"phase": "tp_encdec", "arch": cfg.name, "tp": TP,
          "heads_per_rank": cfg.num_heads // TP,
          "kv_heads_per_rank": cfg.num_kv_heads // TP,
          "encoder_frames": ENC_FRAMES, "prompt": list(toks.shape),
          "new_tokens": STUB_STEPS, "generate_seconds": gen_s,
          "all_reduces": reduces, "expected_all_reduces": want_reduces,
          "launches_per_rank": per_rank,
          "expected_launches": want, "tokens": got.tolist(),
          "rows_bitwise_alone": bool(np.array_equal(got, alone)),
          "cache_shards": engine.cache_shards(), "nvidia_smi": smi})
    check(all(c == want for c in per_rank),
          f"tp_encdec: a rank's launches {per_rank} != {want}")
    check(np.array_equal(got, alone), "tp_encdec: a row's tokens differ "
                                      "from the row generated alone")
    check(reduces == want_reduces, f"tp_encdec: {reduces} all-reduces, "
                                   f"not {want_reduces}")
    # the eager decode step against the unsharded eager step: lockstep
    # decode of the two rows after their prefill
    plain = LLMEngine(cfg, max_len=MAX_LEN, seed=SEED,
                      flags=RuntimeFlags(cuda_graphs=False))
    ticks = {}
    for name, e in (("tp1_eager", plain), (f"tp{TP}_eager", engine)):
        c = e.collectives
        r0 = (c.reduce_calls, c.reduce_s) if c else (0, 0.0)
        t0 = time.perf_counter()
        e.generate(toks, 2 * STUB_STEPS, enc_embeds=enc)
        dt = time.perf_counter() - t0
        ticks[name] = {"generate_ms": dt * 1e3,
                       "new_tokens": 2 * STUB_STEPS}
        if c:
            ticks[name].update({"all_reduces": c.reduce_calls - r0[0],
                                "all_reduce_ms": (c.reduce_s - r0[1]) * 1e3,
                                "all_reduce_share": (c.reduce_s - r0[1])
                                / dt})
    emit({"phase": "tp_encdec_tick", "nvidia_smi": smi, **ticks})
    engine.close()
    del plain, engine
    free_card(torch)

    # ---- f32 at a cut depth: tp 2 against tp 1 ---------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=TP_ENCDEC_F32_DEPTH,
                                num_encoder_layers=TP_ENCDEC_F32_DEPTH)
    one = LLMEngine(cfg32, max_len=MAX_LEN, seed=SEED)
    tp = tp_engine(torch, cfg32, TP, MAX_LEN)
    want_tok, lg = greedy_gaps(torch, one, toks, enc, STUB_STEPS)
    got32 = tp.generate(toks, STUB_STEPS, enc_embeds=enc)
    compared = mismatches = 0
    for b in range(toks.shape[0]):
        for i in range(STUB_STEPS):
            top2 = torch.topk(lg[i][b], 2).values
            if float(top2[0] - top2[1]) < TOP2_GAP:
                break
            compared += 1
            if got32[b, i] != want_tok[b, i]:
                mismatches += 1
                break
    w32 = dict(one.model.named_parameters())
    cfg64 = dataclasses.replace(cfg32, dtype="float64")
    x64 = LLMEngine(cfg64, {k: v.double() for k, v in w32.items()},
                    max_len=MAX_LEN, flags=RuntimeFlags(**PLAIN_FLAGS))
    V = cfg.vocab_size
    lg1 = one.prefill_logits(toks, enc_embeds=enc)[:, :V]
    lg2 = tp.prefill_logits(toks, enc_embeds=enc)[:, :V]
    lg64 = x64.prefill_logits(toks, enc_embeds=enc)[:, :V]
    err = float(np.abs(lg2 - lg1).max())
    floor = float(np.abs(lg1 - lg64).max())
    far = float(np.abs(lg2 - lg64).max())
    limit = max(F32_MODEL_TOL, floor)
    emit({"phase": "tp_encdec_f32", "tp": TP,
          "depth": [cfg32.num_encoder_layers, cfg32.num_layers],
          "tokens_compared": compared, "mismatches": mismatches,
          "top2_gap": TOP2_GAP, "logits_tp2_vs_tp1": err,
          "tp2_vs_f64": far, "tp1_vs_f64": floor, "limit": limit,
          "logit_scale": float(np.abs(lg64).max())})
    check(compared > 0 and mismatches == 0,
          "tp_encdec f32: a tp 2 token differs from tp 1's greedy where the "
          "top-2 gap is wide")
    check(err <= F32_MODEL_TOL or far <= limit,
          f"tp_encdec f32: logits {err} from tp 1's and {far} from the f64 "
          f"run, beyond {limit}")
    tp.close()
    del one, tp, x64, w32
    free_card(torch)
    emit({"phase": "tp_encdec_done",
          "seconds": time.perf_counter() - t_phase})
    return counts


# ---------------------------------------------------------------------------
# training: minicpm_2b at full width and depth, xlstm_1_3b at full width
# and depth, jamba_1_5_large_398b's first two layers at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm_2b"
TRAIN_PEAK_LR = 3e-4          # the launcher's default --lr
TRAIN_STEPS = 6               # timed steps (the median of steps 2-6)
FIT_STEPS = 8                 # steps on one fixed batch
#: [batch, sequence] of each train phase's steps, of the card-vs-CPU
#: step (the CPU runs the plain path at full width) and of the f32
#: forward checks
TRAIN_SHAPE = {TRAIN_ARCH: (8, 256), XLSTM_ARCH: (2, 512),
               JAMBA_ARCH: (1, 256)}
CPU_SHAPE = {TRAIN_ARCH: (1, 32), XLSTM_ARCH: (1, 512)}
#: xlstm_1_3b's finite-gradient checks (steps, one batch, card vs CPU)
#: run its first two layers (two mLSTM layers): at the reference's
#: random init its f32 gradient over 512 tokens is NaN from depth 8 on,
#: and from an mLSTM + sLSTM pair, in JAX as in the port
#: (``tools/xlstm_grad_growth.py``); the full-depth steps are timed
CPU_DEPTH = {TRAIN_ARCH: 2, XLSTM_ARCH: 2}
XLSTM_TRAIN_DEPTH = 2
#: layer groups of minicpm_2b's checkpoint round trip (cut from 40)
CHECKPOINT_DEPTH = 2
#: sLSTM's backward on the card against the CPU: an mLSTM + sLSTM pair
#: over 1 x 128 tokens (two of sLSTM's outer chunks of 64), its
#: recurrent weights ``w_h`` scaled by 0.1 as the CPU tests' chunkwise
#: sLSTM check scales them.  At the reference's init the pair's f32
#: gradient is ill conditioned from a few tokens on: on the CPU its
#: sLSTM leaves sit 0.13-0.16 of their norm from an f64 run at 16
#: tokens, its grad norm reads 1603 against 3408 in f64 at 32
#: (``tools/train_f32_floor.py``), and it is inf at 128
#: (``tools/xlstm_grad_growth.py --pattern mlstm slstm``); scaled,
#: every leaf is within 4.0e-4 of the f64 run at 128 tokens.
PAIR_PATTERN = ("mlstm", "slstm")
PAIR_SHAPE = (1, 128)
PAIR_W_H_SCALE = 0.1

F32_FORWARD_SHAPE = {TRAIN_ARCH: (2, 256), XLSTM_ARCH: (1, 512)}
#: xlstm_1_3b's forward-vs-prefill check runs one layer group (7 mLSTM
#: + 1 sLSTM): at these random weights f32 rounding grows with depth to
#: O(1) logits at 48 layers, in either form, from an f64 run
FORWARD_DEPTH = {XLSTM_ARCH: 8}
#: the card's train step against the CPU's in f32: loss and grad norm
#: relative, params of the leaf's scale where |g| > 1e-3 of its largest
TRAIN_CPU_TOL = 1e-4
#: a card gradient leaf this near the f64 leaf (by norm) passes whatever
#: the CPU's distance: on an H100 the mLSTM + sLSTM pair's mLSTM leaves
#: sat 1.0-1.4e-4 of their norm from f64 on the card and 3.5e-5 on the
#: CPU, two f32 accumulation orders; an error in a backward formula
#: moves a leaf by O(1)
TRAIN_GRAD_NEAR = 1e-3


def minicpm_config():
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
           cfg.d_ff, cfg.padded_vocab, cfg.tie_embeddings, cfg.dtype,
           cfg.lr_schedule, cfg.optimizer)
          == (40, 2304, 36, 64, 5760, 122880, True, "bfloat16", "wsd",
              "adamw"), f"{TRAIN_ARCH} is not at full width and depth")
    return cfg


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def train_batch(torch, cfg, index, shape, device=None):
    """Batch ``index`` of the port's copy of the synthetic data pipeline
    (``data/pipeline.py``): [B, S] tokens and labels on ``device``."""
    from repro_torch.data import SyntheticTextDataset
    B, S = shape
    b = SyntheticTextDataset(cfg.vocab_size, S, SEED).batch(index, B)
    return {k: torch.as_tensor(v, device=device or DEVICE).long()
            for k, v in b.items()}


def launcher_schedule(cfg, steps):
    """The schedule ``launch/train.py`` builds for ``steps`` steps."""
    from repro_torch.optim import make_schedule
    return make_schedule(cfg.lr_schedule, peak_lr=TRAIN_PEAK_LR,
                         warmup=max(steps // 20, 5), total=steps)


def zero_launches():
    from repro_torch.kernels import build
    for name in build.launches:
        build.launches[name] = 0


def train_flops(cfg, model, B, S):
    """(the step's flops, the weight products' parameters N) from the
    shapes: 2 N T for the products (leaves of two or more dims; the
    embedding counts as the tied LM head, or not at all as a lookup;
    MoE expert leaves at top-k of their experts), causal attention
    2 B S^2 H hd a layer (the half of its score and value products that
    the mask keeps), mLSTM's chunk products 4 B S L H hd a layer (L the
    chunk), x 3 for the backward, plus the group remat's second
    forward."""
    from repro_torch.models.params import flatten
    n = 0
    for path, p in flatten(model.params).items():
        if p.dim() < 2 or (path == "embed.embedding"
                           and not cfg.tie_embeddings):
            continue
        k = p.numel()
        if cfg.num_experts and ".ffn.w_" in path and p.dim() >= 3:
            k = k * cfg.num_experts_per_tok // p.shape[-3]
        n += k
    kinds = cfg.layer_kinds()
    attn = 2 * B * S * S * cfg.num_heads * cfg.head_dim \
        * kinds.count("attn")
    hd = 2 * cfg.d_model // cfg.num_heads
    mlstm = 4 * B * S * min(cfg.mlstm_chunk, S) * cfg.num_heads * hd \
        * kinds.count("mlstm")
    return 4 * (2 * n * B * S + attn + mlstm), n


def grad_check(torch, step, params, batch):
    """Every leaf's gradient of ``step.loss_fn`` by autograd: the leaves
    whose gradient is not finite or all zero (a path cut off from the
    loss leaves its leaves at zero), and the leaves, grads set."""
    from repro_torch.models.params import flatten
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
        p.grad = None
    loss, _ = step.loss_fn(params, batch)
    loss.backward()
    bad = [k for k, p in leaves.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    return bad, leaves


def refuses_kernel_flags(torch, model, cfg):
    """``make_train_step(flags=DEFAULT_FLAGS)`` raises at its first
    kernel op, which has no backward (F3)."""
    from repro_torch.models.transformer import DEFAULT_FLAGS
    from repro_torch.runtime.steps import make_train_step
    step, init = make_train_step(model, schedule=launcher_schedule(cfg, 1),
                                 flags=DEFAULT_FLAGS, optimizer="adafactor")
    try:
        step(init(model.params), train_batch(torch, cfg, 0, (1, 16)))
    except RuntimeError as e:
        return "no backward" in str(e)
    return False


def train_numbers(torch, cfg, model, shape, ms, smi, per):
    """Step ms (the median of steps 2 .., or step 1's alone), tokens/s,
    peak memory, the flops bound and the device's busy share."""
    B, S = shape
    flops, n = train_flops(cfg, model, B, S)
    step_ms = statistics.median(ms[1:] or ms)
    share = device_share(per, step_ms, ())
    return {"step_ms": ms, "median_step_ms": step_ms,
            "tokens_per_step": B * S,
            "tokens_per_s": B * S / step_ms * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated()
            if DEVICE == "cuda" else None,
            "matmul_params": n, "step_flops": flops,
            "bound_ms": flops / BF16_FLOPS * 1e3, "bound_by": "operations",
            "peak": "H100 SXM dense bf16, 989 TFLOP/s",
            "bound_share": flops / BF16_FLOPS * 1e3 / step_ms,
            "device_ms_per_step": share["device_ms_per_tick"],
            "device_busy_share": share["device_busy_share"],
            "profiler": share["profiler"],
            "top_kernels_ms": dict(sorted(per.items(), key=lambda kv: -kv[1])
                                   [:12]),
            "nvidia_smi": smi}


def train_steps(torch, smi, cfg, arch, phase, rec=None):
    """The bf16 train step of ``cfg`` with its own optimizer and
    schedule as the launcher builds them (checks 2 and 6): the kernel
    flags refused, every leaf's gradient finite and non-zero, then
    TRAIN_STEPS steps on batches 0 .. with every launch counter at 0
    first (none may launch), finite losses and aux losses, finite grad
    norms (or inf where, as in JAX's arithmetic, a gradient element's
    square overflows the f32 sum: xlstm_1_3b's random weights give
    gradients past 1e19 from depth 8), and the numbers; ``rec`` (a
    ``RouteRecorder``) wraps the steps.
    Emits the phase line; returns (the model, the state, the line)."""
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import make_train_step
    shape = TRAIN_SHAPE[arch]
    t0 = time.perf_counter()
    model = Model(cfg, device=DEVICE, seed=SEED)
    sync(torch)
    init_s = time.perf_counter() - t0
    refused = refuses_kernel_flags(torch, model, cfg)
    step, init = make_train_step(model, schedule=launcher_schedule(
        cfg, TRAIN_STEPS))
    bad, _ = grad_check(torch, step, model.params,
                        train_batch(torch, cfg, 0, shape))
    g_max = max(float(p.grad.float().abs().max()) for p in model.parameters())
    for p in model.parameters():
        p.grad = None
    free_card(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init(model.params)
    losses, gnorms, aux, ms = [], [], [], []
    zero_launches()
    with (rec or contextlib.nullcontext()):
        for i in range(TRAIN_STEPS):
            batch = train_batch(torch, cfg, i, shape)
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(m["grad_norm"]))
            aux.append(float(m["aux"]))
    counts = dict(build.launches)
    batch = train_batch(torch, cfg, TRAIN_STEPS, shape)
    per = profiled_ms(torch, lambda: step(state, batch), 1)
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "optimizer": cfg.optimizer, "schedule": cfg.lr_schedule,
            "params": sum(p.numel() for p in model.parameters()),
            "shape": list(shape), "init_seconds": init_s,
            "losses": losses, "grad_norms": gnorms, "aux": aux,
            "launches": counts, "leaves_without_grad": bad,
            "grad_max_abs": g_max, "kernel_flags_refused": refused,
            **train_numbers(torch, cfg, model, shape, ms, smi, per)}
    emit(line)
    if phase == "train_main_path":
        COST_STEPS.append(train_cost(cfg, shape, line))
    # the grad norm sums each leaf's squares in f32, as JAX does: a
    # gradient element past sqrt(f32 max) overflows it to inf there too
    overflow = g_max > math.sqrt(torch.finfo(torch.float32).max)
    check(all(map(math.isfinite, losses + aux)) and (
        all(map(math.isfinite, gnorms)) or overflow)
        and not any(math.isnan(g) for g in gnorms),
        f"{phase}: a loss, aux or grad norm is not finite")
    check(not bad, f"{phase}: leaves without a finite non-zero gradient: "
                   f"{bad}")
    check(not any(counts.values()), f"{phase}: the train steps launched "
                                    f"kernels: {counts}")
    check(refused, f"{phase}: make_train_step(flags=DEFAULT_FLAGS) did not "
                   f"raise")
    return model, state, line


def fit_one_batch(torch, model, cfg, shape):
    """FIT_STEPS steps on batch 0 from a fresh optimizer state, the
    schedule the launcher builds for them: (the losses, the first being
    the loss at step 0; the state; the step)."""
    from repro_torch.runtime.steps import make_train_step
    step, init = make_train_step(model, schedule=launcher_schedule(
        cfg, FIT_STEPS))
    state = init(model.params)
    batch = train_batch(torch, cfg, 0, shape)
    losses = []
    for _ in range(FIT_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state, step


def _step_on(torch, model, schedule, batch, flags=None, on_grad=None):
    """One train step of ``model`` from a fresh optimizer state on
    ``batch`` (moved to the model's device), in true f32 on the card,
    each gradient its backward accumulates read as it is made (a hook a
    leaf): (the state after the step, the metrics as floats, the step's
    seconds, the gradients in f64 on DEVICE, where the comparisons run;
    a leaf autograd never reached reads as zeros).  ``on_grad(path,
    gradient)`` instead: called with each gradient, none kept (a
    full-width model's, which the card cannot hold twice over)."""
    from repro_torch.models.layers import no_tf32
    from repro_torch.models.params import flatten
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.models.transformer import TRAIN_FLAGS
    step, init = make_train_step(model, schedule=schedule,
                                 flags=flags or TRAIN_FLAGS)
    batch = {k: v.to(model.device) for k, v in batch.items()}
    leaves, grads = flatten(model.params), {}

    def keep(k):
        def hook(p):
            if on_grad is not None:
                on_grad(k, p.grad.detach())
            else:
                grads[k] = p.grad.detach().to(DEVICE).double()
        return hook
    hooks = [p.requires_grad_(True).register_post_accumulate_grad_hook(
        keep(k)) for k, p in leaves.items()]
    with no_tf32(model.device):
        t0 = time.perf_counter()
        state, m = step(init(model.params), batch)
        if model.device.type == "cuda":
            sync(torch)
        seconds = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    if on_grad is None:
        for k, p in leaves.items():
            grads.setdefault(k, torch.zeros(p.shape, dtype=torch.float64,
                                            device=DEVICE))
    return state, {k: float(v) for k, v in m.items()}, seconds, grads


def _params64(torch, params):
    """Each leaf of a param tree in f64 on DEVICE."""
    from repro_torch.models.params import flatten
    return {k: v.detach().to(DEVICE, torch.float64)
            for k, v in flatten(params).items()}


def _agree(a, b, x, tol):
    """``a`` (the card) against ``b`` (the CPU): equal, within ``tol``
    relative, or (the f32 floor) no further from the f64 reading ``x``
    than twice ``b`` is."""
    return (a == b or abs(a - b) <= tol * abs(b)
            or abs(a - x) <= 2 * abs(b - x))


def _leaves_agree(card, cpu, f64, tol, near, keep=None):
    """Leaf by leaf, the card's leaf against the CPU's: within ``tol`` of
    the CPU leaf's largest magnitude, or else no further from the f64
    leaf than twice the CPU's or than ``near``, each distance the norm
    of the difference over the f64 leaf's norm (floored at 1e-6 of the
    tree's, for a leaf whose exact value is zero).  ``keep`` (a mask a
    leaf) limits a leaf to those elements.  The trees may sit on the
    host in any dtype: each leaf is compared on the card in f64.
    Returns (the leaves that disagree, the largest direct distance and
    its leaf)."""
    def on(t):
        return t.to(DEVICE).double()
    floor = 1e-6 * math.sqrt(sum(float((on(v) ** 2).sum())
                                 for v in f64.values()))
    bad, worst, where = [], 0.0, None
    for k, x in f64.items():
        a, b, x = on(card[k]), on(cpu[k]), on(x)
        if keep is not None:
            m = keep[k].to(DEVICE)
            if not m.any():
                continue
            a, b, x = a[m], b[m], x[m]
        d = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if d > worst:
            worst, where = d, k
        if d <= tol:
            continue
        n = max(float(x.norm()), floor)
        a_x, b_x = float((a - x).norm()) / n, float((b - x).norm()) / n
        if a_x > max(2 * b_x, near):
            bad.append([k, d, a_x, b_x])
    return bad, worst, where


def card_vs_cpu(torch, cfg, depth, shape, pattern=None, w_h_scale=None):
    """One f32 step at full width and ``depth`` layers (``pattern``: the
    block pattern, else the model's own) on the card and the same step
    in the port on the CPU, from the same weights (``w_h_scale`` scales
    the sLSTM layers' recurrent weights) and batch: loss and grad norm
    within TRAIN_CPU_TOL relative; every gradient leaf on the card
    finite and non-zero, and within TRAIN_CPU_TOL of the CPU leaf's
    largest (or, below, within TRAIN_GRAD_NEAR of the f64 run); the
    updated params within TRAIN_CPU_TOL of each leaf's
    scale wherever the f64 run's gradient exceeds 1e-3 of the leaf's
    largest (a first Adam step is about sign(g)).  Where f32 rounding
    alone parts them further, as it does at these random weights
    (minicpm_2b's attention scores reach ~4e3 at its init, so its softmax
    is saturated: ``tools/train_f32_floor.py``), each reading is held to
    the same step in f64 on the card: the card's no further from it than
    twice the CPU's (the CPU tests' rule against JAX), leaf by leaf for
    the gradients and params.  ``grad_gap_leaves``: the leaves whose
    squared norms part the card's grad norm from the CPU's the most.
    The card's products run in true f32."""
    from repro_torch.models.model import Model
    cut = dict(num_layers=depth, dtype="float32")
    if pattern:
        cut["block_pattern"] = pattern
    cfg32 = dataclasses.replace(cfg, **cut)
    schedule = launcher_schedule(cfg32, TRAIN_STEPS)
    batch = train_batch(torch, cfg32, 0, shape, device="cpu")
    card = Model(cfg32, device=DEVICE, seed=SEED)
    w = {k: v.detach().cpu().clone() for k, v in card.named_parameters()}
    if w_h_scale is not None:
        for k in w:
            if k.endswith(".mixer.w_h"):
                w[k] *= w_h_scale
        del card
        card = Model(cfg32, device=DEVICE,
                     params={k: v.clone() for k, v in w.items()})
    st, cm, card_s, cg = _step_on(torch, card, schedule, batch)
    cp = _params64(torch, st.params)
    del card, st
    free_card(torch)
    st, xm, _, xg = _step_on(torch, Model(
        dataclasses.replace(cfg32, dtype="float64"), device=DEVICE,
        params={k: v.double() for k, v in w.items()}), schedule, batch)
    xp = _params64(torch, st.params)
    del st
    free_card(torch)
    st, pm, cpu_s, pg = _step_on(torch, Model(cfg32, device="cpu",
                                              params=w), schedule, batch)
    pp = _params64(torch, st.params)
    del st
    out = {"depth": depth, "layer_kinds": cfg32.layer_kinds(),
           "shape": list(shape), "w_h_scale": w_h_scale,
           "card_step_s": card_s, "cpu_step_s": cpu_s,
           "tol": TRAIN_CPU_TOL}
    ok = True
    for k in ("loss", "grad_norm"):
        out[k] = {"card": cm[k], "cpu": pm[k], "f64": xm[k]}
        ok = ok and _agree(cm[k], pm[k], xm[k], TRAIN_CPU_TOL)
    unfit = [k for k, g in cg.items()
             if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    gbad, gworst, gwhere = _leaves_agree(cg, pg, xg, TRAIN_CPU_TOL,
                                         TRAIN_GRAD_NEAR)
    keep = {k: g.abs() > 1e-3 * g.abs().max() for k, g in xg.items()}
    pbad, pworst, pwhere = _leaves_agree(cp, pp, xp, TRAIN_CPU_TOL,
                                         TRAIN_CPU_TOL, keep)
    gap = sorted(((abs(float((cg[k] ** 2).sum() - (pg[k] ** 2).sum())), k)
                  for k in cg), reverse=True)[:3]
    out.update({
        "leaves_without_finite_grad": unfit,
        "grads_rel": gworst, "grads_worst_leaf": gwhere,
        "grads_disagree": gbad,
        "grad_gap_leaves": [{"leaf": k, "sq_norm_gap": d,
                             "norm": {"card": float(cg[k].norm()),
                                      "cpu": float(pg[k].norm()),
                                      "f64": float(xg[k].norm())}}
                            for d, k in gap],
        "params_rel": pworst, "params_worst_leaf": pwhere,
        "params_disagree": pbad})
    out["ok"] = ok and not unfit and not gbad and not pbad
    return out


def checkpoint_roundtrip(torch, step, state, cfg, shape):
    """Save the TrainState under ``build/`` and load it back: every leaf
    bitwise equal; the next step from the loaded state gives bitwise the
    loss of the next step from the state itself.  Frees ``state``."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.checkpoint.store import _flatten_with_paths
    directory = ROOT / "build" / "train_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_checkpoint(str(directory), int(state.opt.step), state)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    back = load_checkpoint(str(directory), None, state)
    sync(torch)
    load_s = time.perf_counter() - t0
    pairs = list(zip(_flatten_with_paths(state), _flatten_with_paths(back)))
    equal = all(ka == kb and a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b) for (ka, a), (kb, b) in pairs)
    batch = train_batch(torch, cfg, FIT_STEPS + 1, shape)
    _, m = step(state, batch)
    want = float(m["loss"])
    del state, m
    free_card(torch)
    _, m = step(back, batch)
    got = float(m["loss"])
    del back, m
    shutil.rmtree(directory, ignore_errors=True)
    return {"leaves": len(pairs), "bytes": nbytes, "save_s": save_s,
            "load_s": load_s, "leaves_bitwise_equal": equal,
            "next_loss": [want, got], "next_loss_bitwise": want == got}


#: the launcher's run: steps and batch (cut from 8 x 256 to fit the
#: run's time limit).  Its rc is 0 where the mean loss of the last five
#: steps is below the first five's: at 20 steps of 8 x 256 the loss fell
#: 12.17 -> 12.08 on an H100, against a spread of ~0.01 of a mean of
#: five 4 x 256 batches
LAUNCHER_STEPS = 12
LAUNCHER_SHAPE = (4, 256)


def train_launcher(torch):
    """``python -m repro_torch.launch.train --host-mesh`` on minicpm_2b at
    full width and depth in a subprocess: on the one card
    ``make_host_mesh()`` is a 1 x 1 mesh, which trains the unsharded step
    (the run without the flag takes the same path past the mesh).  Its
    rc, last lines and wall seconds."""
    import os
    B, S = LAUNCHER_SHAPE
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--steps", str(LAUNCHER_STEPS), "--batch", str(B),
            "--seq", str(S), "--host-mesh"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, env=env,
                       timeout=600, cwd=str(ROOT))
    return {"phase": "train_launcher", "argv": argv[1:], "rc": r.returncode,
            "seconds": time.perf_counter() - t0,
            "stdout": r.stdout.strip().splitlines()[-6:],
            "stderr": r.stderr.strip().splitlines()[-4:]}


def f32_forward_check(torch, cfg, arch, against_prefill=False):
    """The no-grad ``forward`` in f32 at full width and depth: with the
    kernel flags against the plain path (``against_prefill`` False: the
    K1 and K3 launches counted: held at F32_MODEL_TOL or, where the f32
    plain path sits further than that from an f64 run of the plain
    forward on the same weights, at that distance, as the stub models'
    f32 checks are held), or
    the plain chunkwise forward's last position against the
    token-by-token serving ``prefill`` on the same weights (each form
    within F32_MODEL_TOL of the logit scale from the f64 run: on an
    H100 the serving form sat 1.0e-3 and the chunkwise 3.6e-4 from it at
    a scale of 4.2, xlstm_1_3b's first layer group over 512 tokens).
    Returns (the phase line's fields, the launch counts)."""
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import TRAIN_FLAGS
    shape = F32_FORWARD_SHAPE[arch]
    toks = train_batch(torch, cfg, 0, shape)["tokens"]
    V = cfg.vocab_size
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=DEVICE,
                seed=SEED)
    with torch.no_grad():
        plain = m32.forward(toks, flags=TRAIN_FLAGS)[0][..., :V]
        zero_launches()
        if against_prefill:
            plain = plain[:, -1]
            got = m32.prefill(toks, shape[1], flags=TRAIN_FLAGS)[0][:, :V]
        else:
            got = m32.forward(toks)[0][..., :V]
        sync(torch)
        counts = dict(build.launches)
        got, plain = got.cpu(), plain.cpu()
        w64 = {k: v.detach().double() for k, v in m32.named_parameters()}
        del m32
        free_card(torch)
        m64 = Model(dataclasses.replace(cfg, dtype="float64"),
                    device=DEVICE, params=w64)
        del w64
        exact = m64.forward(toks, flags=TRAIN_FLAGS)[0][..., :V].cpu()
        del m64
        free_card(torch)
    if against_prefill:
        exact = exact[:, -1]
    err = float((got - plain).abs().max())
    plain_x = float((plain.double() - exact).abs().max())
    got_x = float((got.double() - exact).abs().max())
    scale = float(exact.abs().max())
    if against_prefill:
        # two algorithms, each held to the f64 run at F32_MODEL_TOL of
        # its logit scale: a formula error moves one by O(1)
        ok = max(got_x, plain_x) <= F32_MODEL_TOL * scale
    else:
        ok = err <= max(F32_MODEL_TOL, plain_x)
    return {"shape": list(shape), "layers": cfg.num_layers,
            "max_abs_logit_err": err,
            "plain_vs_f64": plain_x, "read_vs_f64": got_x,
            "logit_scale": scale, "tol": F32_MODEL_TOL,
            "finite": bool(torch.isfinite(got).all()),
            "ok": ok and bool(torch.isfinite(got).all())}, counts


def phase_train_main_path(torch, smi):
    """minicpm_2b at full width and depth (40 layers, d_model 2304, bf16,
    random weights from the seed): (1) the no-grad ``forward`` with K1
    and K3 against the plain ``forward`` in f32 at full depth, K1 at
    2L + 1 and K3 at L launches; (2, 6) the train step on the plain path
    (AdamW, WSD as the launcher builds it, peak 3e-4) over batches of
    8 x 256 from the synthetic pipeline: no kernel launch, finite
    losses, every leaf's gradient finite and non-zero, the kernel flags
    refused, the step's numbers; (4) FIT_STEPS steps on one batch lower
    its loss; (5) a checkpoint of the TrainState round trip bitwise (on
    the first CHECKPOINT_DEPTH layer groups, after FIT_STEPS steps); (3)
    one f32 step at depth 2 on the card against the CPU; (7) the
    launcher in a subprocess.  Returns the launch counts."""
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    cfg = minicpm_config()
    L = cfg.num_layers
    fwd, counts = f32_forward_check(torch, cfg, TRAIN_ARCH)
    want = {name: 0 for name in build.launches}
    want.update({"rmsnorm": 2 * L + 1, "flash_attention": L})
    emit({"phase": "train_forward_vs_plain", "arch": cfg.name,
          "launches": counts, "expected_launches": want, **fwd})
    check(counts == want, f"train forward: launch counts {counts} != {want}")
    check(fwd["ok"], "train forward: the kernel path disagrees with the "
                     "plain path")
    model, state, line = train_steps(torch, smi, cfg, TRAIN_ARCH,
                                     "train_main_path")
    del state
    free_card(torch)
    shape = TRAIN_SHAPE[TRAIN_ARCH]
    fit, state, step = fit_one_batch(torch, model, cfg, shape)
    emit({"phase": "train_fit_one_batch", "arch": cfg.name, "losses": fit})
    check(fit[-1] < fit[0], f"{cfg.name}: the loss on one batch did not "
                            f"fall in {FIT_STEPS} steps: {fit}")
    del model, state, step
    free_card(torch)
    # the checkpoint round trip on CHECKPOINT_DEPTH layer groups (the full
    # depth's 27 GB through the disk took 44 s of the run's budget), after
    # FIT_STEPS steps so that the optimizer state is not its init
    cfg_ck = dataclasses.replace(cfg, num_layers=CHECKPOINT_DEPTH)
    model = Model(cfg_ck, device=DEVICE, seed=SEED)
    _, state, step = fit_one_batch(torch, model, cfg_ck, shape)
    ck = checkpoint_roundtrip(torch, step, state, cfg_ck, shape)
    emit({"phase": "train_checkpoint", "arch": cfg.name,
          "layers": CHECKPOINT_DEPTH, **ck})
    check(ck["leaves_bitwise_equal"] and ck["next_loss_bitwise"],
          "train checkpoint: the round trip is not bitwise")
    del model, state, step
    free_card(torch)
    cmp = card_vs_cpu(torch, cfg, CPU_DEPTH[TRAIN_ARCH],
                      CPU_SHAPE[TRAIN_ARCH])
    emit({"phase": "train_card_vs_cpu", "arch": cfg.name, **cmp})
    check(cmp["ok"], "train: the card's f32 step disagrees with the CPU's")
    free_card(torch)
    launch = train_launcher(torch)
    emit(launch)
    check(launch["rc"] == 0, f"the train launcher exited {launch['rc']}")
    return counts


def full_depth_steps(torch, smi, cfg, arch, phase):
    """One bf16 train step of ``cfg`` on batch 0, every launch counter at
    0 first (none may launch), timed (the first step of the model,
    allocations included) beside its bound; not profiled: the profiler
    takes minutes over the ~4e5 launches of xlstm_1_3b's step (its
    sLSTM layers' token loops).  Holds the step's loss (computed before
    the update) finite and records whether the gradients were: at the
    reference's random init xlstm_1_3b's are NaN at full depth, in JAX
    as in the port.  Emits the phase line."""
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import make_train_step
    shape = TRAIN_SHAPE[arch]
    t0 = time.perf_counter()
    model = Model(cfg, device=DEVICE, seed=SEED)
    sync(torch)
    init_s = time.perf_counter() - t0
    step, init = make_train_step(model, schedule=launcher_schedule(
        cfg, TRAIN_STEPS))
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init(model.params)
    zero_launches()
    batch = train_batch(torch, cfg, 0, shape)
    sync(torch)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    gnorm = float(m["grad_norm"])
    counts = dict(build.launches)
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "optimizer": cfg.optimizer, "schedule": cfg.lr_schedule,
            "params": sum(p.numel() for p in model.parameters()),
            "shape": list(shape), "init_seconds": init_s, "loss": loss,
            "grad_norm": gnorm, "grads_finite": math.isfinite(gnorm),
            "launches": counts,
            **train_numbers(torch, cfg, model, shape, [ms], smi, {})}
    emit(line)
    check(math.isfinite(loss), f"{phase}: the first loss is not finite")
    check(not any(counts.values()), f"{phase}: the train step launched "
                                    f"kernels: {counts}")
    del model, state, step
    free_card(torch)


def phase_train_recurrent(torch, smi):
    """xlstm_1_3b at full width (d_model 2048, bf16), AdamW with the
    cosine schedule, batches of 2 x 512 (two mLSTM chunks of 256, so the
    state carries between chunks): the chunkwise ``forward``'s
    last-position logits against the token-by-token serving ``prefill``
    in f32 over one layer group (7 mLSTM + 1 sLSTM); one train step on
    the first XLSTM_TICK_DEPTH layers, timed; the train steps and
    their numbers, FIT_STEPS steps on one batch and one f32 step on the
    card against the CPU on the first XLSTM_TRAIN_DEPTH layers, where
    the reference's gradient is finite; one f32 step of an mLSTM +
    sLSTM pair on the card against the CPU (PAIR_*), so that sLSTM's
    backward with its outer-chunk checkpoints is held finite and to the
    CPU on the card.  Returns the launch counts (the prefill launches
    none: plain flags)."""
    cfg = xlstm_config()
    fwd, counts = f32_forward_check(
        torch, dataclasses.replace(cfg, num_layers=FORWARD_DEPTH[XLSTM_ARCH]),
        XLSTM_ARCH, against_prefill=True)
    emit({"phase": "train_recurrent_forward_vs_prefill", "arch": cfg.name,
          "launches": counts, **fwd})
    check(fwd["ok"], "xlstm: the chunkwise forward disagrees with the "
                     "token-by-token prefill")
    full_depth_steps(torch, smi, dataclasses.replace(
        cfg, num_layers=XLSTM_TICK_DEPTH), XLSTM_ARCH, "train_recurrent")
    cut = dataclasses.replace(cfg, num_layers=XLSTM_TRAIN_DEPTH)
    model, state, _ = train_steps(torch, smi, cut, XLSTM_ARCH,
                                  "train_recurrent_depth2")
    del state
    free_card(torch)
    fit, state, _ = fit_one_batch(torch, model, cut, TRAIN_SHAPE[XLSTM_ARCH])
    emit({"phase": "train_recurrent_fit_one_batch", "arch": cfg.name,
          "layers": cut.num_layers, "losses": fit})
    check(fit[-1] < fit[0], f"{cfg.name}: the loss on one batch did not "
                            f"fall in {FIT_STEPS} steps: {fit}")
    del model, state
    free_card(torch)
    cmp = card_vs_cpu(torch, cfg, CPU_DEPTH[XLSTM_ARCH],
                      CPU_SHAPE[XLSTM_ARCH])
    emit({"phase": "train_recurrent_card_vs_cpu", "arch": cfg.name, **cmp})
    check(cmp["ok"], "xlstm: the card's f32 step disagrees with the CPU's")
    free_card(torch)
    cmp = card_vs_cpu(torch, cfg, len(PAIR_PATTERN), PAIR_SHAPE,
                      pattern=PAIR_PATTERN, w_h_scale=PAIR_W_H_SCALE)
    emit({"phase": "train_recurrent_pair_card_vs_cpu", "arch": cfg.name,
          **cmp})
    check(cmp["ok"], "xlstm: the card's f32 step of an mLSTM + sLSTM pair "
                     "disagrees with the CPU's")
    free_card(torch)
    return counts


def phase_train_hybrid(torch, smi):
    """jamba_1_5_large_398b's first two layers at full width (attention
    + dense FFN, Mamba + MoE FFN of 16 experts top-2; ~24 GB of bf16
    weights and as many of gradients), Adafactor, batches of 1 x 256
    (two Mamba chunks of 128): the train steps and their numbers, the
    aux loss finite and above 0, the capacity drops of the steps'
    routing counted (Hazard 7), Adafactor's state factored for every
    leaf ``_factored`` admits, FIT_STEPS steps on one batch.  Returns
    the launch counts (none)."""
    from repro_torch.models.params import flatten
    from repro_torch.optim.optimizers import _factored
    cfg = jamba_config()
    B, S = TRAIN_SHAPE[JAMBA_ARCH]
    rec = RouteRecorder(lambda n: n == B * S)
    model, state, line = train_steps(torch, smi, cfg, JAMBA_ARCH,
                                     "train_hybrid", rec=rec)
    v = flatten(state.opt.v)
    factored = {k: isinstance(v[k], tuple) == _factored(tuple(p.shape))
                for k, p in flatten(state.params).items()}
    emit({"phase": "train_hybrid_moe_and_state", "arch": cfg.name,
          "aux": line["aux"], "drops": moe_drops(rec.calls, cfg, B * S),
          "factored_leaves": sum(isinstance(x, tuple) for x in v.values()),
          "leaves": len(v), "factored_as_admitted": all(factored.values()),
          "opt_state_bytes": sum(
              sum(t.numel() * t.element_size() for t in
                  (x if isinstance(x, tuple) else (x,)))
              for x in v.values())})
    check(all(a > 0 for a in line["aux"]), "jamba: an aux loss is not above 0")
    check(all(factored.values()), "jamba: Adafactor's state is not factored "
                                  "as _factored admits")
    del state
    free_card(torch)
    fit, state, _ = fit_one_batch(torch, model, cfg, (B, S))
    emit({"phase": "train_hybrid_fit_one_batch", "arch": cfg.name,
          "losses": fit})
    check(fit[-1] < fit[0], f"{cfg.name}: the loss on one batch did not "
                            f"fall in {FIT_STEPS} steps: {fit}")
    del model, state
    free_card(torch)
    return {}


# ---------------------------------------------------------------------------
# training on a mesh (ROADMAP item 11c-i): ranks sharing the one card
# ---------------------------------------------------------------------------

MESH_DEVICE = "cuda:0"
#: minicpm_2b on a (data 2, model 2) mesh: depth (cut from 40), batch,
#: steps
TRAIN_MESH_DEPTH = 2
TRAIN_MESH_SHAPE = (4, 256)
TRAIN_MESH_STEPS = 1
#: the f32 checks: one mesh step at this depth and batch against the
#: unsharded step
MESH_F32_DEPTH = 1
MESH_F32_SHAPE = (2, 64)
#: the same mesh step in f64 against the unsharded f64 step: relative,
#: and of a param leaf's largest.  Not f64's rounding: the CE runs in
#: f32 in both (as JAX's casts the logits to f32), and the grad norm sums
#: f32 squares, in another order on the mesh
MESH_F64_TOL = 1e-6
#: minicpm_2b's 36 heads do not divide 8 model ranks: the sequence arm
TRAIN_SEQ_RANKS = 8
#: granite_moe_3b_a800m on (data 2, model 2): depth (cut from 32) and two
#: batches, one a branch of JAX's expert parallelism: 4 x 256 = 1024
#: tokens > 16 x 48 (``_moe_ep``, each data shard its own capacity) and
#: 2 x 256 = 512 <= 768 (``_moe_ep_decode``, the global capacity)
TRAIN_EP_DEPTH = 2
TRAIN_EP_SHAPES = ((4, 256), (2, 256))
TRAIN_EP_F32_SHAPE = (4, 256)
#: the training meshes' workers, shared by their phases
TRAIN_POOL = None


def training_mesh(shape):
    """A ("data", "model") training mesh of ranks on the one card."""
    from repro_torch.launch.mesh import TrainingMesh
    return TrainingMesh((MESH_DEVICE,) * math.prod(shape),
                        ("data", "model"), tuple(shape))


def mesh_flags(shape, ep=False):
    """JAX's production flags at this mesh's sizes."""
    kw = {"batch_axes": ("data",), "batch_divisor": shape[0],
          "model_size": shape[1]}
    if ep:
        kw["moe_impl"] = "ep"
    return kw


def mesh_traffic(reports):
    """Every rank's collective calls, bytes received and host seconds by
    axis line, and their sums over the ranks."""
    total = {}
    for r in reports:
        for line, t in r["traffic"].items():
            acc = total.setdefault(line, {"calls": 0, "bytes": 0,
                                          "seconds": 0.0})
            for k in acc:
                acc[k] += t[k]
    return {"rank0": reports[0]["traffic"], "sum_over_ranks": total}


def mesh_drops(reports):
    """Dropped (token, expert) pairs a MoE layer, summed over the ranks of
    model index 0 (the model ranks of a batch shard see one token set)."""
    layers = sorted(reports[0]["drops"])
    return [sum(r["drops"][k] for r in reports if r["coords"]["model"] == 0)
            for k in layers]


def mesh_trainer(torch, cfg, shape, flags_kw, schedule, pool=None):
    """``make_train_step`` of ``cfg`` on a mesh of ranks on the card, the
    ranks drawing their slices from the seed (no whole model is built):
    (step, trainer, rank 0's state, start seconds)."""
    from repro_torch.models.transformer import TRAIN_FLAGS
    from repro_torch.runtime.steps import make_train_step
    t0 = time.perf_counter()
    step, init = make_train_step(
        cfg, schedule=schedule, mesh=training_mesh(shape),
        flags=dataclasses.replace(TRAIN_FLAGS, **flags_kw),
        pool=pool or TRAIN_POOL)
    state = init(seed=SEED)
    sync(torch)
    return step, step.trainer, state, time.perf_counter() - t0


def param_count(cfg):
    """The number of parameters of ``cfg``'s model, from its template."""
    from repro_torch.models.model import Model
    return Model(cfg, device="meta").param_count()


def drawn_alike(torch, trainer, state, model):
    """The ranks' slices of the seed's draw gathered whole equal the
    unsharded model's weights, bitwise."""
    from repro_torch.models.params import flatten
    whole = flatten(trainer.gather_state(state, params_only=True).params)
    return all(torch.equal(whole[k], v.detach().cpu())
               for k, v in flatten(model.params).items())


def mesh_steps(torch, step, trainer, state, cfg, shapes):
    """One bf16 step a batch (``shapes``, batches 0 ..) with every rank's
    counters reset first: per step its ms (rank 0's host clock around the
    step, which ends at the ranks' barrier), loss (and an MTP head's),
    aux, grad norm, each rank's peak memory, whether every rank's
    gradient slices were finite, the collectives by axis, and the MoE
    drops a layer.  Returns (state, [step lines], rank 0's kernel
    launches)."""
    from repro_torch.kernels import build
    trainer.report(reset=True)
    zero_launches()
    out = []
    for i, shape in enumerate(shapes):
        batch = train_batch(torch, cfg, i, shape)
        sync(torch)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        reports = trainer.report(reset=True)
        line = {"shape": list(shape), "step_ms": ms, "loss": loss,
                "aux": float(m["aux"]), "grad_norm": float(m["grad_norm"]),
                "grads_finite": all(r["grads_finite"] for r in reports),
                "peak_gb_per_rank": [
                    r["max_memory_allocated"] / 2 ** 30
                    if r["max_memory_allocated"] is not None else None
                    for r in reports],
                "collectives": mesh_traffic(reports)}
        if "mtp_loss" in m:
            line["mtp_loss"] = float(m["mtp_loss"])
        if reports[0]["drops"]:
            line["drops_per_layer"] = mesh_drops(reports)
        out.append(line)
    return state, out, dict(build.launches)


def mesh_checkpoint(torch, trainer, state):
    """The ranks' checkpoint of the params (``save_from_mesh``) against
    the unsharded save of the gathered params: every file byte for
    byte."""
    import shutil
    from repro_torch.checkpoint import save_checkpoint, save_from_mesh
    directory = ROOT / "build" / "mesh_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    step = int(state.opt.step)
    t0 = time.perf_counter()
    a = Path(save_from_mesh(str(directory / "mesh"), step, trainer, state,
                            params_only=True))
    save_s = time.perf_counter() - t0
    whole = trainer.gather_state(state, params_only=True)
    b = Path(save_checkpoint(str(directory / "plain"), step, whole.params))
    names = sorted(f.name for f in a.iterdir())
    equal = names == sorted(f.name for f in b.iterdir()) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names)
    nbytes = sum((a / n).stat().st_size for n in names)
    shutil.rmtree(directory, ignore_errors=True)
    return {"files": len(names), "bytes": nbytes, "save_s": save_s,
            "byte_for_byte": equal}


#: a gradient leaf whose f64 elements all sit below this share of the
#: tree's largest is rounding noise, and is not compared
NOISE_GRAD = 1e-12


def _update_sums(torch, cfg, params):
    """Each leaf's change from the seed's draw (``Model(cfg, seed=SEED)``'s,
    drawn again leaf by leaf on the card): the sum of its squares, its
    dot product with the draw (``Rank.update_sums``' reading) and the
    draw's sum of squares, in f64."""
    from repro_torch.models.params import DTYPES, _init_leaf, flatten
    from repro_torch.models.transformer import model_template
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    flat, out = flatten(params), {}
    for k, spec in flatten(model_template(cfg)).items():
        p0 = _init_leaf(spec, gen, DTYPES[cfg.dtype], DEVICE).double()
        d = flat[k].detach().double().sub_(p0)
        sq = float(torch.linalg.vector_norm(d)) ** 2
        out[k] = [sq, float(d.mul_(p0).sum()),
                  float(torch.linalg.vector_norm(p0)) ** 2]
        del p0, d
    return out


#: a leaf whose unsharded f32 gradient sits further than this from the
#: f64 one (by the norm) is held by the f64 step alone where only its
#: update sums are read: the f32 rule cannot tell the mesh's rounding
#: from the unsharded step's there (jamba's embedding and attention
#: leaves, 0.6-2.2 from f64 under a softmax its init saturates)
F32_USABLE = 1e-2
#: an updated param is rounded to f32 by the optimizers (their update
#: in f32 arithmetic, as JAX's), also in an f64 step: two such steps'
#: changes may part by up to an f32 ulp of the param in each element,
#: so their update sums by up to this share of the root of the change's
#: and the start's sums of squares (the sum of squares) or of the
#: start's (the dot product)
F32_ROUNDING = 2.0 ** -22


def _sums_agree(mesh, plain, f64, tol, skip):
    """Leaf by leaf (but ``skip``), the mesh's update sums against the
    unsharded step's: each within ``tol`` of its scale (the sum of
    squares of the unsharded change; for the dot product, the root of
    that times the start's) and F32_ROUNDING's allowance, or, given the
    f64 step's (``f64``), no further from them than twice the unsharded
    step's.  Returns (the leaves that disagree, the largest distance
    over the scale and its leaf)."""
    bad, worst, where = set(), 0.0, None
    for k, (sq, dot, start) in plain.items():
        if k in skip:
            continue
        scale = (max(sq, 1e-300), max(math.sqrt(sq * start), 1e-300))
        rounding = F32_ROUNDING * math.sqrt(sq * start), \
            F32_ROUNDING * start
        for i in range(2):
            diff = abs(mesh[k][i] - plain[k][i])
            if diff / scale[i] > worst:
                worst, where = diff / scale[i], k
            if diff > tol * scale[i] + rounding[i] and (
                    f64 is None or abs(mesh[k][i] - f64[k][i])
                    > 2 * abs(plain[k][i] - f64[k][i])):
                bad.add(k)
    return sorted(bad), worst, where


def mesh_vs_plain(torch, cfg, depth, shape, mesh_shape, flags_kw,
                  pool=None, dtypes=("float32", "float64"), wide=False):
    """A step at full width and ``depth`` layers on a mesh of ranks on
    the card against the port's unsharded step on the card, on the same
    weights (the seed's) and batch, in each of ``dtypes``.  In f32 by
    ``train_card_vs_cpu``'s rule: loss and grad norm (and an MTP head's
    loss) within TRAIN_CPU_TOL relative or no further from the f64 step
    than twice the unsharded one; every updated param leaf within
    TRAIN_CPU_TOL of the unsharded leaf's scale wherever the f64
    gradient exceeds 1e-3 of the leaf's largest, or no further from the
    f64 leaf than twice the unsharded one (or than TRAIN_CPU_TOL); the
    grad norm may also sit within twice the unsharded step's f32 floor
    (its gradient leaves' largest distance from the f64 step's, by the
    norm, at least TRAIN_GRAD_NEAR) of the f64 step, since minicpm's
    saturated softmax puts its embedding gradient 1.3e-3 to 1.9e-3 from
    f64 in any f32 arithmetic.  In f64 the mesh step is the unsharded
    f64 step's function: loss, grad norm and every updated leaf within
    MESH_F64_TOL.  Adafactor's factored state after the step is held by
    the same rules as the params (in f64 every factor within
    MESH_F64_TOL).  A leaf whose f64 gradient is rounding noise
    (NOISE_GRAD) is neither compared nor read into the floor.

    ``wide`` (a full-width model whose params would take minutes to
    gather through gloo): each param leaf is held by its update sums
    instead of element by element (``Rank.update_sums``: the change's sum of squares and its
    dot product with the draw, over the ranks' distinct slices, no
    gather), by the same rules of that leaf's scale (``_sums_agree``);
    and in f32 a second mesh step on the batch must lower the loss.
    With ``moe_impl="ep"`` the unsharded step's MoE layers run
    ``moe.ep_plain`` (the mesh's function), and the dropped pairs a layer
    of the mesh must equal ``ep_plain``'s (read from a no-grad forward of
    the unsharded model) and are printed beside the unsharded gather's.
    Both unsharded steps start from the seed's draw in their dtype, as
    the ranks' do.  All products run in true f32."""
    from repro_torch.models import moe
    from repro_torch.models.layers import no_tf32
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten
    from repro_torch.models.transformer import TRAIN_FLAGS
    from repro_torch.sharding.rules import state_leaves
    cfg32 = dataclasses.replace(cfg, num_layers=depth, dtype="float32")
    cfg64 = dataclasses.replace(cfg32, dtype="float64")
    schedule = launcher_schedule(cfg32, TRAIN_STEPS)
    batch = train_batch(torch, cfg32, 0, shape, device="cpu")
    flags = dataclasses.replace(TRAIN_FLAGS, **flags_kw)
    ada = cfg32.optimizer == "adafactor"
    f32 = "float32" in dtypes
    out = {"depth": depth, "shape": list(shape),
           "mesh": {"data": mesh_shape[0], "model": mesh_shape[1]},
           "flags": flags_kw, "tol": TRAIN_CPU_TOL, "dtypes": list(dtypes),
           "optimizer": cfg32.optimizer, "wide": wide}

    def results(c, state):
        """The updated params (their update sums where ``wide``, else on
        the host) and Adafactor's state on the host."""
        params = _update_sums(torch, c, state.params) if wide else {
            k: v.detach().cpu() for k, v in flatten(state.params).items()}
        return params, {k: v.detach().cpu() for k, v in
                        state_leaves(state.opt).items()} if ada else None

    # the unsharded f64 step first, on the seed's draw (as the ranks draw
    # it): its gradients stay on the card (its own tensors, no copy) for
    # the masks and the f32 step's floor
    seconds = {}
    t_part = time.perf_counter()
    st, xm, _, xg = _step_on(torch, Model(cfg64, device=DEVICE, seed=SEED),
                             schedule, batch, flags)
    xp, xv = results(cfg64, st)
    del st
    free_card(torch)
    keep, noise = {}, set()
    top = max(float(x.abs().max()) for x in xg.values())
    for k, x in xg.items():
        keep[k] = (x.abs() > 1e-3 * x.abs().max()).cpu()
        if float(x.abs().max()) <= NOISE_GRAD * top:
            # a gradient that is rounding noise in f64 (the mLSTM's
            # input-gate bias: a shift of every log input gate cancels in
            # the normalised readout); Adam's first step is its sign
            keep[k].zero_()
            noise.add(k)
    floor, gap, far = [0.0], [], {}
    seconds["plain_float64"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    if f32:
        card = Model(cfg32, device=DEVICE, seed=SEED)
        if flags.moe_impl == "ep":
            with RouteRecorder() as rec, torch.no_grad():
                card.forward(batch["tokens"].to(DEVICE), flags=flags)
            B, S = shape
            out["drops_ep_plain"] = [moe.ep_dropped(cfg32, i, B, S,
                                                    flags.batch_divisor)
                                     for i in rec.calls]
            out["drops_gather"] = [moe.ep_dropped(cfg32, i, B, S, 1)
                                   for i in rec.calls]

        def read(k, g):
            # the unsharded f32 step's gradient leaves from the f64
            # step's, by the norm: the f32 floor of this model at this
            # batch; and the leaves whose squared norms part the two
            # grad norms most
            if k in noise:
                return
            x = xg[k]
            xn = float(torch.linalg.vector_norm(x))
            gn = float(torch.linalg.vector_norm(g, dtype=torch.float64))
            far[k] = float(torch.linalg.vector_norm(g - x)) / max(xn, 1e-30)
            floor[0] = max(floor[0], far[k])
            gap.append((abs(gn * gn - xn * xn), k, gn, xn))
        st, pm, plain_s, _ = _step_on(torch, card, schedule, batch, flags,
                                      on_grad=read)
        pp, pv = results(cfg32, st)
        del st, card
        out["grad_gap_leaves"] = [
            {"leaf": k, "sq_norm_gap": d, "norm": {"f32": a, "f64": b}}
            for d, k, a, b in sorted(gap, reverse=True)[:3]]
    floor = floor[0]
    del xg
    free_card(torch)
    if f32:
        seconds["plain_float32"] = time.perf_counter() - t_part
    ok = True
    metrics = [k for k in ("loss", "grad_norm", "mtp_loss") if k in xm]
    for dt in dtypes:
        t_part = time.perf_counter()
        c = dataclasses.replace(cfg32, dtype=dt)
        step, trainer, state, start_s = mesh_trainer(
            torch, c, mesh_shape, flags_kw, schedule, pool)
        free_card(torch)
        trainer.record_drops(flags.moe_impl == "ep")
        tb = {k: v.to(DEVICE) if v.dtype == torch.long
              else v.to(DEVICE, getattr(torch, dt)) for k, v in batch.items()}
        with no_tf32(torch.device(DEVICE)):
            sync(torch)
            t0 = time.perf_counter()
            state, m = step(state, tb)
            sync(torch)
            mesh_s = time.perf_counter() - t0
        reports = trainer.report()
        mp = trainer.update_sums(SEED) if wide else None
        whole = trainer.gather_state(state, params_only=not ada,
                                     opt_only=wide) \
            if ada or not wide else None
        if wide and dt == "float32":
            state, m2 = step(state, tb)
            out["loss_second_step"] = float(m2["loss"])
            ok = ok and out["loss_second_step"] < float(m["loss"])
        trainer.close()
        # rank 0's slices go with its trainer, before the next one draws
        del state, step, trainer
        free_card(torch)
        mm = {k: float(v) for k, v in m.items()}
        seconds[f"mesh_{dt}"] = time.perf_counter() - t_part
        if not wide:
            mp = flatten(whole.params)
        mv = state_leaves(whole.opt) if ada else None
        del whole
        for k in metrics:
            out.setdefault(k, {"f64": xm[k]})
        if dt == "float32":
            out.update({"mesh_start_s": start_s, "mesh_step_s": mesh_s,
                        "grads_finite": all(r["grads_finite"]
                                            for r in reports)})
            ok = ok and out["grads_finite"]
            for k in metrics:
                x = xm[k]
                out[k].update({"mesh": mm[k], "plain": pm[k]})
                # the f32 rule, or a grad norm within twice the unsharded
                # step's gradient floor of the f64 one (a norm's error is
                # its leaves')
                ok = ok and (_agree(mm[k], pm[k], x, TRAIN_CPU_TOL) or (
                    k == "grad_norm" and abs(mm[k] - x) <= 2 * max(
                        floor, TRAIN_GRAD_NEAR) * abs(x)))
            if wide:
                unusable = {k for k, d in far.items() if d > F32_USABLE}
                out["f32_unusable_leaves"] = sorted(unusable)
                pbad, pworst, pwhere = _sums_agree(mp, pp, xp, TRAIN_CPU_TOL,
                                                   noise | unusable)
            else:
                pbad, pworst, pwhere = _leaves_agree(
                    mp, pp, xp, TRAIN_CPU_TOL, TRAIN_CPU_TOL, keep)
            out.update({"params_rel": pworst, "params_worst_leaf": pwhere,
                        "params_disagree": pbad})
            ok = ok and not pbad
            if ada:
                vbad, vworst, vwhere = _leaves_agree(mv, pv, xv,
                                                     TRAIN_CPU_TOL,
                                                     TRAIN_CPU_TOL)
                out.update({"moments_rel": vworst,
                            "moments_worst_leaf": vwhere,
                            "moments_disagree": vbad})
                ok = ok and not vbad
            if flags.moe_impl == "ep":
                out["drops_mesh"] = mesh_drops(reports)
                ok = ok and out["drops_mesh"] == out["drops_ep_plain"]
        else:
            out.update({"mesh_f64_start_s": start_s,
                        "mesh_f64_step_s": mesh_s})
            if not f32:
                ok = ok and all(r["grads_finite"] for r in reports)
            for k in metrics:
                out[k]["mesh_f64"] = mm[k]
                # the mesh's f64 step is the unsharded f64 step's function
                ok = ok and abs(mm[k] - xm[k]) <= MESH_F64_TOL * abs(xm[k])
            if wide:
                xbad, xworst, xwhere = _sums_agree(mp, xp, None,
                                                   MESH_F64_TOL, noise)
            else:
                xbad, xworst, xwhere = _leaves_agree(
                    mp, xp, xp, MESH_F64_TOL, MESH_F64_TOL, keep)
            out.update({"f64_params_rel": xworst,
                        "f64_params_worst_leaf": xwhere,
                        "f64_params_disagree": xbad})
            ok = ok and not xbad
            if ada:
                vbad, vworst, vwhere = _leaves_agree(mv, xv, xv,
                                                     MESH_F64_TOL,
                                                     MESH_F64_TOL)
                out.update({"f64_moments_rel": vworst,
                            "f64_moments_worst_leaf": vwhere,
                            "f64_moments_disagree": vbad})
                ok = ok and not vbad
            if flags.moe_impl == "ep":
                out["drops_mesh_f64"] = mesh_drops(reports)
        del mp, mv
    out.update({"plain_step_s": plain_s if f32 else None,
                "plain_grad_floor": floor if f32 else None,
                "seconds": seconds, "ok": ok})
    del xp
    if f32:
        del pp
    free_card(torch)
    return out


def phase_train_mesh(torch, smi):
    """minicpm_2b at full width, its depth cut to TRAIN_MESH_DEPTH, on a
    (data 2, model 2) mesh of 4 ranks sharing the card: each holds 18 of
    the 36 heads, 2880 of the FFN's 5760 columns, half the vocabulary and
    half of every ``embed`` row set (ZeRO).  The ranks draw their slices
    from the seed (gathered whole they are the unsharded model's bits);
    AdamW with WSD as the launcher builds it, TRAIN_MESH_STEPS steps on
    batches of 4 x 256 (2 rows a data rank): finite losses, every rank's
    gradient slices finite, no kernel launched, step ms, each rank's
    peak memory and the collectives by axis; the ranks' checkpoint of
    the params byte for byte the unsharded save of the gathered params;
    then one f32 step at depth MESH_F32_DEPTH on the same mesh against
    the unsharded step (``mesh_vs_plain`` in f32: attention on the head
    arm and the dense FFN on its columns, both under ZeRO)."""
    from repro_torch.models.model import Model
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(minicpm_config(), num_layers=TRAIN_MESH_DEPTH)
    shape = (2, 2)
    step, trainer, state, start_s = mesh_trainer(
        torch, cfg, shape, mesh_flags(shape),
        launcher_schedule(cfg, TRAIN_MESH_STEPS))
    model = Model(cfg, device=DEVICE, seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    drawn = drawn_alike(torch, trainer, state, model)
    del model
    free_card(torch)
    state, steps, counts = mesh_steps(
        torch, step, trainer, state, cfg,
        [TRAIN_MESH_SHAPE] * TRAIN_MESH_STEPS)
    ck = mesh_checkpoint(torch, trainer, state)
    shapes = trainer.report()[0]["shapes"]
    trainer.close()
    del state
    free_card(torch)
    emit({"phase": "train_mesh", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": params,
          "mesh": {"data": 2, "model": 2}, "flags": mesh_flags(shape),
          "rank_shapes": {k: shapes[k] for k in (
              "params.embed.embedding", "params.blocks.l0.mixer.wq",
              "params.blocks.l0.ffn.w_gate", "m.blocks.l0.mixer.wo")},
          "start_s": start_s, "drawn_bitwise": drawn, "steps": steps,
          "launches": counts, "checkpoint": ck,
          "nvidia_smi": smi})
    check(drawn, "train_mesh: the ranks' draw is not the model's")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              and s["grads_finite"] for s in steps),
          "train_mesh: a loss, grad norm or gradient slice is not finite")
    check(not any(counts.values()), f"train_mesh: kernels launched: "
                                    f"{counts}")
    check(ck["byte_for_byte"], "train_mesh: the mesh checkpoint is not the "
                               "unsharded save")
    cmp = mesh_vs_plain(torch, minicpm_config(), MESH_F32_DEPTH,
                        MESH_F32_SHAPE, shape, mesh_flags(shape),
                        dtypes=("float32",))
    emit({"phase": "train_mesh_f32", "arch": cfg.name, **cmp})
    check(cmp["ok"], "train_mesh: the f32 mesh step disagrees with the "
                     "unsharded step")
    emit({"phase": "train_mesh_done",
          "seconds": time.perf_counter() - t_phase})


def phase_train_mesh_seq(torch, smi, pool=None):
    """minicpm_2b at full width, depth MESH_F32_DEPTH, on (data 1, model
    8): 36 heads do not divide 8 ranks, so attention takes the sequence
    arm (each rank its 8 of 64 query rows against the whole K/V); one
    f32 step against the unsharded step (``mesh_vs_plain`` in f32; an f64
    step of 8 ranks costs ~12 s of the script's time limit).  ``pool``: tp_hd's
    workers, which the 8-rank mesh takes over."""
    t_phase = time.perf_counter()
    cfg = minicpm_config()
    check(cfg.num_heads % TRAIN_SEQ_RANKS and cfg.num_kv_heads
          % TRAIN_SEQ_RANKS, "train_mesh_seq: the heads divide the ranks")
    shape = (1, TRAIN_SEQ_RANKS)
    cmp = mesh_vs_plain(torch, cfg, MESH_F32_DEPTH, MESH_F32_SHAPE, shape,
                        mesh_flags(shape), pool=pool, dtypes=("float32",))
    emit({"phase": "train_mesh_seq", "arch": cfg.name, "arm": "seq",
          "nvidia_smi": smi, **cmp,
          "seconds": time.perf_counter() - t_phase})
    check(cmp["ok"], "train_mesh_seq: the f32 mesh step disagrees with the "
                     "unsharded step")


def phase_train_ep(torch, smi):
    """granite_moe_3b_a800m at full width, depth TRAIN_EP_DEPTH, on (data
    2, model 2) with ``moe_impl="ep"``: each model rank holds 24 of the
    48 padded experts, each data rank half of ``d_model`` in every expert
    weight.  A bf16 step on each of TRAIN_EP_SHAPES (JAX's ``_moe_ep``,
    then ``_moe_ep_decode``), with its drops a layer, step ms, each
    rank's peak memory and the collectives; then f32 and f64 steps at
    depth MESH_F32_DEPTH against the unsharded step with ``moe.ep_plain``
    in its MoE layers, the drops a layer equal to ``ep_plain``'s."""
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(moe_config(), num_layers=TRAIN_EP_DEPTH)
    shape = (2, 2)
    flags_kw = mesh_flags(shape, ep=True)
    step, trainer, state, start_s = mesh_trainer(
        torch, cfg, shape, flags_kw,
        launcher_schedule(cfg, len(TRAIN_EP_SHAPES)))
    params = param_count(cfg)
    trainer.record_drops(True)
    state, steps, counts = mesh_steps(torch, step, trainer, state, cfg,
                                      TRAIN_EP_SHAPES)
    trainer.close()
    del state
    free_card(torch)
    for line in steps:
        B, S = line["shape"]
        n = moe.ep_shards(cfg, B, S, shape[0])
        line["branch"] = "_moe_ep" if n > 1 else "_moe_ep_decode"
        line["capacity"] = moe.capacity(cfg, B * S // n)
    emit({"phase": "train_ep", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": params,
          "mesh": {"data": 2, "model": 2}, "flags": flags_kw,
          "experts_per_rank": moe.padded_experts(cfg) // shape[1],
          "start_s": start_s, "steps": steps, "launches": counts,
          "nvidia_smi": smi})
    check([s["branch"] for s in steps] == ["_moe_ep", "_moe_ep_decode"],
          "train_ep: the batches do not take JAX's two branches")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              and s["grads_finite"] for s in steps),
          "train_ep: a loss, grad norm or gradient slice is not finite")
    check(not any(counts.values()), f"train_ep: kernels launched: {counts}")
    cmp = mesh_vs_plain(torch, moe_config(), MESH_F32_DEPTH,
                        TRAIN_EP_F32_SHAPE, shape, flags_kw)
    emit({"phase": "train_ep_f32", "arch": cfg.name, **cmp})
    check(cmp["ok"], "train_ep: the f32 mesh step disagrees with the "
                     "unsharded step with ep_plain, or drops apart")
    emit({"phase": "train_ep_done",
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# training on a mesh, second half (ROADMAP item 11c-ii): the recurrent
# mixers, MLA and its MTP head, Adafactor
# ---------------------------------------------------------------------------

#: the sequence-parallel mLSTM: one xlstm_1_3b mLSTM layer at full width
#: on (data 1, model 2), 1 x 8192 tokens (JAX's dispatch threshold,
#: ``xlstm.SP_TOKENS``)
TRAIN_SP_MESH = (1, 2)
TRAIN_SP_SHAPE = (1, 8192)
#: jamba_1_5_large_398b and deepseek_v3_671b with Adafactor: one bf16
#: step of TRAIN_WIDE_SHAPE (jamba's on (data 2, model 2), 18-27 s of
#: ZeRO gathers through gloo; deepseek_v3's on TRAIN_WIDE_CHECK_MESH),
#: then the f32 and f64 checks at TRAIN_WIDE_F32_SHAPE on
#: TRAIN_WIDE_CHECK_MESH
TRAIN_WIDE_MESH = (2, 2)
TRAIN_WIDE_SHAPE = (2, 256)
TRAIN_WIDE_F32_SHAPE = (2, 64)
#: the checks' mesh, (data 1, model 4): on (2, 2) four ranks' f64 slices,
#: gradients and ZeRO gathers of the whole vocabulary's embedding and
#: head exceed the card's 80 GB, and an f32 step there takes ~33 s
TRAIN_WIDE_CHECK_MESH = (1, 4)
#: deepseek_v3's checks on (data 1, model 2): four ranks each drawing the
#: f64 embedding whole (7.4 GB) before cutting it ran the card out of
#: memory
TRAIN_MLA_CHECK_MESH = (1, 2)


def xlstm_sp_config():
    """xlstm_1_3b at full width, depth 48 cut to one mLSTM layer."""
    cfg = dataclasses.replace(xlstm_config(), num_layers=1,
                              block_pattern=("mlstm",))
    check(cfg.layer_kinds() == ("mlstm",), "xlstm: not one mLSTM layer")
    return cfg


def jamba_dense_config():
    """jamba_1_5_large_398b at full width, its first two layers with the
    FFN pattern cut to dense: attention + dense FFN, Mamba + dense FFN."""
    cfg = dataclasses.replace(jamba_config(), ffn_pattern=("dense",))
    check(list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
          == [("attn", "dense"), ("mamba", "dense")],
          "jamba: not attention + dense, Mamba + dense")
    return cfg


def deepseek_head_config():
    """deepseek_v3_671b at full width, depth 61 cut to its dense head
    layer (MLA + dense FFN), with its MTP head."""
    cfg = dataclasses.replace(deepseek_config(), num_layers=1)
    check(list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
          == [("attn", "dense")] and cfg.mtp_depth == 1 and cfg.use_mla
          and cfg.optimizer == "adafactor",
          "deepseek_v3: not its dense head layer with the MTP head")
    return cfg


def phase_train_mesh_sp(torch, smi):
    """One xlstm_1_3b mLSTM layer at full width on (data 1, model 2) over
    1 x 8192 tokens: it takes ``mlstm_apply_sp`` (each rank scans its
    4096 rows, the segment summaries are gathered and folded, each
    rescans from its prefix): a bf16 step finite, no kernel launched,
    then an f64 mesh step against the unsharded f64 step at that size
    (``mesh_vs_plain``, ``wide``: metrics and every leaf's update sums
    within MESH_F64_TOL).  (The mLSTM + sLSTM pair's ``dk`` arm and the
    sLSTM whole on every rank are held on the CPU, in f64 against the
    unsharded layer: at 8192 tokens the sLSTM's token loop took 35-49 s
    a step here.)"""
    from repro_torch.models import xlstm as xl
    t_phase = time.perf_counter()
    cfg = xlstm_sp_config()
    shape = TRAIN_SP_MESH
    step, trainer, state, start_s = mesh_trainer(
        torch, cfg, shape, mesh_flags(shape), launcher_schedule(cfg, 1))
    xl.ARMS.clear()
    state, steps, counts = mesh_steps(torch, step, trainer, state, cfg,
                                      [TRAIN_SP_SHAPE])
    arms = dict(xl.ARMS)
    trainer.close()
    del state
    free_card(torch)
    emit({"phase": "train_mesh_sp", "arch": cfg.name,
          "layers": list(cfg.layer_kinds()), "d_model": cfg.d_model,
          "dtype": cfg.dtype, "mesh": {"data": shape[0], "model": shape[1]},
          "flags": mesh_flags(shape), "mlstm_arms": arms,
          "start_s": start_s, "steps": steps, "launches": counts,
          "nvidia_smi": smi})
    check(arms == {"sp": 2}, f"train_mesh_sp: the mLSTM's arms {arms}, not "
                             f"mlstm_apply_sp (forward and recompute)")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              and s["grads_finite"] for s in steps),
          "train_mesh_sp: a loss, grad norm or gradient slice is not finite")
    check(not any(counts.values()), f"train_mesh_sp: kernels launched: "
                                    f"{counts}")
    xl.ARMS.clear()
    cmp = mesh_vs_plain(torch, cfg, cfg.num_layers, TRAIN_SP_SHAPE, shape,
                        mesh_flags(shape), dtypes=("float64",), wide=True)
    emit({"phase": "train_mesh_sp_vs_plain", "arch": cfg.name,
          "mlstm_arms": dict(xl.ARMS), **cmp})
    check(cmp["ok"], "train_mesh_sp: the f64 mesh step disagrees with the "
                     "unsharded step")
    check(set(xl.ARMS) == {"sp"}, f"train_mesh_sp: the mesh steps took "
                                  f"{dict(xl.ARMS)}")
    emit({"phase": "train_mesh_sp_done",
          "seconds": time.perf_counter() - t_phase})


def _train_wide(torch, smi, cfg, phase, shape, check_shape):
    """A full-width Adafactor model on a mesh of ``shape``: the ranks draw
    their slices from the seed; one bf16 step of TRAIN_WIDE_SHAPE (its
    loss, gradient slices and grad norm finite, no kernel launched, step
    ms, peak memory and collectives a rank), the head arm taken; then
    the f32 and f64 checks at TRAIN_WIDE_F32_SHAPE on a mesh of
    ``check_shape`` (``mesh_vs_plain``, ``wide``: the metrics, the MTP
    loss where there is one, every leaf's update sums and Adafactor's
    factors), a second f32 step on the batch lowering its loss."""
    from repro_torch.models import chunked_attention as ca
    t_phase = time.perf_counter()
    step, trainer, state, start_s = mesh_trainer(
        torch, cfg, shape, mesh_flags(shape), launcher_schedule(cfg, 1))
    ca.ARMS.clear()
    state, steps, counts = mesh_steps(torch, step, trainer, state, cfg,
                                      [TRAIN_WIDE_SHAPE])
    arms = dict(ca.ARMS)
    shapes = trainer.report()[0]["shapes"]
    trainer.close()
    del state
    free_card(torch)
    emit({"phase": phase, "arch": cfg.name,
          "layers": list(zip(cfg.layer_kinds(), cfg.ffn_kinds())),
          "mtp_depth": cfg.mtp_depth, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "optimizer": cfg.optimizer,
          "mesh": {"data": shape[0], "model": shape[1]},
          "flags": mesh_flags(shape), "attention_arms": arms,
          "start_s": start_s, "steps": steps, "launches": counts,
          "factor_shapes": {k: v for k, v in shapes.items()
                            if k.endswith((".0", ".1")) and "embed" in k},
          "nvidia_smi": smi})
    check(set(arms) == {"heads"}, f"{phase}: attention arms {arms}, not "
                                  f"heads")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              and s["grads_finite"] and math.isfinite(s.get("mtp_loss", 0))
              for s in steps),
          f"{phase}: a loss, grad norm or gradient slice is not finite")
    check(not any(counts.values()), f"{phase}: kernels launched: {counts}")
    cmp = mesh_vs_plain(torch, cfg, cfg.num_layers, TRAIN_WIDE_F32_SHAPE,
                        check_shape, mesh_flags(check_shape), wide=True)
    emit({"phase": f"{phase}_vs_plain", "arch": cfg.name, **cmp})
    check(cmp["ok"], f"{phase}: the f32 or f64 mesh step disagrees with the "
                     f"unsharded step, or the loss did not fall")
    emit({"phase": f"{phase}_done", "seconds": time.perf_counter() - t_phase})


def phase_train_mesh_hybrid(torch, smi):
    """jamba_1_5_large_398b at full width, its first two layers with
    dense FFNs (attention, then Mamba on its channels of d_inner), with
    Adafactor: the bf16 step on (data 2, model 2), ZeRO over data
    (``_train_wide``)."""
    _train_wide(torch, smi, jamba_dense_config(), "train_mesh_hybrid",
                TRAIN_WIDE_MESH, TRAIN_WIDE_CHECK_MESH)


def phase_train_mesh_mla(torch, smi):
    """deepseek_v3_671b at full width, its dense head layer (MLA on the
    heads arm) and its MTP head, with Adafactor (``_train_wide``): the
    bf16 step on TRAIN_WIDE_CHECK_MESH (32 of the 128 heads a rank; on
    (2, 2) its ZeRO gathers take 22-35 s a step), the MTP loss finite,
    and in f64 the unsharded step's, the checks on TRAIN_MLA_CHECK_MESH."""
    _train_wide(torch, smi, deepseek_head_config(), "train_mesh_mla",
                TRAIN_WIDE_CHECK_MESH, TRAIN_MLA_CHECK_MESH)


def time_recurrent_updates(torch):
    """One mLSTM decode update and one 5-token window with stacks at 4
    slots, and one Mamba decode update at 4 slots, at full width in bf16:
    device ms by CUDA events over queued calls against the bytes bound
    (the layer's weights read once, the rows' state read once and written
    once; the window writes the stacks instead of the state).  No
    library call computes these."""
    from repro_torch.models.params import DTYPES
    rows = []
    for kind, L in (("mlstm", 1), ("mlstm", VERIFY_WIDTH + 1),
                    ("mamba", 1)):
        cfg, p, win, zero = mixer_layer(torch, kind, "bfloat16")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
        x = torch.randn(SERVE_SLOTS, L, cfg.d_model, device=DEVICE,
                        generator=gen).to(DTYPES[cfg.dtype])
        _, live = win(p, cfg, torch.randn(
            SERVE_SLOTS, 16, cfg.d_model, device=DEVICE,
            generator=gen).to(DTYPES[cfg.dtype]), zero(cfg, SERVE_SLOTS,
                                                       DEVICE))
        stk = {k: torch.zeros((SERVE_SLOTS, L) + v.shape[1:], dtype=v.dtype,
                              device=DEVICE) for k, v in live.items()} \
            if L > 1 else None
        weights = sum(v.numel() * v.element_size() for v in p.values())
        state = sum(v.numel() * v.element_size() for v in live.values())
        bytes_ = weights + state + (L * state if L > 1 else state)
        ms, host_ms, prof_ms, queued = cuda_ms(
            torch, lambda: win(p, cfg, x, live, stk), profile=False)
        rows.append({"op": f"{kind} {'window' if L > 1 else 'decode'} "
                     f"update", "slots": SERVE_SLOTS, "tokens": L,
                     "ms": ms, "host_ms": host_ms, "profiler_ms": prof_ms,
                     "queued": queued, "weight_bytes": weights,
                     "state_bytes": state,
                     "bound_ms": bytes_ / HBM_BPS * 1e3, "bound_by": "bytes",
                     "library_ms": None})
        del p, live, stk
        free_card(torch)
    return rows


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


def cuda_ms(torch, fn, reps=REPS, queue=True, profile=True):
    """(device ms, host ms, profiler ms per call, queued): the card's
    time per call over ``reps`` calls queued back to back (CUDA events,
    ``queued_ms``, and whether they queued), the median wall time of one
    synchronised call as the host sees it, and the sum of the calls'
    kernel times as torch.profiler records them (None where it records
    none, or with ``profile`` False: a profiler's start-up costs about a
    second).  ``queue`` False skips the queued reading (None, False): a
    call of more launches than the card's launch queue holds does not
    queue, and its events would hold the host's gaps."""
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
    device_ms, queued = queued_ms(torch, fn, reps, host_ms) if queue \
        else (None, False)
    check(not queue or device_ms > 0, "CUDA events recorded no device time")
    per = profiled_ms(torch, fn, reps) if profile else {}
    return device_ms, host_ms, sum(per.values()) if per else None, queued


def measure(torch, kernel, plain, library, profile=True, plain_queue=True):
    """Device and host times of the kernel, its plain version and the
    library call (``None``: there is none); ``profile`` as ``cuda_ms``.
    ``plain_queue`` False reads the plain version's synchronised wall
    time alone, over 5 calls (a call of ~100 ms queues no better, and
    the sleep ahead of 30 queued ones would cost seconds)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        kw = {"queue": False, "reps": 5} \
            if key == "plain_" and not plain_queue else {}
        dev, wall, prof, queued = (cuda_ms(torch, fn, profile=profile, **kw)
                                   if fn is not None else (None,) * 4)
        out[key + "ms"], out[key + "host_ms"] = dev, wall
        out[key + "profiler_ms"], out[key + "queued"] = prof, queued
    return out


# ---------------------------------------------------------------------------
# cost_model — the op counter (``launch/op_cost.py``) held against steps
# the card timed in this run
# ---------------------------------------------------------------------------

def on_meta(*ts):
    """``meta`` tensors of ``ts``' shapes and dtypes."""
    return tuple(t.to("meta") for t in ts)


def tick_cost(name, phase, engine, layout, measured_ms, bound_bytes,
              slots=SERVE_SLOTS):
    """A decode tick's entry in COST_STEPS: ``engine``'s serve decode
    step at its flags, ``slots`` rows, its ``max_len``, on the ``paged``
    layout of ``interleaved_ticks`` (ROOMY_BLOCKS of SERVE_BLOCK) or the
    slot layout."""
    cfg, flags, max_len = engine.cfg, engine.flags, engine.max_len

    def count():
        import torch
        from repro_torch.launch.dryrun import tree_bytes as nbytes
        from repro_torch.launch.op_cost import OpCounter
        from repro_torch.models.model import Model
        from repro_torch.runtime.steps import make_serve_decode_step
        model = Model(cfg, device="meta")

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")
        if layout == "paged":
            cache = model.new_paged_cache(ROOMY_BLOCKS, SERVE_BLOCK)
            tables = meta(slots, max_len // SERVE_BLOCK)
        else:
            cache, tables = model.new_cache(slots, max_len), None
        args = (meta(slots, 1), cache, meta(slots), meta(
            slots, dtype=torch.bool), tables)
        step = make_serve_decode_step(model, flags)
        with OpCounter() as c:
            step(*args)
        return c, nbytes(model.params) + nbytes(args)
    return {"step": name, "phase": phase, "kind": "tick",
            "measured_ms": measured_ms,
            "measured_by": "CUDA events over queued replays of the "
                           "captured graph",
            "bound_bytes": bound_bytes,
            "bound_ms": bound_bytes / HBM_BPS * 1e3, "count": count}


def train_cost(cfg, shape, line):
    """The train step's entry in COST_STEPS: ``make_train_step`` as
    ``train_steps`` builds it, on a [B, S] batch."""
    def count():
        import torch
        from repro_torch.launch.dryrun import tree_bytes as nbytes
        from repro_torch.launch.op_cost import OpCounter
        from repro_torch.models.model import Model
        from repro_torch.runtime.steps import make_train_step
        model = Model(cfg, device="meta")
        step, init = make_train_step(model, schedule=launcher_schedule(
            cfg, TRAIN_STEPS))
        state = init(model.params)
        batch = {k: torch.empty(shape, dtype=torch.long, device="meta")
                 for k in ("tokens", "labels")}
        with OpCounter() as c:
            step(state, batch)
        return c, nbytes(state.params) + nbytes((state.opt.m, state.opt.v)) \
            + nbytes(batch)
    device = line["device_ms_per_step"]
    return {"step": f"{cfg.name} train step {shape[0]} x {shape[1]}",
            "phase": "train_main_path", "kind": "train",
            "measured_ms": device or line["median_step_ms"],
            "measured_by": "torch.profiler's kernel sum over one step"
                           if device else "the step's median wall ms (the "
                           "profiler recorded no device time)",
            "bound_ms": line["bound_ms"], "bound_flops": line["step_flops"],
            "max_memory_allocated": line["max_memory_allocated"],
            "count": count}


def phase_cost_model(torch, smi, steps=None):
    """The op counter against the steps this run timed (COST_STEPS:
    ``steps`` of them when given) and the ``times`` phase's kernel rows
    (COST_KERNELS): each counted on the host on ``meta`` tensors at the
    step's exact shapes and flags, with the kernels' path where the card
    ran the kernels; no step runs on the card.  For each step: the
    counted FLOPs, bytes and collective bytes, the roofline ms with the
    port's constants (``launch/analysis.py``), the measured device ms,
    measured over counted bound, and the phase's own bound beside the
    counted one; for the train step the counted peak beside
    ``max_memory_allocated`` (printed only).  Gates: (a) no counted
    roofline above its step's measured ms; (b) each decode tick's
    counted bytes at least its phase's weights + K/V bound bytes; (c)
    each kernel's counted bytes and operations within 1% of its
    ``times`` row's bound."""
    import collections
    from repro_torch.launch.analysis import roofline
    t0 = time.perf_counter()
    if steps is not None:
        check(len(COST_STEPS) == steps, f"cost_model: {len(COST_STEPS)} "
                                        f"timed steps, not {steps}")
    for st in COST_STEPS:
        t1 = time.perf_counter()
        c, args = st["count"]()
        rl = roofline(c.flops, c.bytes, sum(c.coll.values()), 1)
        roof_ms = max(rl["compute_s"], rl["memory_s"],
                      rl["collective_s"]) * 1e3
        line = {"phase": "cost_model", "step": st["step"],
                "timed_by_phase": st["phase"], "counted_flops": c.flops,
                "counted_bytes": c.bytes,
                "counted_collective_bytes": sum(c.coll.values()),
                "compute_ms": rl["compute_s"] * 1e3,
                "memory_ms": rl["memory_s"] * 1e3,
                "collective_ms": rl["collective_s"] * 1e3,
                "dominant": rl["dominant"], "roofline_ms": roof_ms,
                "measured_ms": st["measured_ms"],
                "measured_by": st["measured_by"],
                "measured_over_counted_bound": st["measured_ms"] / roof_ms,
                "phase_bound_ms": st["bound_ms"],
                "phase_bound_over_counted_bound": st["bound_ms"] / roof_ms,
                "kernel_calls": dict(collections.Counter(
                    k["name"] for k in c.kernels)),
                "count_seconds": time.perf_counter() - t1,
                "nvidia_smi": smi}
        if st["kind"] == "tick":
            line["phase_bound_bytes"] = st["bound_bytes"]
        else:
            line["phase_bound_flops"] = st["bound_flops"]
            line["counted_peak_gb"] = (c.peak_bytes + args) / 2**30
            line["max_memory_allocated_gb"] = \
                st["max_memory_allocated"] / 2**30 \
                if st["max_memory_allocated"] else None
        emit(line)
        check(roof_ms <= st["measured_ms"],
              f"cost_model {st['step']}: counted roofline {roof_ms} ms "
              f"above the measured {st['measured_ms']} ms")
        if st["kind"] == "tick":
            check(c.bytes >= st["bound_bytes"],
                  f"cost_model {st['step']}: counted bytes {c.bytes} below "
                  f"the phase's bound {st['bound_bytes']}")
    for name, (call, nbytes, flops) in COST_KERNELS.items():
        from repro_torch.launch.op_cost import OpCounter
        with OpCounter() as c:
            call()
        check([k["name"] for k in c.kernels] == [name],
              f"cost_model {name}: recorded {c.kernels}")
        k = c.kernels[0]
        emit({"phase": "cost_model", "kernel": name,
              "counted_bytes": k["bytes"], "times_bound_bytes": nbytes,
              "counted_operations": k["flops"],
              "times_bound_operations": flops})
        check(abs(k["bytes"] - nbytes) <= 0.01 * nbytes
              and abs(k["flops"] - flops) <= 0.01 * flops,
              f"cost_model {name}: counted {k['bytes']} bytes and "
              f"{k['flops']} operations, the times bound {nbytes} and "
              f"{flops}")
    check(set(COST_KERNELS) == set(SOURCES),
          f"cost_model: kernels {sorted(COST_KERNELS)}")
    emit({"phase": "cost_model", "steps": len(COST_STEPS),
          "kernels": len(COST_KERNELS),
          "seconds": time.perf_counter() - t0})


def bound(bytes_, flops, peak_flops):
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
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
    COST_KERNELS["rmsnorm"] = (
        lambda: ops.rmsnorm(*on_meta(x, s)), nbytes, 4 * x.numel())
    rows["rmsnorm"] = {
        "shape": [4, d],
        **measure(torch, lambda: rmsnorm_cuda(x, s),
                  lambda: ref.rmsnorm_ref(x, s),
                  (lambda: F.rms_norm(x, (d,), s, 1e-5))
                  if hasattr(F, "rms_norm") else None, profile=False),
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": 2 * L + 1}
    # K1 where bytes count: the serve workload's prefill chunk, and
    # qwen3_32b's prefill of 1024 rows at d_model 5120; and the decode
    # ticks of the other widths
    for shape in RMSNORM_TIMED + RMSNORM_ROWS:
        emit({"phase": "times", "kernel": "rmsnorm",
              **time_rmsnorm(torch, g, shape)})
    # the launch floor: the smallest PyTorch kernel, a 1-element fill_,
    # in the same timer; at 4 rows K1 is bound by it, not by bytes
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(torch, lambda: one.fill_(1.0), profile=False)
    emit({"phase": "times", "kernel": None,
          "case": "launch floor: a 1-element fill_", "ms": floor[0],
          "host_ms": floor[1], "profiler_ms": floor[2], "queued": floor[3]})

    # K3 at the serving prefill's shape: 2 rows of 18 tokens, causal
    B, S = 2, GROUPS[1]
    q, k, v = (torch.randn(B, S, H, hd, device=dev, generator=g).to(bf)
               for _ in range(3))
    pairs = B * H * S * (S + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * 2, 4 * hd * pairs, BF16_FLOPS)
    COST_KERNELS["flash_attention"] = (
        lambda: ops.flash_attention(*on_meta(q, k, v)), 4 * q.numel() * 2,
        4 * hd * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows["flash_attention"] = {
        "shape": [B, S, H, hd],
        **measure(torch, lambda: flash_attention_cuda(q, k, v),
                  lambda: ref.flash_attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True), profile=False),
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": 0,
        "launches_per_prefill": L}

    # K3 at the serve workload's chunk (256 rows at q_offset 512 over
    # 768 keys) and at qwen3_32b's full prefill of 1024 rows (the
    # windowed prefill is timed by ``tools/chip_phases.py window_kernels``
    # alone, to pay for ``cost_model``)
    for r in time_flash_shapes(torch, g, [t for t in FLASH_TIMED
                                          if len(t) == 7]):
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
    # the bound reads each row's keys once (the new token's K/V are
    # written once instead), q, the new K/V and the output once
    keys = int((pos + 1).sum())
    nbytes = (2 * keys * H * hd * 2 + 4 * qd.numel() * 2
              + tables.numel() * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * hd * H * keys, BF16_FLOPS)
    COST_KERNELS["fused_flash_decode"] = (
        lambda: ops.fused_flash_decode(*on_meta(
            qd, kn, vn, arena[0], arena[1], tables), pos.cpu(),
            *on_meta(freqs)), nbytes, 4 * hd * H * keys)
    rows["fused_flash_decode"] = {
        "shape": [B, 1, H, hd], "max_len": MAX_LEN,
        **measure(torch, lambda: fused_flash_decode_cuda(
            qd, kn, vn, arena[0], arena[1], tables, pos, freqs),
            lambda: ref.fused_flash_decode_ref(
                qd, kn, vn, arena[0], arena[1], tables, pos, freqs), None,
            profile=False),
        "library_note": "no single PyTorch call rotates, scatters into a "
                        "paged arena and attends",
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_tick": L}

    # K2, K4 and K5 on a paged arena: the serve phase's decode tick (4
    # rows, bs 16, rows at the served lengths), then qwen3_32b's
    # attention shape with 4 rows of 4096 keys, granite's and jamba's
    # at the served lengths, then one rank's heads under tensor-parallel
    # serving (minicpm_2b at tp 2, qwen3_32b at tp 4); S' = 1 and the
    # verify window of 5 (K5 has no window; one rank's heads at S' = 1)
    for shape, keys in ((("minicpm_2b", H, H, hd), (300, 520, 700, 930)),
                        (("qwen3_32b", 64, 8, 128), (4096,) * 4),
                        (GRANITE, (300, 520, 700, 930)),
                        (("jamba_1_5_large_398b", 64, 8, 128),
                         (300, 520, 700, 930)),
                        (STUB_HEADS[0], (300, 520, 700, 930)),
                        (TP_HEADS[0], (300, 520, 700, 930)),
                        (TP_HEADS[2], (4096,) * 4),
                        (TP_HEADS[3], (300, 520, 700, 930)),
                        (TP_HEADS[4], (300, 520, 700, 930)),
                        # tp_encdec's decode steps: 16 + 8 keys a row
                        (TP_HEADS[5], (STUB_TOKENS + STUB_STEPS,) * 2)):
        # one rank's heads at S' = 1 only (the run's budget)
        for Sq in (1,) if shape in TP_HEADS else (1, SERVE_SPEC + 1):
            timed = time_paged_kernels(torch, g, shape, keys, Sq)
            for name, r in timed.items():
                if (shape[0] == "minicpm_2b" and Sq == 1
                        and name != "fused_flash_decode"):
                    rows[name] = r
                else:
                    emit({"phase": "times", "kernel": name, **r})
    for name, r in rows.items():
        emit({"phase": "times", "kernel": name, **r})
    for r in time_recurrent_updates(torch):
        emit({"phase": "times", "kernel": None, **r})
    return rows


#: (name, B, S, H, KV, hd, q_offset) of K3's further timed shapes: the
#: serve workload's third chunk of a prompt (minicpm_2b, one rank's 18
#: heads at tp 2, and one granite rank's 12 over 4 at tp 2) and
#: qwen3_32b's full causal prefill.  (The chunks
#: at granite_moe_3b_a800m's, jamba's and phi_3_vision_4_2b's heads are
#: no longer timed, to keep the run within its budget.)
FLASH_TIMED = (("serve chunk minicpm_2b", 1, SERVE_CHUNK, 36, 36, 64,
                2 * SERVE_CHUNK),
               ("prefill qwen3_32b", 1, 1024, 64, 8, 128, 0),
               ("serve chunk minicpm_2b tp2", 1, SERVE_CHUNK, 18, 18, 64,
                2 * SERVE_CHUNK),
               ("serve chunk granite_moe_3b_a800m tp2", 1, SERVE_CHUNK, 12,
                4, 64, 2 * SERVE_CHUNK),
               # the window branch (item 12): deepseek_7b's 32 heads of
               # 128 over a prompt past its window of 8192
               ("prefill deepseek_7b window 8192", 1, 8704, 32, 32, 128, 0,
                LONG_WINDOW))


def time_flash_shapes(torch, g, shapes=None):
    """K3 at FLASH_TIMED beside its plain version and SDPA: with an
    explicit boolean mask where q_offset > 0 or a window is set (the
    same mask), ``is_causal`` otherwise.  The bound counts q, k, v read
    and the output written once, and 4 hd operations per (query row,
    visible key, head): under a window only the keys it leaves.  CUDA
    events alone, as ``time_paged_kernels``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rows = []
    for name, B, S, H, KV, hd, off, *win in shapes or FLASH_TIMED:
        window = win[0] if win else 0
        T = off + S
        q = torch.randn(B, S, H, hd, device=dev, generator=g).to(bf)
        k, v = (torch.randn(B, T, KV, hd, device=dev, generator=g).to(bf)
                for _ in range(2))
        pairs = B * H * sum(min(off + s + 1, window or off + s + 1)
                            for s in range(S))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(nbytes, 4 * hd * pairs, BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if off or window:
            idx = torch.arange(T, device=dev)
            at = off + torch.arange(S, device=dev)[:, None]
            mask = idx[None, :] <= at
            if window:
                mask = mask & (idx[None, :] > at - window)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=KV != H)
        rows.append({
            "case": name, "shape": [B, S, H, hd], "kv_heads": KV,
            "keys": T, "q_offset": off, "window": window,
            "visible_pairs": pairs,
            **measure(torch, lambda: flash_attention_cuda(
                q, k, v, q_offset=off, window=window),
                lambda: ref.flash_attention_ref(q, k, v, q_offset=off,
                                                window=window),
                library, profile=False, plain_queue=not window),
            "library_note": "SDPA, explicit boolean mask"
                            if off or window else "SDPA, is_causal",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


#: [rows, d] of K1's further timed shapes: the serve workload's prefill
#: chunk at minicpm_2b's d_model, qwen3_32b's prefill of 1024 rows, the
#: decode ticks of granite_moe_3b_a800m, deepseek_7b and qwen3_32b,
#: deepseek_v3_671b's rows, and seamless_m4t_large_v2's and
#: phi_3_vision_4_2b's decode rows and phi_3_vision_4_2b's two 592-row
#: prefills
RMSNORM_TIMED = ((SERVE_CHUNK, 2304), (1024, 5120), (4, 1536), (4, 4096),
                 (4, 5120), (4, 512), (4, 7168), (SERVE_CHUNK, 7168),
                 (4, 1024), (4, 3072), (2 * 592, 3072))


def time_rmsnorm(torch, g, shape):
    """K1 at ``shape`` = (rows, d) beside its plain version and
    ``F.rms_norm``; the bound reads x and writes the output once.  CUDA
    events alone, as ``time_paged_kernels``."""
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
                      if hasattr(F, "rms_norm") else None, profile=False),
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
            bound(kv_bytes + io, flops, BF16_FLOPS), (kv_bytes, flops, io))


def time_paged_kernels(torch, g, shape, keys, Sq):
    """K2 and K4 (the same function on the same inputs) and, at S' = 1,
    K5 at ``paged_decode_inputs``' shapes.  K5's library call is SDPA
    over K/V gathered beforehand; the gather's time stands beside it.
    Device times by CUDA events alone (no profiler start-up: the ~60
    readings here took most of ``times``' ~90 s)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (
        fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels import ops
    name, H, KV, hd = shape
    args, b4, (kv_bytes, flops, io) = paged_decode_inputs(torch, g, shape,
                                                          keys, Sq)
    if name == "minicpm_2b" and Sq == 1:
        COST_KERNELS["fused_flash_decode_splitk"] = (
            lambda: ops.fused_flash_decode(*on_meta(*args[:6]),
                                           args[6].cpu(),
                                           *on_meta(args[7]), split_k=True),
            kv_bytes + io, flops)
    common = {"shape": list(args[0].shape), "arch": name, "kv_heads": KV,
              "keys": list(keys), "block_size": args[3].shape[1],
              "library_note": "no single PyTorch call rotates, scatters "
                              "into a paged arena and attends",
              "bound_ms": b4[0], "bound_by": b4[1]}
    k4 = measure(torch, lambda: fused_flash_decode_splitk_cuda(*args),
                 lambda: ref.fused_flash_decode_ref(*args), None,
                 profile=False)
    k2 = measure(torch, lambda: fused_flash_decode_cuda(*args), None, None,
                 profile=False)
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
    b5_bytes = kv_bytes + 2 * q5.numel() * 2 + tbl.numel() * 4 + B * 4
    b5 = bound(b5_bytes, flops, BF16_FLOPS)
    if name == "minicpm_2b":
        COST_KERNELS["paged_attention"] = (
            lambda: ops.paged_attention(*on_meta(q5, kp, vp, tbl),
                                        pos.cpu()), b5_bytes, flops)
    idx = torch.arange(T_len, device=dev)
    mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]

    def gather():
        return (kp[tbl.long()].reshape(B, T_len, KV, hd).transpose(1, 2),
                vp[tbl.long()].reshape(B, T_len, KV, hd).transpose(1, 2))

    kg, vg = gather()
    qs = q5[:, :, None, :]
    gather_ms = cuda_ms(torch, gather, profile=False)[0]
    out["paged_attention"] = {
        "shape": [B, H, hd], "arch": name, "keys": list(keys),
        "block_size": kp.shape[1],
        **measure(torch, lambda: paged_attention_cuda(q5, kp, vp, tbl, pos),
                  lambda: ref.paged_attention_ref(q5, kp, vp, tbl, pos),
                  lambda: F.scaled_dot_product_attention(
                      qs, kg, vg, attn_mask=mask, enable_gqa=KV != H),
                  profile=False),
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
    phase_f2(torch)
    phase_captured(torch, {**serve_tokens, "graph_serve": graph_tokens,
                           "serve_preempt_decode": preempt_tokens["default"]},
                   smi)
    # tensor-parallel serving on the one card, with the engines freed:
    # minicpm_2b at tp 2 (20 layers, bf16; 8 layers in f32), then
    # granite_moe_3b_a800m (16 layers), jamba's first two layers and
    # xlstm_1_3b's first layer group at tp 2 (granite's and xlstm's
    # first 8 layers in f32), then qwen3_32b's first two layers at tp 2
    # and tp 4; a mesh's worker processes start once (TP_POOL)
    free_card(torch)
    global TP_POOL
    from repro_torch.sharding.group import WorkerPool
    TP_POOL = WorkerPool()
    tp_counts = [phase_tp_serve(torch, smi)]
    phase_tp_f32(torch)
    tp_counts.append(phase_tp_moe(torch, smi))
    tp_counts.append(phase_tp_hybrid(torch, smi))
    tp_counts.append(phase_tp_state(torch, smi))
    phase_tp_mixers_f32(torch)
    tp_counts.append(phase_tp_gqa(torch, smi))
    # minicpm_2b at tp 8: K/V on head_dim (item 11b-ii); its 7 workers
    # start for the phase, and then train minicpm_2b's two layers on a
    # (data 1, model 8) mesh (item 11c-i: the sequence arm)
    hd_pool = WorkerPool()
    tp_counts.append(phase_tp_hd(torch, smi, hd_pool))
    phase_train_mesh_seq(torch, smi, hd_pool)
    hd_pool.close()
    # TP_POOL's idle workers (one of tp 2, three of tp 4) hold no engine,
    # only their CUDA contexts: they stay for tp_mla, tp_encdec and the
    # training meshes, which take them instead of starting their own
    free_card(torch)
    # granite_moe_3b_a800m
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
    # the recurrent and hybrid stacks: xlstm_1_3b, jamba's first two layers
    phase_recurrent_rows(torch)
    rec_counts = [phase_xlstm_main_path(torch)]
    free_card(torch)
    rec_counts.append(phase_xlstm_serve(torch, smi))
    free_card(torch)
    rec_counts.append(phase_xlstm_graph_serve(torch, smi))
    free_card(torch)
    rec_counts.append(phase_hybrid_serve(torch, smi))
    free_card(torch)
    # deepseek_v3_671b's first two layers at full width: MLA, a dense head
    # layer and a MoE layer
    phase_mla_layer_vs_cpu(torch)
    ds_counts = [phase_mla_main_path(torch)]
    free_card(torch)
    ds_counts.append(phase_mla_serve(torch, smi))
    free_card(torch)
    # sliding windows (item 12): deepseek_7b at window 8192 at full width
    # and depth, deepseek_v3's dense head layer with the window
    ds_counts.append(phase_window_main_path(torch, smi))
    ds_counts.append(phase_mla_window(torch, smi))
    # deepseek_v3 and seamless at tp 2 (item 11b-ii) share one worker
    tp_counts.append(phase_tp_mla(torch, smi))
    free_card(torch)
    # the modality stubs at full width and depth: phi_3_vision_4_2b (patch
    # embeddings before the prompt) and seamless_m4t_large_v2 (the
    # encoder-decoder)
    stub_counts = [phase_vlm_main_path(torch)]
    stub_counts.append(phase_vlm_serve(torch, smi))
    stub_counts.append(phase_encdec_main_path(torch, smi))
    tp_counts.append(phase_tp_encdec(torch, smi))
    free_card(torch)
    # training on a (data 2, model 2) mesh of ranks on the card (item
    # 11c-i): minicpm_2b's first 2 layers, granite_moe_3b_a800m's first 2
    # with expert parallelism; then (item 11c-ii) xlstm_1_3b's
    # sequence-parallel mLSTM layer, jamba's two layers and
    # deepseek_v3_671b's head layer and MTP head with Adafactor; all on
    # TP_POOL's workers, which then stop: the single-card training below
    # (jamba's ~59 GB) wants the memory their CUDA contexts hold
    global TRAIN_POOL
    TRAIN_POOL = TP_POOL
    phase_train_mesh(torch, smi)
    phase_train_ep(torch, smi)
    phase_train_mesh_sp(torch, smi)
    phase_train_mesh_hybrid(torch, smi)
    phase_train_mesh_mla(torch, smi)
    TP_POOL.close()
    free_card(torch)
    # training: minicpm_2b at full width and depth, xlstm_1_3b at full
    # width, jamba's first two layers at full width
    train_counts = [phase_train_main_path(torch, smi),
                    phase_train_recurrent(torch, smi),
                    phase_train_hybrid(torch, smi)]
    free_card(torch)
    times = phase_times(torch)
    # the op counter against the four steps timed above and the kernel rows
    phase_cost_model(torch, smi, steps=4)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        t = times[name]
        launches = (counts[name] + serve_counts[name] + graph_counts[name]
                    + preempt_counts[name]
                    + sum(c.get(name, 0) for c in moe_counts + rec_counts
                          + ds_counts + stub_counts + train_counts
                          + tp_counts))
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
