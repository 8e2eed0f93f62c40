#!/usr/bin/env python3
"""Time K1 (the fused RMSNorm kernel of the PyTorch/CUDA port) against
another checkout's K1, with programmatic dependent launch, and under
other launch plans, on one card.

    python3 tools/time_rmsnorm_variants.py [--parent DIR] [--no-ticks]

Builds, all at once, K1 from ``src/repro_torch/kernels/csrc`` as it is
(``change``), a copy launched with programmatic dependent launch
(``pdl``: ``PDL_PATCHES`` launch it through ``cudaLaunchKernelEx`` with
programmatic stream serialization, its CTAs waiting at
``griddepcontrol.wait`` before they read x) and, with ``--parent``, the
K1 of another checkout (its root; its C entry takes no launch plan).
Prints each build's registers and spills per kernel instance.  Then,
in bf16:

- K1 at a decode tick's 4 rows and a prefill chunk's 256 at every width
  the port serves (1536, 2048, 2304, 4096, 5120, 8192) and at 1024 rows
  of 5120, for each variant in turns (the order, then the order
  reversed), held against the plain version, beside ``F.rms_norm`` and
  the launch floor (a 1-element ``fill_``).  ``plan128`` runs the
  change's library under the plan that aims at 128 threads instead of
  256 (more vectors a thread, fewer warps to sum).  Every reading comes
  from ``chip_smoke.py``'s timer: CUDA events over 30 calls queued back
  to back, on an x that stays in L2, as in a tick, where the op before
  K1 has just written it.
- With ticks (the default): the captured decode tick at 4 slots of
  full-width minicpm_2b and granite_moe_3b_a800m (paged arena) and
  xlstm_1_3b (state layout), one engine per variant on shared weights,
  each variant's graphs captured under its own K1, ticks in turns: the
  median wall, the captured decode graph's device ms by CUDA events
  and K1's ms per tick from torch.profiler.

Prints one JSON line per reading and the card's name and power limit;
exits non-zero without a card or when a variant disagrees with the
plain version.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: the widths the port serves: granite, xlstm, minicpm, deepseek_7b,
#: qwen3/stablelm, jamba
WIDTHS = (1536, 2048, 2304, 4096, 5120, 8192)
SHAPES = tuple((r, d) for d in WIDTHS for r in (4, 256)) + ((1024, 5120),)
#: the threads another launch plan aims at (the kernel's is 256)
PLAN_TARGETS = (128,)
TICK_READS = 60
_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C entry of the parent's K1, which takes no plan
PARENT_SIGNATURE = [_V, _V, _V, _I, _I, _F, _I, _V]
#: (text of csrc/rmsnorm.cu, its replacement) that make the ``pdl`` copy
PDL_PATCHES = (
    ("""  // the whole row in flight""",
     """  asm volatile("griddepcontrol.wait;" ::: "memory");
  // the whole row in flight"""),
    ("""  rmsnorm_kernel<T, V><<<a.rows, a.threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<T*>(a.out), a.d, a.eps);
  return cudaGetLastError();""",
     """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.rows);
  cfg.blockDim = dim3(a.threads);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rmsnorm_kernel<T, V>, static_cast<const T*>(a.x),
      static_cast<const T*>(a.scale), static_cast<T*>(a.out), a.d, a.eps);
  return err != cudaSuccess ? err : cudaGetLastError();"""))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants(variants):
    """{name: loaded library} for ``variants`` = {name: (csrc
    directory, [(text of rmsnorm.cu, replacement)])}, every build started
    at once; prints each build's registers and spills."""
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    procs = {}
    for name, (csrc, patches) in variants.items():
        out = ROOT / "build" / "variants" / f"rmsnorm_{name}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out / "csrc")
        path = out / "csrc" / "rmsnorm.cu"
        text = path.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"rmsnorm.cu: no single {old!r} to patch")
            text = text.replace(old, new)
        path.write_text(text)
        lib = out / "libvariant.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(out / "csrc"),
               str(path), str(out / "csrc" / "errors.cu"), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        handle.repro_rmsnorm.argtypes = (
            PARENT_SIGNATURE if name == "parent"
            else build.SIGNATURES["repro_rmsnorm"])
        handle.repro_rmsnorm.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [_I]
        handle.repro_error_string.restype = ctypes.c_char_p
        libs[name] = handle
        emit({"variant": name, "ptxas": ptxas_by_kernel(log)})
    return libs


def ptxas_by_kernel(log):
    """{kernel instance: its registers, spills and shared memory} from
    nvcc's ``-Xptxas -v`` output."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    return out


def plan_for(target):
    """K1's launch plan rule aiming at ``target`` threads."""
    import torch

    def plan(d, dtype):
        nvec = d * torch.empty((), dtype=dtype).element_size() // 16
        vecs = -(-nvec // target)
        return 32 * -(-nvec // (32 * vecs)), vecs
    return plan


def wrapper(torch, lib, plan):
    """K1's wrapper on ``lib``: with ``plan`` (None: the parent's entry,
    which takes none).  Counts its launches as the port's does."""
    from repro_torch.kernels import build

    def rmsnorm(x, scale, *, eps=1e-5):
        d = x.shape[-1]
        out = torch.empty_like(x)
        extra = () if plan is None else plan(d, x.dtype)
        err = lib.repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d,
            d, float(eps), build.DTYPE_CODE[x.dtype], *extra,
            build.stream_handle(x))
        if err:
            raise RuntimeError(f"rmsnorm: CUDA error {err} "
                               f"({lib.repro_error_string(err).decode()})")
        build.launches["rmsnorm"] += 1
        return out
    return rmsnorm


@contextlib.contextmanager
def using(fn):
    """Run the port's K1 op through ``fn`` inside."""
    from repro_torch.kernels import ops
    saved = ops.rmsnorm_cuda
    ops.rmsnorm_cuda = fn
    try:
        yield
    finally:
        ops.rmsnorm_cuda = saved


def time_shapes(torch, chip_smoke, fns):
    """Each of ``fns`` at SHAPES in turns, held against the plain
    version; ``F.rms_norm`` and the launch floor beside them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    ok = True
    one = torch.zeros(1, device="cuda")
    floor = [chip_smoke.cuda_ms(torch, lambda: one.fill_(1.0))[0]]
    order = list(fns) + list(fns)[::-1]
    for rows, d in SHAPES:
        x = torch.randn(rows, d, device="cuda", generator=g).to(
            torch.bfloat16)
        s = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(
            torch.bfloat16)
        want = ref.rmsnorm_ref(x, s)
        b_ms, b_by = chip_smoke.bound(2 * x.numel() * 2 + d * 2,
                                      4 * x.numel(), chip_smoke.F32_FLOPS)
        ms = {name: [] for name in fns}
        worst = 0.0
        for name in order:
            fn = fns[name]
            err, good = chip_smoke.close(fn(x, s), want,
                                         chip_smoke.TOL["bfloat16"])
            ok, worst = ok and good, max(worst, err)
            ms[name].append(chip_smoke.cuda_ms(torch, lambda: fn(x, s))[0])
        library = chip_smoke.cuda_ms(
            torch, lambda: F.rms_norm(x, (d,), s, 1e-5))[0]
        floor.append(chip_smoke.cuda_ms(torch, lambda: one.fill_(1.0))[0])
        emit({"shape": [rows, d], "ms": ms, "library_ms": library,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst,
              "ok": ok})
    emit({"launch_floor_ms": floor, "median": statistics.median(floor)})
    return ok


def tick_engines(torch, chip_smoke, arch, names):
    """{variant: engine} of ``arch`` on one set of weights from the seed,
    and (backend factory, requests, Scheduler keywords)."""
    from repro_torch.serving import LLMEngine, PagedBackend
    if arch == "xlstm_1_3b":
        cfg, max_len = chip_smoke.xlstm_config(), chip_smoke.STATE_MAX_LEN
        requests = chip_smoke.state_requests(cfg.vocab_size)
        longest = max(p.size for p in requests[:chip_smoke.SERVE_SLOTS])
        make = chip_smoke.state_backend()
        kw = {"chunk_size": chip_smoke.STATE_CHUNK,
              "max_new_tokens": max_len - longest - 1}
    else:
        from repro_torch.configs import get_config
        cfg, max_len = get_config(arch), chip_smoke.SERVE_MAX_LEN
        requests = chip_smoke.serve_requests(cfg.vocab_size)

        def make(e):
            return PagedBackend(e, chip_smoke.SERVE_SLOTS,
                                num_blocks=chip_smoke.ROOMY_BLOCKS,
                                block_size=chip_smoke.SERVE_BLOCK)
        kw = {"chunk_size": chip_smoke.SERVE_CHUNK,
              "max_new_tokens": 3 + TICK_READS + 10}
    first = LLMEngine(cfg, max_len=max_len, seed=chip_smoke.SEED)
    weights = dict(first.model.named_parameters())
    engines = {names[0]: first}
    for name in names[1:]:
        engines[name] = LLMEngine(cfg, weights, max_len=max_len)
    return engines, make, requests, kw


def variant_ticks(torch, chip_smoke, arch, fns):
    """The captured decode tick of ``arch`` at 4 slots, one engine per
    variant of ``fns``, in turns: 3 ticks of warm-up (the first
    captures), TICK_READS read; the decode graph's device ms by CUDA
    events; K1's and all kernels' ms per tick from the profiler."""
    import numpy as np
    from repro_torch.serving import Scheduler
    engines, make, requests, kw = tick_engines(torch, chip_smoke, arch,
                                               list(fns))
    kind = "state" if arch == "xlstm_1_3b" else "paged"
    scheds = {}
    for name, engine in engines.items():
        with using(fns[name]):
            sched = Scheduler(make(engine), **kw)
            for i, p in enumerate(requests[:chip_smoke.SERVE_SLOTS]):
                sched.submit({"tokens": p, "id": i})
            while sched.ingesting or sched.waiting:
                sched.admit()
        scheds[name] = sched
    times = {name: [] for name in scheds}
    for i in range(3 + TICK_READS):
        for name, sched in scheds.items():
            with using(fns[name]):
                t0 = time.perf_counter()
                sched.step()
                if i >= 3:
                    times[name].append((time.perf_counter() - t0) * 1e3)
    for name, sched in scheds.items():
        with using(fns[name]):
            per = chip_smoke.profiled_ms(torch, sched.step, 5)
        ms = times[name]
        emit({"arch": arch, "layout": kind, "variant": name,
              "ticks": len(ms), "ms_median": statistics.median(ms),
              "ms_p10": float(np.percentile(ms, 10)),
              "ms_p90": float(np.percentile(ms, 90)),
              "graph_device_ms": chip_smoke.captured_ms(
                  torch, engines[name], "decode", kind),
              "rmsnorm_ms_per_tick": (sum(v for k, v in per.items()
                                          if "rmsnorm_kernel" in k)
                                      if per else None),
              "profiler_ms_per_tick": sum(per.values()) if per else None})
    del engines, scheds
    chip_smoke.free_card(torch)


def pdl_captures(torch, fn):
    """Whether K1 launched with programmatic dependent launch captures
    into a CUDA graph behind another kernel and replays to the eager
    result."""
    x = torch.randn(4, 2304, device="cuda").to(torch.bfloat16)
    s = torch.ones(2304, device="cuda", dtype=torch.bfloat16)
    want = fn(x + 1, s)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            got = fn(x + 1, s)
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        emit({"pdl_in_graph": False, "error": str(e)[:300]})
        return False
    equal = bool(torch.equal(got, want))
    emit({"pdl_in_graph": equal})
    return equal


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose K1 to time too")
    ap.add_argument("--no-ticks", action="store_true",
                    help="time the kernels only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_rmsnorm_variants: needs a CUDA device")
    import chip_smoke
    chip_smoke.setup()
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import launch_plan
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda})
    variants = {"change": (build.CSRC, ()), "pdl": (build.CSRC, PDL_PATCHES)}
    if args.parent is not None:
        variants["parent"] = (args.parent / "src" / "repro_torch" / "kernels"
                              / "csrc", ())
    libs = build_variants(variants)
    fns = {}
    if "parent" in libs:
        fns["parent"] = wrapper(torch, libs["parent"], None)
    fns["change"] = wrapper(torch, libs["change"], launch_plan)
    fns["pdl"] = wrapper(torch, libs["pdl"], launch_plan)
    plans = {f"plan{t}": wrapper(torch, libs["change"], plan_for(t))
             for t in PLAN_TARGETS}
    ok = time_shapes(torch, chip_smoke, {**fns, **plans})
    if not args.no_ticks:
        if not pdl_captures(torch, fns["pdl"]):
            del fns["pdl"]
        for arch in ("minicpm_2b", "granite_moe_3b_a800m", "xlstm_1_3b"):
            variant_ticks(torch, chip_smoke, arch, fns)
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
