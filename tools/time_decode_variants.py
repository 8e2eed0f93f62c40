#!/usr/bin/env python3
"""Time K2 and K4 (the fused flash-decode kernels of the PyTorch/CUDA
port) built with other ring depths and cluster sizes, on one card.

    python3 tools/time_decode_variants.py [--stages 2 3] [--clusters 2 4]
                                          [--parent DIR]

For each (stages, cluster) pair, copies ``src/repro_torch/kernels/csrc``
into ``build/variants/`` with ``kDecodeStages`` (``decode_mma.cuh``)
and ``kCluster`` (``flash_decode.cu``) set to the pair, and builds K2
and K4 from the copy; ``--parent`` adds the kernels of another checkout
(its root), unchanged.  All builds start together.  Then, for each
variant in turn (the parent first and again last), holds K2 and K4
against their plain version and times them with ``chip_smoke.py``'s
CUDA-event timer, at windows of 1 and 5 queries, on paged arenas of
block 16: minicpm_2b's serve-tick rows (300-930 keys), its engine-tick
rows (31-51 keys) and qwen3_32b's 4 rows of 4096 keys.  K4 has no
cluster, so it is timed at the first cluster size only.  Prints one
JSON line per reading and the card's name and power limit; exits
non-zero without a card or when a variant disagrees with the plain
version.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: (name, H, KV, hd) and keys per row of the timed shapes
SHAPES = ((("minicpm_2b", 36, 36, 64), (300, 520, 700, 930)),
          (("minicpm_2b", 36, 36, 64), (31, 33, 47, 51)),
          (("qwen3_32b", 64, 8, 128), (4096,) * 4))
#: (file, constant) of the two settings a variant changes
SETTINGS = (("decode_mma.cuh", "kDecodeStages"),
            ("flash_decode.cu", "kCluster"))
ENTRY_POINTS = ("repro_fused_flash_decode", "repro_fused_flash_decode_splitk",
                "repro_splitk_span")


def build_variants(variants):
    """{name: loaded library} for ``variants`` = {name: (csrc directory,
    {constant: value})}, every build started at once."""
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    procs = {}
    for name, (csrc, settings) in variants.items():
        out = ROOT / "build" / "variants" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out / "csrc")
        for fname, const in SETTINGS:
            if const not in settings:
                continue
            path = out / "csrc" / fname
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {settings[const]};",
                              path.read_text())
            if n != 1:
                raise SystemExit(f"{fname}: no single `{const}` to set")
            path.write_text(text)
        srcs = [out / "csrc" / f for f in ("flash_decode.cu",
                                           "flash_decode_splitk.cu",
                                           "errors.cu")]
        lib = out / "libvariant.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(out / "csrc"),
               *map(str, srcs), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for entry in ENTRY_POINTS:
            fn = getattr(handle, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [ctypes.c_int]
        handle.repro_error_string.restype = ctypes.c_char_p
        libs[name] = handle
        print(json.dumps({"variant": name, "ptxas": sorted(set(
            ln.split(":", 1)[1].strip() for ln in log.splitlines()
            if "registers" in ln))}), flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--clusters", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose K2/K4 to time too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_decode_variants: needs a CUDA device")
    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_decode import (
        fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    variants = {}
    if args.parent is not None:
        variants["parent"] = (args.parent / "src" / "repro_torch" / "kernels"
                              / "csrc", {})
    for stages, cluster in itertools.product(args.stages, args.clusters):
        variants[f"s{stages}_c{cluster}"] = (
            build.CSRC, {"kDecodeStages": stages, "kCluster": cluster})
    libs = build_variants(variants)
    order = list(libs) + (["parent"] if args.parent is not None else [])
    kernels = {"K2": fused_flash_decode_cuda,
               "K4": fused_flash_decode_splitk_cuda}
    first_cluster = f"_c{args.clusters[0]}"
    ok = True
    for name in order:
        build._lib = libs[name]
        g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        for (shape, keys), Sq in itertools.product(SHAPES, (1, 5)):
            ins, (b_ms, b_by), _ = chip_smoke.paged_decode_inputs(
                torch, g, shape, keys, Sq)
            plain = [t.clone() for t in ins[3:5]]
            want = ref.fused_flash_decode_ref(*ins[:3], *plain, *ins[5:])
            for kname, fn in kernels.items():
                if kname == "K4" and not (name == "parent"
                                          or name.endswith(first_cluster)):
                    continue
                arena = [t.clone() for t in ins[3:5]]
                got = fn(*ins[:3], *arena, *ins[5:])
                err, good = chip_smoke.close(got, want,
                                             chip_smoke.TOL["bfloat16"])
                ok = ok and good
                ms = chip_smoke.cuda_ms(torch, lambda: fn(*ins))[0]
                print(json.dumps({
                    "variant": name, "kernel": kname, "arch": shape[0],
                    "keys": list(keys), "Sq": Sq, "ms": ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "max_abs_err": err, "ok": good}), flush=True)
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
