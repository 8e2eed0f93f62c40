"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) —
one ``nvcc`` per source, all started together — and linked into one
shared library with a plain C interface, loaded through ``ctypes``.
The build happens at first use, never at import, into
``build/kernels/<hash of the sources>/`` at the repository root, so an
edited source gets a fresh build and an unchanged one is reused.

``launches`` holds one plain integer per kernel; a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its path went through the kernels.  A CUDA graph's capture runs the
wrappers without launching anything, and its replays launch without
running them: the capture counts apart (:func:`counted_apart`) and each
replay adds what it recorded (:func:`add_launches`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0,
                            "fused_flash_decode": 0,
                            "fused_flash_decode_splitk": 0,
                            "paged_attention": 0}


@contextlib.contextmanager
def counted_apart() -> Iterator[Dict[str, int]]:
    """Count the launches made inside apart: yields a dict that holds
    them (by kernel name) on exit, and leaves ``launches`` as it was."""
    before = dict(launches)
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        for name, n in launches.items():
            if n != before[name]:
                made[name] = n - before[name]
        launches.update(before)


def add_launches(made: Dict[str, int]) -> None:
    """Count ``made`` (kernel name -> launches) as launched."""
    for name, n in made.items():
        launches[name] += n


_V = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point; each returns a cudaError_t
SIGNATURES = {
    # x, scale, out, rows, d, eps, dtype, threads, vecs (the launch
    # plan), stream
    "repro_rmsnorm": [_V, _V, _V, _I, _I, _F, _I, _I, _I, _V],
    # q, k, v, out, B, S, T, H, KV, hd, q_offset, causal, window,
    # scale, dtype, stream
    "repro_flash_attention": [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _V],
    # q, k_new, v_new, k_pages, v_pages, tables, positions, freqs, out,
    # B, Sq, H, KV, hd, bs, P, dtype, stream
    "repro_fused_flash_decode": [_V, _V, _V, _V, _V, _V, _V, _V, _V, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _V],
    # the same, then part (f32 scratch), out, B, Sq, H, KV, hd, bs, P,
    # NS (splits), dtype, stream
    "repro_fused_flash_decode_splitk": [_V, _V, _V, _V, _V, _V, _V, _V, _V,
                                        _V, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _I, _V],
    # keys per split of the split-K kernel
    "repro_splitk_span": [],
    # q, k_pages, v_pages, tables, positions, part (f32 scratch, bf16
    # only), out, B, H, KV, hd, bs, P, NS (splits), dtype, stream
    "repro_paged_attention": [_V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I,
                              _I, _I, _I, _I, _V],
    # keys per split of the bf16 paged-attention kernel
    "repro_paged_span": [],
}

#: dtype codes shared with csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA "
                           "kernels cannot be built")
    return found


def build() -> Path:
    """Compile the sources (when this hash has no library yet) and return
    the library's path.  Raises with nvcc's output on failure."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [_I]
        handle.repro_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        text = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def check_operand(name: str, t: torch.Tensor, dtype=None,
                  aligned: bool = True) -> None:
    """The checks every kernel wrapper makes before passing a pointer:
    a supported dtype, contiguous, on a CUDA device, and 16-byte aligned
    where the kernel reads it in 16-byte vectors (``aligned``)."""
    allowed = tuple(DTYPE_CODE) if dtype is None else (dtype,)
    if t.dtype not in allowed:
        raise ValueError(f"{name}: dtype {t.dtype} not supported by the "
                         f"kernel (want one of {allowed})")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor "
                         f"(got strides {t.stride()})")
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                         f"got one on {t.device}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned "
                         f"pointer")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
