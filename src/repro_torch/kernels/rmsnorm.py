"""K1 — fused RMSNorm: the CUDA kernel's wrapper, its launch plan and its
plain version.

Replaces the JAX package's ``kernels/rmsnorm.py:rmsnorm_kernel``; the
kernel is ``csrc/rmsnorm.cu``.  Bound by bytes at a prefill's hundreds
of rows, and by the launch and a row's memory round trips at a decode
tick's few: one CTA per row holds the whole row in registers (one read
of x, one write of the output, the row's loads all in flight at once)
and sums its squares in a fixed order, so that a row's bits depend on
its width and dtype alone, never on the row count.  :func:`launch_plan`
is that CTA's shape.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["launch_plan", "rmsnorm_cuda", "rmsnorm_ref"]

#: the most threads and 16-byte vectors a thread of K1's CTA takes
#: (``kMaxThreads``, ``kMaxVecs`` in csrc/rmsnorm.cu): rows of up to
#: 2048 vectors, bf16 d 16384 or f32 d 8192
MAX_THREADS = 256
MAX_VECS = 8


def launch_plan(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(threads, vectors a thread) of K1's CTA for rows of ``d``
    elements of ``dtype``: the fewest vectors a thread that keep the CTA
    within ``MAX_THREADS``, then the fewest whole warps that cover the
    row.  A function of ``(d, dtype)`` alone, whatever the row count.
    Each thread holds ``vecs`` vectors of x and of scale: 8 * vecs
    registers."""
    size = torch.empty((), dtype=dtype).element_size()
    if d < 1 or (d * size) % 16:
        raise ValueError(f"rmsnorm kernel: last dim {d} is not a whole "
                         f"number of 16-byte vectors")
    nvec = d * size // 16
    vecs = -(-nvec // MAX_THREADS)
    if vecs > MAX_VECS:
        raise ValueError(f"rmsnorm kernel: a row of {d} {dtype} elements "
                         f"is wider than {MAX_THREADS * MAX_VECS} 16-byte "
                         f"vectors")
    return 32 * -(-nvec // (32 * vecs)), vecs


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` with the CUDA kernel.
    ``scale`` has x's dtype; the last dim holds whole 16-byte vectors."""
    build.check_operand("x", x)
    build.check_operand("scale", scale, x.dtype)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    threads, vecs = launch_plan(d, x.dtype)
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = build.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODE[x.dtype], threads, vecs, build.stream_handle(x))
    build.check(err, "rmsnorm")
    build.launches["rmsnorm"] += 1
    return out
