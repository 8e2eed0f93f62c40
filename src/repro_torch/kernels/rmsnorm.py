"""K1 — fused RMSNorm: the CUDA kernel's wrapper and its plain version.

Replaces the JAX package's ``kernels/rmsnorm.py:rmsnorm_kernel``; the
kernel is ``csrc/rmsnorm.cu`` (one warp per row, 16-byte vector loads,
f32 reduction — bound by bytes).
"""
from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["rmsnorm_cuda", "rmsnorm_ref"]


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` with the CUDA kernel.
    ``scale`` has x's dtype; the last dim holds whole 16-byte vectors."""
    build.check_operand("x", x)
    build.check_operand("scale", scale, x.dtype)
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if (d * x.element_size()) % 16:
        raise ValueError(f"rmsnorm kernel: last dim {d} is not a whole "
                         f"number of 16-byte vectors")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = build.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODE[x.dtype], build.stream_handle(x))
    build.check(err, "rmsnorm")
    build.launches["rmsnorm"] += 1
    return out
