"""K3 — flash attention for prefill: the CUDA kernel's wrapper and its
plain version.

Replaces the JAX package's
``kernels/flash_attention.py:flash_attention_kernel``; the kernel is
``csrc/flash_attention.cu``: a loop over k blocks fixed at absolute
multiples of 128, which keeps suffix rows of a ``q_offset`` call
bitwise equal to the full prefill's.  bf16 runs on tensor cores (one
CTA per (b, h, 64-row q tile), K/V through a ``cp.async`` ring, one
instantiation per head dim, a multiple of 16); f32 runs the exact-f32
body of scalar FMAs (one CTA per 32-row q block).
"""
from __future__ import annotations

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref", "MAX_HEAD_DIM"]

#: widest head the kernel's shared-memory tiles hold
MAX_HEAD_DIM = 160
#: the bf16 kernel's head dims are multiples of the mma's depth
BF16_HEAD_DIM_STEP = 16


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd], one dtype.  Returns [B,S,H,hd].
    Query row ``s`` sits at absolute position ``q_offset + s``."""
    build.check_operand("q", q)
    for name, t in (("k", k), ("v", v)):
        build.check_operand(name, t, q.dtype)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, hd) or k.shape != v.shape:
        raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"flash attention: {H} heads not a multiple of "
                         f"{KV} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel: head_dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and hd % BF16_HEAD_DIM_STEP:
        raise ValueError(f"flash attention kernel: bf16 head_dim {hd} is "
                         f"not a multiple of {BF16_HEAD_DIM_STEP}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, KV, hd, int(q_offset), int(bool(causal)), int(window),
        float(hd) ** -0.5, build.DTYPE_CODE[q.dtype], build.stream_handle(q))
    build.check(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out
