"""K5 — paged decode attention: the CUDA kernel's wrapper and its plain
version.

Replaces the JAX package's
``kernels/paged_attention.py:paged_attention_kernel``; the kernel is
``csrc/paged_attention.cu``: one rotated query per row attends the
row's keys ``idx <= positions[b]`` through its block table.  No RoPE and
no scatter: the caller writes the new token first.  bf16 splits each
row's keys into spans of fixed absolute positions across CTAs (grid
(kv head, row, split)), copies K/V through a ``cp.async`` ring and
multiplies on tensor cores, then folds the f32 partials in split order
(two launches, one call); f32 runs the exact-f32 body, one CTA per
(row, kv head) streaming the keys with an online softmax.
"""
from __future__ import annotations

import torch

from . import build
from .ref import paged_attention_ref

__all__ = ["paged_attention_cuda", "paged_attention_ref"]

#: head dims of the bf16 kernel: multiples of 16 (the mma's depth) up to
#: this, one instantiation each
MAX_BF16_HEAD_DIM = 160


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """The contract of :func:`paged_attention_ref`, on the card.
    q: [B, H, hd]; k_pages/v_pages: [NB, bs, KV, hd]; block_tables:
    [B, P] int32; positions: [B] int32.  Returns [B, H, hd]."""
    build.check_operand("q", q)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        build.check_operand(name, t, q.dtype)
    build.check_operand("block_tables", block_tables, torch.int32, False)
    build.check_operand("positions", positions, torch.int32, False)
    B, H, hd = q.shape
    NB, bs, KV = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    if (tuple(k_pages.shape) != (NB, bs, KV, hd)
            or k_pages.shape != v_pages.shape
            or tuple(block_tables.shape) != (B, P)
            or tuple(positions.shape) != (B,)):
        raise ValueError(
            f"paged attention: inconsistent shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}, positions "
            f"{tuple(positions.shape)}")
    if H % KV or hd % 8:
        raise ValueError(f"paged attention: needs heads % kv_heads == 0 and "
                         f"head_dim % 8 == 0 (H={H}, KV={KV}, hd={hd})")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (hd % 16 or hd > MAX_BF16_HEAD_DIM):
        raise ValueError(f"paged attention kernel: bf16 head_dim {hd} is "
                         f"not a multiple of 16 up to {MAX_BF16_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.lib()
    NS = -(-(P * bs) // lib.repro_paged_span())
    # the bf16 kernel's f32 partials (m, l, acc) per (row, kv head,
    # split, query head); the f32 kernel needs none
    part = torch.empty(B * KV * NS * (H // KV) * (hd + 2) if bf16 else 0,
                       dtype=torch.float32, device=q.device)
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, H, KV, hd, bs, P, NS, build.DTYPE_CODE[q.dtype],
        build.stream_handle(q))
    build.check(err, "paged_attention")
    build.launches["paged_attention"] += 1
    return out
