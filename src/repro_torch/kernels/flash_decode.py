"""K2 and K4 — fused flash decode: the CUDA kernels' wrappers and their
plain version.

K2 replaces the JAX package's
``kernels/flash_decode.py:fused_flash_decode_kernel`` with
``split_k=False`` (the gathered variant); its kernel is
``csrc/flash_decode.cu``: RoPE on q and the new K, the window scattered
into the arenas **in place**, and per-query-masked GQA attention over
the row's pages.  In bf16 it is one launch whose thread-block clusters
spread a row's 256-key spans over several CTAs and combine them through
distributed shared memory; in f32 one CTA per (row, kv head) streams
the row in exact f32.

K4 replaces the same function with ``split_k=True``; its kernel is
``csrc/flash_decode_splitk.cu``: the same contract with the row's keys
split across CTAs in spans of fixed absolute key positions, the
partials combined in ascending split order by a second launch.  In
bf16 both run one tensor-core span body (``csrc/decode_mma.cuh``).
Both compute :func:`fused_flash_decode_ref`'s function.
"""
from __future__ import annotations

import torch

from . import build
from .paged_attention import MAX_BF16_HEAD_DIM
from .ref import fused_flash_decode_ref, rope_freqs

__all__ = ["fused_flash_decode_cuda", "fused_flash_decode_splitk_cuda",
           "fused_flash_decode_ref", "rope_freqs"]


def _check(q, k_new, v_new, k_pages, v_pages, block_tables, positions,
           freqs):
    """The operand checks of both kernels; returns (B, Sq, H, hd, bs, KV,
    P)."""
    build.check_operand("q", q)
    for name, t in (("k_new", k_new), ("v_new", v_new),
                    ("k_pages", k_pages), ("v_pages", v_pages)):
        build.check_operand(name, t, q.dtype)
    build.check_operand("block_tables", block_tables, torch.int32, False)
    build.check_operand("positions", positions, torch.int32, False)
    build.check_operand("freqs", freqs, torch.float32, False)
    B, Sq, H, hd = q.shape
    NB, bs, KV = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    if (tuple(k_new.shape) != (B, Sq, KV, hd) or k_new.shape != v_new.shape
            or tuple(k_pages.shape) != (NB, bs, KV, hd)
            or k_pages.shape != v_pages.shape
            or tuple(block_tables.shape) != (B, P)
            or tuple(positions.shape) != (B,)
            or tuple(freqs.shape) != (hd // 2,)):
        raise ValueError(
            f"fused flash decode: inconsistent shapes q {tuple(q.shape)}, "
            f"k_new {tuple(k_new.shape)}, v_new {tuple(v_new.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}, positions "
            f"{tuple(positions.shape)}, freqs {tuple(freqs.shape)}")
    if H % KV or hd % 8:
        raise ValueError(f"fused flash decode: needs heads % kv_heads == 0 "
                         f"and head_dim % 8 == 0 (H={H}, KV={KV}, hd={hd})")
    if q.dtype == torch.bfloat16 and (hd % 16 or hd > MAX_BF16_HEAD_DIM):
        raise ValueError(f"fused flash decode kernel: bf16 head_dim {hd} is "
                         f"not a multiple of 16 up to {MAX_BF16_HEAD_DIM}")
    return B, Sq, H, hd, bs, KV, P


def fused_flash_decode_cuda(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            positions: torch.Tensor, freqs: torch.Tensor
                            ) -> torch.Tensor:
    """K2: the contract of :func:`fused_flash_decode_ref`, on the card.
    ``k_pages``/``v_pages`` are updated in place; returns the attention
    output [B, S', H, hd]."""
    B, Sq, H, hd, bs, KV, P = _check(q, k_new, v_new, k_pages, v_pages,
                                     block_tables, positions, freqs)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = build.lib().repro_fused_flash_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
        freqs.data_ptr(), out.data_ptr(), B, Sq, H, KV, hd, bs, P,
        build.DTYPE_CODE[q.dtype], build.stream_handle(q))
    build.check(err, "fused_flash_decode")
    build.launches["fused_flash_decode"] += 1
    return out


def fused_flash_decode_splitk_cuda(q: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor,
                                   k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   positions: torch.Tensor,
                                   freqs: torch.Tensor) -> torch.Tensor:
    """K4: K2's contract with split-K partials.  Allocates the f32
    partials, ``[B, KV, splits, S' * H / KV, hd + 2]`` with one split
    per span of the kernel's fixed key count; two launches, one call."""
    B, Sq, H, hd, bs, KV, P = _check(q, k_new, v_new, k_pages, v_pages,
                                     block_tables, positions, freqs)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.lib()
    span = lib.repro_splitk_span()
    NS = -(-(P * bs) // span)
    part = torch.empty(B * KV * NS * Sq * (H // KV) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    err = lib.repro_fused_flash_decode_splitk(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
        freqs.data_ptr(), part.data_ptr(), out.data_ptr(), B, Sq, H, KV, hd,
        bs, P, NS, build.DTYPE_CODE[q.dtype], build.stream_handle(q))
    build.check(err, "fused_flash_decode_splitk")
    build.launches["fused_flash_decode_splitk"] += 1
    return out
