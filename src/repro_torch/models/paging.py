"""The block-table seam: how a contiguous slot cache is presented to the
fused flash-decode kernel as a position-ordered arena.  (The paged
layout's gather/scatter paths come with the paged backend, ROADMAP
Queue 1 item 3.)"""
from __future__ import annotations

import torch


def use_fused_decode(cfg, flags) -> bool:
    """Should an attention layer's decode/verify step run through the
    fused flash-decode op?  The one predicate ``attention.py`` consults
    before deciding whether to rotate q/k outside the kernel: the fused
    path wants them un-rotated.  (Sliding-window layers, whose JAX path
    keeps the wraparound slot layout, are refused by ``check_supported``
    until they are ported.)"""
    return flags.use_fused_decode


def fused_page_size(max_len: int, preferred: int = 8) -> int:
    """Page granularity for viewing a contiguous slot row as an arena;
    ``preferred`` matches the serving default block size, and rows whose
    length is not a multiple fall back to one whole-row page."""
    return preferred if max_len % preferred == 0 else max_len


def slot_arena_tables(batch: int, max_len: int, page: int,
                      device=None) -> torch.Tensor:
    """Block tables presenting a contiguous ``[N, max_len, ...]`` slot
    cache (viewed as ``[N * (max_len // page), page, ...]``) as a
    position-ordered arena: row ``b``'s page ``p`` is block ``b * P + p``.
    Every block is real; there is no trash block."""
    P = max_len // page
    return (torch.arange(batch, dtype=torch.int32, device=device)[:, None] * P
            + torch.arange(P, dtype=torch.int32, device=device)[None, :])
