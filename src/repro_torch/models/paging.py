"""The block-table seam for paged KV caches (the JAX ``models/paging``).

Every place the model layer touches K/V through a block table funnels
through this module: the tail-block scatter of a decode step, the page
gather that reconstructs a sequence in position order, the prefix
gather of chunked/prefix-extend prefill, and the view of a contiguous
slot cache as a position-ordered arena for the fused decode kernels.
A gather in position order IS the contiguous row, which keeps the paged
paths bitwise equal to the slot ones.

``PagedPrefix`` / ``SlotPrefix`` name the two cache layouts a
prefix-extend prefill can read its prefix from: a block-pool arena
reached through a block table, or a contiguous slot row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class PagedPrefix:
    """Prefix K/V lives in a paged arena, reached via ``block_tables``
    ([B, P] int32) with pages of ``block_size`` tokens."""
    block_tables: torch.Tensor
    block_size: int


@dataclasses.dataclass(frozen=True)
class SlotPrefix:
    """Prefix K/V lives in contiguous slot rows ``slots`` ([B] int) of a
    ``[num_slots, max_len, ...]`` cache."""
    slots: torch.Tensor


PrefixRef = Union[PagedPrefix, SlotPrefix]


def tail_refs(block_tables: torch.Tensor, pos: torch.Tensor,
              block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block ids, in-block offsets) of each row's write position(s).

    ``pos`` is [B] (one write per row — plain decode) or [B, S']
    (speculative verify: S' consecutive write positions per row).  Rows
    whose table entry is the trash block 0 (inactive slots, padding)
    resolve to block 0 — writes there are harmless and block 0 is never
    read unmasked."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    if pos.ndim == 2:
        rows = rows[:, None]
    return block_tables.long()[rows, pos // block_size], pos % block_size


def scatter_token(leaf: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """Write new cache entries into their tail blocks, **in place**.
    ``blk``/``off`` are [B] with ``new`` [B, ...] (one token per row), or
    [B, S'] with ``new`` [B, S', ...] (a speculative verify window).
    Several inactive rows may all write block 0: ``index_put_`` with
    repeated indices leaves the order undefined on CUDA, which is
    harmless only because block 0 is never read unmasked."""
    leaf[blk, off] = new.to(leaf.dtype)
    return leaf


def gather_pages(leaf: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Reassemble each row's sequence in position order: [B, P*bs, ...].

    This reconstructs exactly the contiguous cache row (pages are
    gathered in table order and the table is position-ordered), which
    is the bit-identity argument for paged decode."""
    B, P = block_tables.shape
    bs = leaf.shape[1]
    return leaf[block_tables.long()].reshape((B, P * bs) + leaf.shape[2:])


def valid_mask(total_len: int, pos: torch.Tensor) -> torch.Tensor:
    """[B, T] mask of cache positions at or before each row's write
    position (position ``pos`` itself was just written this step)."""
    return torch.arange(total_len, device=pos.device)[None, :] \
        <= pos.long()[:, None]


def prefix_positions(leaf: torch.Tensor, ref: PrefixRef, prefix_len: int,
                     tp) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tensor-parallel rank's part of positions ``[0, prefix_len)`` of
    a leaf cut on its positions (a slot row's contiguous range ``[r M',
    (r + 1) M')``, every block's offsets ``[r bs', (r + 1) bs')`` of a
    paged arena): (their absolute positions [n], the rows [B, n, ...])."""
    loc = leaf.shape[1]
    dev = leaf.device
    if isinstance(ref, SlotPrefix):
        lo = tp.rank * loc
        n = max(0, min(loc, prefix_len - lo))
        return (torch.arange(lo, lo + n, device=dev),
                leaf[ref.slots.long(), :n])
    n_pages = prefix_len // ref.block_size
    ptbl = ref.block_tables[:, :n_pages].long()
    B = ptbl.shape[0]
    pos = (torch.arange(n_pages, device=dev)[:, None] * ref.block_size
           + tp.rank * loc + torch.arange(loc, device=dev)[None, :])
    return (pos.reshape(-1),
            leaf[ptbl].reshape((B, n_pages * loc) + leaf.shape[2:]))


def use_fused_decode(cfg, flags) -> bool:
    """Should an attention layer's decode/verify step run through the
    fused flash-decode op?  The one predicate ``attention.py`` consults
    before deciding whether to rotate q/k outside the kernel: the fused
    path wants them un-rotated.  Sliding-window layers never do, as in
    JAX: they keep the wraparound slot layout, whose positions are not
    monotone in the row, so no position-ordered arena view exists, and
    they decode through the plain ``attention.window_decode`` (or
    ``attention.tp_decode`` on a head_dim or sequence rank).

    On a tensor-parallel mesh (``flags.decode_shards`` > 1) each rank
    runs the op on its slice of the query and kv heads against its
    slice of the arena, which needs the kv heads to divide the ranks
    (GQA groups then stay rank-local), as in JAX (docs/SHARDING.md);
    K/V cut on head_dim or on the sequence decode through the plain
    ``attention.tp_decode``.  The recurrent layers of the state and
    hybrid layouts, and the MoE FFN, do not reach this predicate."""
    shards = flags.decode_shards
    return (flags.use_fused_decode and not cfg.sliding_window
            and (shards == 1 or cfg.num_kv_heads % shards == 0))


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


def gather_prefix_kv(mixer_cache: Dict[str, torch.Tensor], ref: PrefixRef,
                     prefix_len: int) -> Dict[str, torch.Tensor]:
    """Gather positions ``[0, prefix_len)`` of each row's cached K/V.

    The one place prefix-extend prefill dispatches on cache layout:
    paged gathers ``prefix_len // block_size`` whole pages through the
    table; slot slices the head of the contiguous row."""
    if isinstance(ref, SlotPrefix):
        return {k: a[ref.slots.long(), :prefix_len]
                for k, a in mixer_cache.items()}
    n_pages = prefix_len // ref.block_size
    ptbl = ref.block_tables[:, :n_pages].long()
    B = ref.block_tables.shape[0]
    return {k: a[ptbl].reshape((B, prefix_len) + a.shape[2:])
            for k, a in mixer_cache.items()}
