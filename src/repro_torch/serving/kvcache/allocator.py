"""Block-pool allocator for the paged KV cache.

The arena is one preallocated device pytree (per-layer K/V leaves shaped
``[num_blocks, block_size, ...]``); this module is the *host-side*
bookkeeping over it: a free list of fixed-size token blocks, per-block
reference counts (shared prompt-prefix blocks are refcounted, not copied),
and a reservation ledger that makes admission block-availability-aware —
a request is only admitted once its worst-case block demand is reserved,
so decode-time extension can never fail mid-flight (no preemption path is
needed and FlowLimiter back-pressure reflects real memory).

Block 0 is reserved as the *null/trash* block: block tables are padded
with 0, inactive decode rows and padding scatter-writes land there, and
reads from it are always masked.  It is never allocated and never freed.

Invariants (pinned by the hypothesis property tests):

* ``len(free) + blocks_in_use == num_blocks - 1``  (block 0 excluded)
* every allocated block has ``ref >= 1``; free blocks have ``ref == 0``
* ``free`` / ``ref_dec`` on a free block raises (no double free)
* ``reserved <= len(free)`` at all times
"""
from __future__ import annotations

from typing import Dict, List


class BlockPoolError(RuntimeError):
    pass


class BlockPool:
    """Free-list + refcount accounting over ``num_blocks`` fixed blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO reuse keeps recently-touched arena pages hot
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: List[int] = [0] * self.num_blocks
        self._reserved = 0
        self.stats: Dict[str, int] = {
            "allocated": 0, "freed": 0, "cow_copies": 0,
            "peak_in_use": 0,
        }

    # -- capacity -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (including ones already reserved)."""
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Blocks that can still be reserved/allocated unreserved."""
        return len(self._free) - self._reserved

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    # -- reservations (admission control) -------------------------------
    def can_reserve(self, n: int) -> bool:
        return n <= self.available_blocks

    def reserve(self, n: int) -> None:
        """Set aside ``n`` free blocks for later ``allocate(reserved=True)``
        calls.  Admission reserves a request's worst-case demand up front."""
        if n < 0:
            raise ValueError("negative reservation")
        if not self.can_reserve(n):
            raise BlockPoolError(
                f"cannot reserve {n} blocks "
                f"({self.available_blocks} available)")
        self._reserved += n

    def release_reservation(self, n: int) -> None:
        """Return unused reservation (request finished before its worst
        case, or was cancelled)."""
        if n < 0 or n > self._reserved:
            raise BlockPoolError(
                f"release of {n} exceeds outstanding reservation "
                f"{self._reserved}")
        self._reserved -= n

    # -- alloc / free / share -------------------------------------------
    def allocate(self, *, reserved: bool = False) -> int:
        """Pop a free block (ref becomes 1).  With ``reserved=True`` the
        block is drawn from this caller's earlier :meth:`reserve`."""
        if reserved:
            if self._reserved <= 0:
                raise BlockPoolError("allocate(reserved=True) without "
                                     "an outstanding reservation")
            self._reserved -= 1
        elif self.available_blocks <= 0:
            raise BlockPoolError("block pool exhausted")
        blk = self._free.pop()
        self._ref[blk] = 1
        self.stats["allocated"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.blocks_in_use)
        return blk

    def ref_inc(self, blk: int) -> None:
        """Share an allocated block (prefix hit)."""
        self._check_live(blk)
        self._ref[blk] += 1

    def ref_count(self, blk: int) -> int:
        return self._ref[blk]

    def is_shared(self, blk: int) -> bool:
        return self._ref[blk] > 1

    def free(self, blk: int) -> bool:
        """Drop one reference; returns True when the block actually went
        back to the free list (last reference)."""
        self._check_live(blk)
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            self._free.append(blk)
            self.stats["freed"] += 1
            return True
        return False

    def cow(self, blk: int, *, reserved: bool = False) -> int:
        """Copy-on-write: writing to a shared block forks it.  Returns the
        block to write to — ``blk`` itself when unshared (no copy needed),
        otherwise a fresh block (caller must copy the arena contents and
        drop one ref on ``blk``).  With immutable full-prefix blocks the
        fork path only triggers if a caller ever writes into a shared
        block, but the allocator supports it so schedulers can rely on it.
        """
        self._check_live(blk)
        if self._ref[blk] == 1:
            return blk
        new = self.allocate(reserved=reserved)
        self._ref[blk] -= 1
        self.stats["cow_copies"] += 1
        return new

    # -- internals ------------------------------------------------------
    def _check_live(self, blk: int) -> None:
        if blk <= 0 or blk >= self.num_blocks:
            raise BlockPoolError(f"block id {blk} out of range "
                                 f"(1..{self.num_blocks - 1})")
        if self._ref[blk] <= 0:
            raise BlockPoolError(f"block {blk} is not allocated "
                                 f"(double free / stale reference)")

    def check_invariants(self) -> None:
        """Raise unless the pool is internally consistent (test hook)."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError("duplicate block on free list")
        if 0 in self._free:
            raise AssertionError("trash block 0 on free list")
        for blk in self._free:
            if self._ref[blk] != 0:
                raise AssertionError(f"free block {blk} has ref "
                                     f"{self._ref[blk]}")
        in_use = [b for b in range(1, self.num_blocks) if self._ref[b] > 0]
        if len(in_use) + len(self._free) != self.num_blocks - 1:
            raise AssertionError("free + in-use != num_blocks - 1")
        if not (0 <= self._reserved <= len(self._free)):
            raise AssertionError(
                f"reservation {self._reserved} exceeds free list "
                f"{len(self._free)}")
