"""Hash-trie prefix index for ref-counted prompt-prefix sharing.

Only *full* prompt blocks are ever shared — they are immutable by
construction (generation writes always land at positions at or beyond
the prompt tail, which lives in an unshared partial block), so sharing
needs no copy-on-write in the steady state; divergence inside a block
simply hashes to a different key and gets its own block.

A block's key is the hash chain ``key_i = H(key_{i-1}, tokens_i)`` over
the token blocks from the start of the prompt — equivalent to a trie
walk over block-sized token chunks, stored flat.  Matching a new prompt
walks the chain until the first miss; every hit is one block of prefill
compute (and storage) saved.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: chain key of the empty prefix
ROOT = ("root",)


def chain_key(parent: Tuple, tokens: Sequence[int]) -> Tuple:
    """Key of the block holding ``tokens`` whose prefix has key ``parent``.

    The key IS the nested (parent, tokens) tuple, not its hash: dict
    lookups then fall back to full equality on hash collision, so two
    different prefixes can never silently alias each other's KV blocks.
    Chains are at most max_len/block_size deep — the rehash cost is
    noise next to a prefill."""
    return (parent, tuple(int(t) for t in tokens))


class PrefixIndex:
    """Maps full-prompt-block hash chains to live arena block ids."""

    def __init__(self):
        self._by_key: Dict[Tuple, int] = {}
        self._by_block: Dict[int, Tuple] = {}
        self.stats = {"registered": 0, "hits": 0, "evicted": 0}

    def __len__(self) -> int:
        return len(self._by_key)

    def match(self, prompt: Sequence[int], block_size: int,
              max_blocks: Optional[int] = None) -> Tuple[List[int], Tuple]:
        """Longest chain of already-cached full blocks covering a prompt
        prefix.  Returns (block ids, key of the last matched block).
        ``max_blocks`` caps the walk (the scheduler always leaves at
        least one suffix token to compute, so a fully-cached prompt still
        produces its first-token logits)."""
        hits: List[int] = []
        key = ROOT
        n_full = len(prompt) // block_size
        if max_blocks is not None:
            n_full = min(n_full, max_blocks)
        for i in range(n_full):
            nxt = chain_key(key, prompt[i * block_size:(i + 1) * block_size])
            blk = self._by_key.get(nxt)
            if blk is None:
                break
            hits.append(blk)
            key = nxt
        self.stats["hits"] += len(hits)
        return hits, key

    def register(self, parent: Tuple, tokens: Sequence[int],
                 blk: int) -> Tuple:
        """Publish a freshly-written full block; returns its chain key.
        An existing entry for the same key wins (first writer keeps it —
        identical content, and its ref accounting is already in flight)."""
        key = chain_key(parent, tokens)
        if key not in self._by_key:
            self._by_key[key] = blk
            self._by_block[blk] = key
            self.stats["registered"] += 1
        return key

    def lookup(self, parent: Tuple, tokens: Sequence[int]) -> Optional[int]:
        return self._by_key.get(chain_key(parent, tokens))

    def unregister_block(self, blk: int) -> None:
        """Forget a block (its last reference was freed)."""
        key = self._by_block.pop(blk, None)
        if key is not None:
            del self._by_key[key]
            self.stats["evicted"] += 1
