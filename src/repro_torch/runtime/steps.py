"""Serving step factories, eager (no jit): prompt ingestion, lockstep
decode, continuous-batching decode and speculative verify over slot
rows, and the slot insert.

Caches are updated in place (see ``models.transformer``); each step
still returns the cache so callers read like the JAX package's.
"""
from __future__ import annotations

import torch

from ..models.model import Model
from ..models.params import flatten
from ..models.transformer import DEFAULT_FLAGS, RuntimeFlags


def make_prefill_step(model: Model, max_cache_len: int,
                      flags: RuntimeFlags = DEFAULT_FLAGS):
    def prefill_step(tokens: torch.Tensor):
        logits, cache = model.prefill(tokens, max_cache_len, flags=flags)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS):
    """Lockstep decode: every row at the same offset ``cache_pos``."""
    def decode_step(tokens, cache, cache_pos: int):
        B = tokens.shape[0]
        pos = torch.full((B,), cache_pos, dtype=torch.int32,
                         device=tokens.device)
        logits, cache = model.decode_step(tokens, cache, pos, flags=flags)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return decode_step


def _mask_tok(tok: torch.Tensor, active: torch.Tensor,
              pad_id: int) -> torch.Tensor:
    """Inactive slots emit ``pad_id``."""
    shape = (-1,) + (1,) * (tok.ndim - 1)
    return torch.where(active.reshape(shape), tok,
                       torch.full_like(tok, pad_id))


def make_serve_decode_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS,
                           pad_id: int = 0):
    """Decode one token for every slot of a continuous batch: ``positions``
    is a [N] vector of per-slot cache offsets and ``active`` a [N] bool
    mask.  Inactive slots still flow through the step (every row op is
    row-independent, so they cannot perturb active rows, and a later
    insert overwrites the whole row) but emit ``pad_id``."""
    def slot_decode_step(tokens, cache, positions, active):
        logits, cache = model.decode_step(tokens, cache, positions,
                                          flags=flags)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return _mask_tok(tok, active, pad_id), cache

    return slot_decode_step


def make_verify_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS,
                     pad_id: int = 0):
    """Speculative verification: score a ``[N, 1+k]`` window per slot in
    one pass and return the greedy argmax at every window position.
    Window token ``s`` attends under ``idx <= pos + s``, exactly what
    ``1+k`` successive one-token decode steps compute."""
    def slot_verify_step(tokens, cache, positions, active):
        logits, cache = model.decode_step(tokens, cache, positions,
                                          flags=flags, all_logits=True)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return _mask_tok(tok, active, pad_id), cache

    return slot_verify_step


def slot_batch_axis(path) -> int:
    """Axis of the slot (batch) dimension in a cache leaf: scanned-block
    leaves are [R, B, ...], so 1 under the top-level ``"blocks"`` key,
    0 everywhere else."""
    return 1 if (path and path[0] == "blocks") else 0


def make_slot_insert():
    """Build ``insert(cache, rows, row, slot)``: copy cache row ``row`` of
    a freshly prefilled batch into slot ``slot`` of the persistent slot
    cache, in place."""
    def insert(cache, rows, row: int, slot: int):
        src = flatten(rows)
        for path, big in flatten(cache).items():
            ax = slot_batch_axis(path.split("."))
            big.select(ax, slot).copy_(src[path].select(ax, row))
        return cache

    return insert

