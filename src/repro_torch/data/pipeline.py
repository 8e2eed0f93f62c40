"""Deterministic synthetic data pipeline.

No external datasets ship with the container, so training examples consume a
seeded synthetic token stream with Zipfian unigram statistics and local
n-gram structure (so the loss actually decreases — the model can learn the
transition table).  Determinism: batch ``i`` depends only on (seed, i).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticTextDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # fixed random bigram transition: tok -> 8 likely successors
        self._succ = rng.randint(0, self.vocab_size,
                                 size=(min(self.vocab_size, 4096), 8))

    def batch(self, index: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + index) % (2**31 - 1))
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        cur = rng.randint(0, self.vocab_size, size=batch_size)
        toks[:, 0] = cur
        for t in range(1, self.seq_len + 1):
            follow = rng.rand(batch_size) < 0.8
            succ = self._succ[cur % self._succ.shape[0],
                              rng.randint(0, 8, size=batch_size)]
            fresh = rng.randint(0, self.vocab_size, size=batch_size)
            cur = np.where(follow, succ, fresh).astype(np.int32)
            toks[:, t] = cur
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(ds: SyntheticTextDataset, batch_size: int,
            start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    i = start
    while True:
        yield ds.batch(i, batch_size)
        i += 1


def make_train_batch(cfg, shape, index: int = 0,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Concrete batch matching Model.input_shapes_for(shape) for examples
    and smoke tests (not used by the dry-run, which lowers abstract)."""
    rng = np.random.RandomState(seed * 7919 + index)
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
        ds = SyntheticTextDataset(cfg.vocab_size, S, seed)
        b = ds.batch(index, B)
        out["tokens"], out["labels"] = b["tokens"], b["labels"]
    elif cfg.frontend:
        P = cfg.num_prefix_embeddings
        out["prefix_embeds"] = (rng.randn(B, P, cfg.d_model) * 0.02
                                ).astype(np.float32)
        ds = SyntheticTextDataset(cfg.vocab_size, S - P, seed)
        b = ds.batch(index, B)
        out["tokens"] = b["tokens"]
        lab = np.concatenate(
            [np.zeros((B, P), np.int32), b["labels"]], axis=1)
        out["labels"] = lab
    else:
        ds = SyntheticTextDataset(cfg.vocab_size, S, seed)
        b = ds.batch(index, B)
        out["tokens"], out["labels"] = b["tokens"], b["labels"]
    return out
