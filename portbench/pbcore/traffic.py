"""The one generator of serving traffic: a mix file's parameters in,
requests out.

Every seed gets the same sizes in the same order: the prompt and output
lengths are the quantiles of the mix's distributions on a fixed grid of
``pool`` points, shuffled once by a fixed draw, and the seed draws the
token ids (and the system prompts).  So two seeds put the same work in a
run, and differ in what the tokens are.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


#: the one shuffle of the sizes, the same for every seed
ORDER_SEED = 20240406


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray          # int32 token ids
    new_tokens: int
    system: int                 # which shared system prompt (-1: none)


def quantile_sizes(dist: Dict, n: int) -> List[int]:
    """``n`` sizes at the quantiles (i + 0.5) / n of ``dist``."""
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "lognormal":
            x = dist["median"] * math.exp(dist["sigma"]
                                          * NormalDist().inv_cdf(u))
            v = int(round(x))
        elif dist["dist"] == "uniform":
            v = lo + int(u * (hi - lo + 1))
        else:
            raise ValueError(f"unknown distribution {dist['dist']!r}")
        out.append(min(hi, max(lo, v)))
    return out


class ServeTraffic:
    """The requests of one run of a serving mix, from ``seed``."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.seed = int(seed)
        n = int(mix["pool"])
        order = np.random.default_rng(ORDER_SEED)
        self.user_lens = order.permutation(
            np.asarray(quantile_sizes(mix["user_len"], n)))
        self.new_lens = order.permutation(
            np.asarray(quantile_sizes(mix["new_tokens"], n)))
        S, L = int(mix["system_prompts"]), int(mix["system_len"])
        sys_rng = np.random.default_rng([self.seed, 2])
        self.systems = [sys_rng.integers(0, self.vocab, L, dtype=np.int64)
                        .astype(np.int32) for _ in range(S)]

    def __len__(self) -> int:
        return len(self.user_lens)

    def request(self, i: int) -> Request:
        rng = np.random.default_rng([self.seed, 3, i])
        user = rng.integers(0, self.vocab, int(self.user_lens[i]),
                            dtype=np.int64).astype(np.int32)
        sys_i = i % len(self.systems) if self.systems else -1
        prompt = np.concatenate([self.systems[sys_i], user]) \
            if sys_i >= 0 else user
        return Request(i, prompt, int(self.new_lens[i]), sys_i)

    def client_requests(self, client: int, clients: int):
        """Client ``client``'s requests, in the order it sends them."""
        for i in range(client, len(self), clients):
            yield self.request(i)

    def warmup(self, n: int, new_tokens: int = 3) -> List[Request]:
        """``n`` requests over the mix's range of prompt lengths, behind a
        system prompt that no request of the window has, so that the
        window starts with no prefix of its own cached."""
        mix = self.mix
        rng = np.random.default_rng([self.seed, 4])
        L = int(mix["system_len"])
        system = rng.integers(0, self.vocab, L, dtype=np.int64) \
            .astype(np.int32)
        sizes = quantile_sizes(mix["user_len"], n)
        out = []
        for i, m in enumerate(sizes):
            user = rng.integers(0, self.vocab, m, dtype=np.int64) \
                .astype(np.int32)
            out.append(Request(-1 - i, np.concatenate([system, user]),
                               new_tokens, -1))
        return out
