"""LLM inference engine of the port: eager prefill + decode over a slot
KV cache, on the card.

The same surface as the JAX package's ``serving.LLMEngine``:

* :meth:`generate` — classic static batch: prefill a [B, S] batch, then
  greedy-decode all rows in lockstep;
* the serving API — continuous batching over a cache backend object
  with ``kind`` and ``num_slots``: :meth:`new_cache` / :meth:`insert` /
  :meth:`decode` / :meth:`verify`.  This slice serves the ``"slot"``
  layout; the paged, hybrid and state layouts and :meth:`extend` raise
  until ROADMAP Queue 1 item 3 ports them.

Caches live on the engine's device and are updated in place; each call
still returns the cache, as the JAX engine does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import ArchConfig
from ..models.model import Model, resolve_device
from ..models.transformer import DEFAULT_FLAGS, RuntimeFlags, check_supported
from ..runtime.steps import (make_decode_step, make_prefill_step,
                             make_serve_decode_step, make_slot_insert,
                             make_verify_step)

_NOT_PORTED = "not yet ported to repro_torch (ROADMAP Queue 1 item 3)"


class LLMEngine:
    def __init__(self, cfg: ArchConfig, params=None, *, max_len: int = 512,
                 seed: int = 0, flags: RuntimeFlags = DEFAULT_FLAGS,
                 device=None):
        """``params``: a flat ``state_dict`` (e.g. ``params_from_jax``);
        ``None`` draws random weights from ``seed``."""
        check_supported(cfg)
        self.cfg = cfg
        self.max_len = max_len
        self.flags = flags
        self.device = resolve_device(device)
        self.mesh = None
        self.model = Model(cfg, device=self.device, seed=seed, params=params)
        self._prefill = make_prefill_step(self.model, max_len, flags)
        self._decode = make_decode_step(self.model, flags)
        self._serve_decode = make_serve_decode_step(self.model, flags)
        self._verify = make_verify_step(self.model, flags)
        self._insert = make_slot_insert()

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=self.device)

    def _active(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.bool,
                               device=self.device)

    # ------------------------------------------------------------------
    # static-batch generation
    # ------------------------------------------------------------------
    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy-decode a batch. tokens: [B, S] int -> [B, max_new]."""
        tokens = self._tokens(tokens)
        S = tokens.shape[1]
        next_tok, cache = self._prefill(tokens)
        out = [next_tok]
        cur = next_tok[:, None]
        for i in range(max_new_tokens - 1):
            cur, cache = self._decode(cur.long(), cache, S + i)
            out.append(cur[:, 0])
            if eos_id is not None and bool((cur == eos_id).all()):
                break
        return torch.stack(out, dim=1).cpu().numpy()

    def __call__(self, payload):
        """Engine interface for InferenceCalculator: payload is a dict
        {'tokens': [B,S] int32, 'max_new_tokens': int}."""
        return self.generate(payload["tokens"],
                             payload.get("max_new_tokens", 16))

    # ------------------------------------------------------------------
    # serving API (continuous batching over a slot cache)
    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray) -> Tuple[np.ndarray, Dict]:
        """Prefill [B, S] prompts of one length; returns (first tokens
        [B], cache rows)."""
        next_tok, cache = self._prefill(self._tokens(tokens))
        return next_tok.cpu().numpy(), cache

    @staticmethod
    def _check_slot(backend) -> None:
        if backend.kind != "slot":
            raise NotImplementedError(
                f"cache layout {backend.kind!r}: {_NOT_PORTED}")

    def check_extend_support(self, backend_kind: str = "slot") -> None:
        """Prefix/chunked-extend prefill is not ported in this slice."""
        raise NotImplementedError(f"extend prefill: {_NOT_PORTED}")

    def check_spec_support(self, backend_kind: str = "slot") -> None:
        """Speculative verify runs through the fused decode op on the slot
        layout for every supported (dense attention) architecture."""
        if backend_kind != "slot":
            raise NotImplementedError(
                f"speculative decode on layout {backend_kind!r}: "
                f"{_NOT_PORTED}")

    def new_cache(self, backend):
        """Zeroed ``num_slots`` x ``max_len`` slot cache on the device."""
        self._check_slot(backend)
        return self.model.new_cache(backend.num_slots, self.max_len)

    @property
    def mesh_desc(self) -> Dict[str, Any]:
        """JSON-able mesh shape for observability tags: one device."""
        return {"devices": 1, "axes": {}}

    def cache_shards(self) -> int:
        return 1

    def insert(self, backend, cache, rows, row: int, dst):
        """Land prefilled cache row ``row`` of ``rows`` in slot ``dst``."""
        self._check_slot(backend)
        return self._insert(cache, rows, int(row), int(dst))

    def decode(self, backend, cache, last_tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """One greedy decode step across all slots: ``last_tokens``,
        ``positions`` and ``active`` are [N].  Returns ([N] next tokens,
        cache); inactive slots yield the pad token."""
        self._check_slot(backend)
        tok, cache = self._serve_decode(
            self._tokens(last_tokens)[:, None], cache,
            self._ints(positions), self._active(active))
        return tok[:, 0].cpu().numpy(), cache

    def verify(self, backend, cache, tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """Speculative verification of a [N, 1+k] window per slot; returns
        ([N, 1+k] greedy argmax at every window position, cache).  The
        caller guarantees ``positions[b] + k < max_len`` for every slot."""
        self._check_slot(backend)
        guess, cache = self._verify(self._tokens(tokens), cache,
                                    self._ints(positions),
                                    self._active(active))
        return guess.cpu().numpy(), cache

    def extend(self, backend, cache, suffix_tokens, prefix_len, ref):
        raise NotImplementedError(f"extend prefill: {_NOT_PORTED}")
