"""LLM inference engine of the port: eager prefill + decode over a KV
cache, on the card.

The same surface as the JAX package's ``serving.LLMEngine``:

* :meth:`generate` — classic static batch: prefill a [B, S] batch, then
  greedy-decode all rows in lockstep;
* the serving API — continuous batching over a
  :class:`~repro_torch.serving.kvcache.CacheBackend`: :meth:`new_cache`
  / :meth:`insert` / :meth:`decode` / :meth:`extend` / :meth:`verify`,
  dispatched on the backend's layout: contiguous slot rows or a paged
  block-pool arena.  Used by :class:`~repro_torch.serving.batching.
  Scheduler`.  The state and hybrid layouts raise until ROADMAP Queue 1
  item 7 ports them.

Caches live on the engine's device and are updated in place; each call
still returns the cache, as the JAX engine does.  On the card the decode
and verify steps (the serving API's and ``generate``'s lockstep decode)
run as captured CUDA graphs, one per key, as the JAX engine jits each
step once per shape (``runtime/graphs.py``; ``RuntimeFlags.cuda_graphs``
turns it off); prefill, extend and insert run eagerly.  ``metrics``
counts decode/verify steps by kernel path with their wall time.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import tracer as trace_mod
from ..core.metrics import MetricsRegistry, NullRegistry
from ..models.config import ArchConfig
from ..models.model import Model, resolve_device
from ..models.params import flatten
from ..models.moe import check_moe_impl
from ..models.transformer import (DEFAULT_FLAGS, RuntimeFlags,
                                  check_supported)
from ..runtime.graphs import StepGraphs, cache_key
from ..runtime.steps import (kernel_path, make_decode_step, make_extend_step,
                             make_paged_insert, make_prefill_step,
                             make_serve_decode_step, make_slot_insert,
                             make_verify_step)

#: the layouts this slice serves
LAYOUTS = ("slot", "paged")


class LLMEngine:
    def __init__(self, cfg: ArchConfig, params=None, *, max_len: int = 512,
                 seed: int = 0, flags: RuntimeFlags = DEFAULT_FLAGS,
                 device=None):
        """``params``: a flat ``state_dict`` (e.g. ``params_from_jax``);
        ``None`` draws random weights from ``seed``."""
        check_supported(cfg)
        check_moe_impl(flags)
        self.cfg = cfg
        self.max_len = max_len
        self.flags = flags
        self.device = resolve_device(device)
        self.mesh = None
        self.model = Model(cfg, device=self.device, seed=seed, params=params)
        self.metrics: MetricsRegistry = \
            NullRegistry() if trace_mod.COMPILED_OUT else MetricsRegistry()
        self._prefill = make_prefill_step(self.model, max_len, flags)
        self._decode = make_decode_step(self.model, flags)
        self._serve_decode = make_serve_decode_step(self.model, flags)
        self._verify = make_verify_step(self.model, flags)
        self._slot_insert = make_slot_insert()
        # per-(step, layout) kernel-path metric handles
        self._kernel_obs: Dict[Tuple, Tuple] = {}
        #: the captured decode/verify steps (None: the steps run eagerly,
        #: on the CPU or with ``flags.cuda_graphs`` off)
        self.graphs: Optional[StepGraphs] = \
            StepGraphs(self.device) \
            if self.device.type == "cuda" and flags.cuda_graphs else None
        # generate's lockstep cache, one per batch width: the captured
        # lockstep decode writes the cache it was captured on
        self._lockstep: Dict[int, Dict] = {}

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=self.device)

    @staticmethod
    def _host(a, dtype) -> torch.Tensor:
        """A host array as a CPU tensor of ``dtype`` (a numpy dtype)."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    def _step(self, key: Tuple, step, cache, args) -> torch.Tensor:
        """``step(args[0], cache, *args[1:])``'s tokens: through the
        captured graph of ``key`` and the cache's addresses where the
        engine captures, else eagerly.  ``args`` are tensors on any
        device; the cache is written in place."""
        if self.graphs is None:
            tokens, *rest = (a.to(self.device) for a in args)
            return step(tokens, cache, *rest)[0]
        return self.graphs.run(
            key + (cache_key(cache),),
            lambda tokens, *rest: step(tokens, cache, *rest)[0], args)

    def _serve_step(self, name: str, step, backend, cache, tokens,
                    positions, active, block_tables) -> torch.Tensor:
        """A serving decode or verify step over all ``N`` slots, keyed
        like the JAX engine's jit cache: (step, layout, block size, N,
        table width P, window width W)."""
        args = [self._host(tokens, np.int64), self._host(positions, np.int32),
                self._host(active, np.bool_)]
        if backend.kind == "paged":
            args.append(self._host(block_tables, np.int32))
        N, W = args[0].shape
        P = args[3].shape[1] if len(args) > 3 else 0
        key = (name, backend.kind, getattr(backend, "block_size", 0), N, P,
               W)
        return self._step(key, step, cache, args)

    def _lockstep_cache(self, B: int, rows):
        """The lockstep cache of batch width ``B``, holding ``rows`` (a
        fresh prefill's cache): the first such cache is kept, later ones
        are copied into it."""
        cache = self._lockstep.setdefault(B, rows)
        if cache is not rows:
            src = flatten(rows)
            for path, leaf in flatten(cache).items():
                leaf.copy_(src[path])
        return cache

    @staticmethod
    def _layout(backend) -> str:
        return f"{backend.kind}/{getattr(backend, 'block_size', 0)}"

    def _observe_kernel(self, step: str, backend, t0: float) -> None:
        """Record which attention implementation served a decode/verify
        step (the ``fused`` flash-decode op or the ``fallback``) and its
        wall time, which spans the token copy to the host and so the
        device's work.  Handles are resolved once per (step, layout)."""
        if not self.metrics.enabled:
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        key = (step, backend.kind, getattr(backend, "block_size", 0))
        ent = self._kernel_obs.get(key)
        if ent is None:
            labels = {"path": kernel_path(self.cfg, self.flags),
                      "step": step, "layout": self._layout(backend)}
            ent = (self.metrics.counter(
                       "engine.kernel_path",
                       "decode/verify steps by attention implementation "
                       "(fused flash-decode kernel vs fallback)"
                   ).bind(**labels),
                   self.metrics.histogram(
                       "engine.kernel_ms",
                       "wall time per decode/verify step, by kernel "
                       "path").bind(**labels))
            self._kernel_obs[key] = ent
        ctr, hist = ent
        ctr.inc()
        hist.observe(dt_ms)

    # ------------------------------------------------------------------
    # static-batch generation
    # ------------------------------------------------------------------
    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy-decode a batch. tokens: [B, S] int -> [B, max_new]."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        next_tok, cache = self._prefill(tokens)
        if self.graphs is not None:
            cache = self._lockstep_cache(B, cache)
        out = [next_tok]
        cur = next_tok[:, None]
        for i in range(max_new_tokens - 1):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            # a copy: a replay leaves its tokens in the graph's output
            cur = self._step(("generate", "slot", 0, B, 0, 1), self._decode,
                             cache, (cur.long(), pos)).clone()
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
    # serving API (continuous batching over a CacheBackend)
    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray) -> Tuple[np.ndarray, Dict]:
        """Prefill [B, S] prompts of one length; returns (first tokens
        [B], cache rows)."""
        next_tok, cache = self._prefill(self._tokens(tokens))
        return next_tok.cpu().numpy(), cache

    @staticmethod
    def _check_layout(kind: str) -> None:
        if kind not in LAYOUTS:
            raise NotImplementedError(
                f"cache layout {kind!r}: recurrent state slabs are not yet "
                f"ported to repro_torch (ROADMAP Queue 1 item 7)")

    def check_extend_support(self, backend_kind: str = "slot") -> None:
        """Prefix/chunked-extend prefill runs on the slot and paged
        layouts for every architecture the port serves: the suffix
        attends through the flash op at ``q_offset = prefix_len`` (K3),
        chunk-invariant bitwise because its k blocks sit at absolute
        multiples of 128.  (The JAX package's other refusals — sliding
        windows, recurrent layers — are raised at construction by
        ``check_supported``.)"""
        self._check_layout(backend_kind)

    def check_spec_support(self, backend_kind: str = "slot") -> None:
        """Speculative decoding verifies a multi-token window through the
        decode path: in-kernel under ``use_fused_decode`` (K2/K4 mask
        each query at ``idx <= pos + s``), else through the page gather.
        The single-query paged kernel (K5) cannot express a window, so
        ``use_paged_kernel`` without ``use_fused_decode`` is rejected,
        as in JAX."""
        self._check_layout(backend_kind)
        if self.flags.use_paged_kernel and not self.flags.use_fused_decode:
            raise ValueError("speculative decode reads paged K/V through "
                             "the page-gather path; drop use_paged_kernel "
                             "(the single-query paged kernel cannot "
                             "verify a window — use use_fused_decode)")

    def new_cache(self, backend):
        """Zeroed decode cache in the backend's layout: ``num_slots``
        contiguous max_len rows (slot) or a ``num_blocks`` x
        ``block_size`` block-pool arena with trash block 0 (paged)."""
        self._check_layout(backend.kind)
        if backend.kind == "paged":
            if self.max_len % backend.block_size != 0:
                raise ValueError(f"engine max_len {self.max_len} must be a "
                                 f"multiple of block_size "
                                 f"{backend.block_size}")
            return self.model.new_paged_cache(backend.num_blocks,
                                              backend.block_size)
        return self.model.new_cache(backend.num_slots, self.max_len)

    @property
    def mesh_desc(self) -> Dict[str, Any]:
        """JSON-able mesh shape for observability tags: one device."""
        return {"devices": 1, "axes": {}}

    def cache_shards(self) -> int:
        return 1

    def insert(self, backend, cache, rows, row: int, dst):
        """Land prefilled cache row ``row`` of ``rows`` in the cache.
        ``dst`` is the backend's write ref: a slot index (slot layout) or
        a [max_len // block_size] int32 page-id vector (paged layout,
        0 = skip page)."""
        self._check_layout(backend.kind)
        if backend.kind == "paged":
            return make_paged_insert(backend.block_size)(
                cache, rows, int(row), self._ints(dst))
        return self._slot_insert(cache, rows, int(row), int(dst))

    def decode(self, backend, cache, last_tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """One greedy decode step across all slots: ``last_tokens``,
        ``positions`` and ``active`` are [N]; paged backends pass their
        ``block_tables`` ([N, P] int32; inactive rows all zero).  Returns
        ([N] next tokens, cache); inactive slots yield the pad token."""
        self._check_layout(backend.kind)
        t0 = time.perf_counter()
        tok = self._serve_step("decode", self._serve_decode, backend, cache,
                               np.asarray(last_tokens)[:, None], positions,
                               active, block_tables)
        out = tok[:, 0].cpu().numpy()
        self._observe_kernel("decode", backend, t0)
        return out, cache

    def verify(self, backend, cache, tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """Speculative verification of a [N, 1+k] window per slot; returns
        ([N, 1+k] greedy argmax at every window position, cache).  The
        caller guarantees ``positions[b] + k < max_len`` for every slot
        and, on paged backends, has backed every position it intends to
        keep (unbacked pages trash-route their writes)."""
        self._check_layout(backend.kind)
        t0 = time.perf_counter()
        guess = self._serve_step("verify", self._verify, backend, cache,
                                 tokens, positions, active, block_tables)
        out = guess.cpu().numpy()
        self._observe_kernel("verify", backend, t0)
        return out, cache

    def extend(self, backend, cache, suffix_tokens: np.ndarray,
               prefix_len: int, ref) -> Tuple[np.ndarray, Dict]:
        """Chunked/prefix prefill: compute ``suffix_tokens`` (positions
        ``prefix_len`` on) against the request's cached prefix and write
        the new K/V back.  ``ref`` is the backend's write ref — a slot
        index (slot) or a ``(table_row, page_ids)`` pair (paged).
        Returns ([1] next token after the suffix, cache)."""
        kind = backend.kind
        self._check_layout(kind)
        step = make_extend_step(
            self.model, int(prefix_len), self.flags,
            block_size=backend.block_size if kind == "paged" else 0,
            max_cache_len=self.max_len)
        suffix = self._tokens(suffix_tokens)[None]
        if kind == "paged":
            table_row, page_ids = ref
            tok, cache = step(suffix, cache, self._ints(table_row),
                              self._ints(page_ids))
        else:
            tok, cache = step(suffix, cache, self._ints(ref))
        return tok.cpu().numpy(), cache
