"""LLM inference engine of the port: eager prefill + decode over a KV
cache, on the card.

The same surface as the JAX package's ``serving.LLMEngine``:

* :meth:`generate` — classic static batch: prefill a [B, S] batch, then
  greedy-decode all rows in lockstep;
* the serving API — continuous batching over a
  :class:`~repro_torch.serving.kvcache.CacheBackend`: :meth:`new_cache`
  / :meth:`insert` / :meth:`decode` / :meth:`extend` / :meth:`verify`,
  dispatched on the backend's layout: contiguous slot rows, a paged
  block-pool arena, O(1) recurrent state slabs (``state``; attention
  layers of a mixed stack keep slot rows) or paged attention beside
  state slabs (``hybrid``).  The state layouts' speculative verify is
  :meth:`verify_window` with :meth:`state_rewind`.  Used by
  :class:`~repro_torch.serving.batching.Scheduler`.

Caches live on the engine's device and are updated in place; each call
still returns the cache, as the JAX engine does.  On the card the decode
and verify steps (the serving API's, the state layouts' stack-returning
verify, and ``generate``'s lockstep decode) run as captured CUDA graphs,
one per key, as the JAX engine jits each step once per shape
(``runtime/graphs.py``; ``RuntimeFlags.cuda_graphs`` turns it off);
prefill, extend, insert and the rewind run eagerly.  ``metrics``
counts decode/verify steps by kernel path with their wall time, and,
under the JAX engine's names and labels, each jitted step's first call
(``engine.jit_compiles``, ``engine.jit_compile_ms``): on the card the
kernels' build, the eager run and the capture, on the CPU the first run.

Tensor-parallel serving (``LLMEngine(cfg, mesh=make_serving_mesh(tp,
devices=...))``, ``launch/mesh.py``): rank 0 is this engine, and it
starts ``tp - 1`` worker processes (``sharding/group.py``), each an
engine of its own over rank ``r``'s slice of the heads, the FFN width
and the vocabulary.  Every call of the serving surface becomes one
command — the method's name and its host operands, with caches named by
the id rank 0 gave them — broadcast to the workers, which run the same
step on their slices; the steps' collectives are ``all_reduce`` sums
(``models/transformer.py``'s ``tp_reduce``, the vocab-parallel embedding
and logits).  Each rank holds its slice of every cache under that id; a
cache rank 0 drops is dropped by the workers at the next command.
Greedy tokens are computed alike on every rank, and rank 0 returns its
own.  ROADMAP item 11a serves the attention-only decoders so, and item
11b-i the MoE FFN (a rank holds its experts) and the recurrent mixers
(a rank holds its channels of Mamba's d_inner, of mLSTM's dk and of the
sLSTM's gate blocks, and its slice of each state) on every layout,
slot, paged, state and hybrid; the state layouts' verify stacks stay on
each rank under the verify's id for the rewind that names them.  Item
11b-ii serves the rest of what the JAX engine serves on a mesh: a width
the ranks do not divide is held and computed whole on every rank and
not summed (``sharding.group.cut``); K/V whose kv heads the ranks do
not divide lie on head_dim, else on the sequence, and decode through
partial scores summed over the ranks (``attention.tp_decode``); MLA
keeps its heads cut, ``c_kv`` on its lora rank and ``k_rope`` on the
sequence (``mla.tp_decode``); an encoder-decoder's encoder and cross
attention are served by :meth:`generate`.  Serving runs the gather MoE:
``moe_impl="ep"`` is a training mesh's (item 11c-i,
``runtime.steps.make_train_step(mesh=...)``), and flags that name no
mesh are refused as without one.

Sliding-window attention (ROADMAP item 12) is served on the slot and
state layouts, at every tp arm: wrapping slot rows of ``min(max_len,
window)`` positions (``models/attention.py``), decoded by the plain
gather path as in JAX.  What JAX refuses of a window is refused with
JAX's exception and message: the paged and hybrid layouts, prefix and
chunked extend, and speculative verify.  MLA (item 15) is served on
every layout: slot rows of latents on the slot and state layouts, a
paged latent arena on the paged and hybrid ones.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import time
import types
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import tracer as trace_mod
from ..core.metrics import MetricsRegistry, NullRegistry
from ..kernels import build
from ..launch.mesh import mesh_desc
from ..models.attention import cache_len
from ..models.config import ArchConfig
from ..models.model import Model, resolve_device
from ..models.params import flatten, tree_map
from ..models.moe import check_moe_impl
from ..models.transformer import (DEFAULT_FLAGS, RuntimeFlags,
                                  check_mixed_extend_support,
                                  check_paged_support)
from ..runtime.graphs import StepGraphs
from ..sharding import group as tp_group
from ..runtime.steps import (kernel_path, make_decode_step, make_extend_step,
                             make_hybrid_insert, make_paged_insert,
                             make_prefill_step, make_serve_decode_step,
                             make_slot_insert, make_state_extend_step,
                             make_state_rewind, make_state_verify_step,
                             make_verify_step)

#: cache layouts whose recurrent layers live in O(1) state slabs: decode
#: masks state commits per row, and verify writes per-position state
#: stacks for the rewind (docs/STATE_CACHE.md)
STATE_KINDS = ("state", "hybrid")
LAYOUTS = ("slot", "paged") + STATE_KINDS

def cuts_positions(cfg: ArchConfig, tp: int) -> bool:
    """Whether a rank of ``tp`` holds a cut of some cache's positions:
    MLA's ``k_rope``, or attention K/V whose kv heads and head_dim the
    ranks both do not divide (the rules' last arm)."""
    return tp > 1 and "attn" in cfg.layer_kinds() and (
        cfg.use_mla or (cfg.num_kv_heads % tp != 0
                        and cfg.head_dim % tp != 0))


def check_tp_support(cfg: ArchConfig, tp: int, max_len: int = 0) -> None:
    """Raise for what tensor-parallel serving at ``tp`` ranks cannot cut
    as the rules do.  Every width is served: one the ranks divide is
    cut, one they do not is held whole on every rank, as JAX's
    ``resolve_spec`` holds it.  The positions of a cache cut on its
    sequence (:func:`cuts_positions`) are the one length the port
    needs the ranks to divide: a slot row's length here (``max_len``,
    or a sliding window's ``min(max_len, window)``), the block size at
    :meth:`LLMEngine.new_cache`, the encoder's frames at
    :meth:`LLMEngine.generate`."""
    size = cache_len(cfg, max_len)
    if max_len and cuts_positions(cfg, tp) and size % tp:
        rows = f"max_len {max_len}" if size == max_len else \
            f"its window's slot rows of {size}"
        raise ValueError(
            f"{cfg.name} at tp={tp} holds a rank's cut of its caches' "
            f"positions: {rows} must be a multiple of {tp}")


class CacheTree(dict):
    """A cache (or prefilled rows) of rank 0 of a tensor-parallel
    engine: the rank's slices, tagged with the id under which every
    worker holds its own."""
    __slots__ = ("tp_id", "__weakref__")


#: the mirrored methods, and which part of each one's result is a new
#: cache the workers keep under the command's id
_MIRRORED: Dict[str, Optional[str]] = {}
#: the index, in a mirrored method's result tuple, of the new cache
#: (the prefill's rows, the verify window's stacks)
_KEPT = {"rows": 1, "stacks": 2}


def _mirrored(result: Optional[str] = None):
    """Run the method on every rank of a tensor-parallel engine: on rank
    0 it becomes a command to the workers (``_Mirror.call``); elsewhere,
    and without workers, it runs as it is.  ``result``: ``"out"`` when
    the method returns a new cache, ``"rows"`` when its second value is
    one, ``"stacks"`` when its third is (``verify_window``'s stacks,
    which ``state_rewind`` names)."""
    def deco(fn):
        _MIRRORED[fn.__name__] = result

        @functools.wraps(fn)
        def wrapper(self, *args, **kw):
            if self._mirror is None:
                return fn(self, *args, **kw)
            if args and hasattr(args[0], "kind"):
                self._check_layout(args[0].kind)
            return self._mirror.call(fn.__name__, args, kw,
                                     lambda: fn(self, *args, **kw), result)
        return wrapper
    return deco


@dataclasses.dataclass(frozen=True)
class _CacheRef:
    """A cache in a command: the id its slices are held under."""
    id: int


@dataclasses.dataclass(frozen=True)
class _BackendRef:
    """A cache backend in a command: the attributes the engine reads."""
    attrs: Dict[str, Any]


class _Mirror:
    """Rank 0's end of the command protocol: ids for the caches, the
    drops the workers owe, and the failure path (a failed command kills
    the workers and closes the engine)."""

    def __init__(self, workers: tp_group.Workers):
        self.workers = workers
        self.coll = workers.coll
        self.next_id = 0
        self.live: set = set()
        self.drops: List[int] = []
        self.closed: Optional[str] = None
        self.released = False

    def _dropped(self, i: int) -> None:
        self.live.discard(i)
        self.drops.append(i)

    def tag(self, tree, i: int) -> CacheTree:
        out = CacheTree(tree)
        out.tp_id = i
        self.live.add(i)
        weakref.finalize(out, self._dropped, i)
        return out

    def encode(self, a):
        if isinstance(a, CacheTree):
            return _CacheRef(a.tp_id)
        if isinstance(a, dict):
            raise ValueError("a tensor-parallel engine takes only the "
                             "caches it made (new_cache, prefill)")
        if hasattr(a, "kind"):                  # a CacheBackend
            return _BackendRef({k: getattr(a, k) for k in (
                "kind", "num_slots", "num_blocks", "block_size")
                if hasattr(a, k)})
        if isinstance(a, (tuple, list)):
            return type(a)(self.encode(x) for x in a)
        return a

    def call(self, name: str, args, kw, run, result: Optional[str]):
        if self.closed is not None:
            raise RuntimeError(f"this tensor-parallel engine is closed: "
                               f"{self.closed}")
        i, self.next_id = self.next_id, self.next_id + 1
        drops, self.drops = self.drops, []
        cmd = (name, self.encode(tuple(args)),
               {k: self.encode(v) for k, v in kw.items()}, i, drops)
        try:
            self.coll.broadcast(cmd)
            out = run()
            self.coll.barrier()
        except BaseException as e:
            msg = self.workers.failure(f"running {name}") + \
                f"\n--- rank 0 ---\n{e!r}"
            self.closed = msg
            self.workers.kill()
            raise RuntimeError(msg) from e
        if result == "out":
            return self.tag(out, i)
        if result in _KEPT:
            j = _KEPT[result]
            return out[:j] + (self.tag(out[j], i),) + out[j + 1:]
        return out

    def close(self) -> None:
        if self.closed is None:
            self.closed = "closed"
            try:
                self.coll.broadcast(("close", (), {}, -1, []))
            except Exception:           # noqa: BLE001 - the workers die
                pass
        if not self.released:
            self.released = True
            self.workers.close()


def _decode(a, objects: Dict[int, Any]):
    """A worker's operands from rank 0's encoding."""
    if isinstance(a, _CacheRef):
        return objects[a.id]
    if isinstance(a, _BackendRef):
        return types.SimpleNamespace(**a.attrs)
    if isinstance(a, (tuple, list)):
        return type(a)(_decode(x, objects) for x in a)
    if isinstance(a, dict):
        return {k: _decode(v, objects) for k, v in a.items()}
    return a


def _run_worker(coll: tp_group.Collectives, payload: Dict[str, Any]) -> None:
    """A worker rank: its engine, then rank 0's commands until close."""
    mesh = payload["mesh"]
    device = torch.device(mesh.devices[coll.rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    engine = LLMEngine(payload["cfg"], payload["params"],
                       max_len=payload["max_len"], seed=payload["seed"],
                       flags=payload["flags"], mesh=mesh, _collectives=coll)
    payload = None
    objects = engine._objects

    def handle(cmd) -> bool:
        name, args, kw, new_id, drops = cmd
        for i in drops:
            objects.pop(i, None)
        if name == "close":
            return True
        out = getattr(engine, name)(*_decode(args, objects),
                                    **_decode(kw, objects))
        result = _MIRRORED[name]
        if result == "out":
            objects[new_id] = out
        elif result in _KEPT:
            objects[new_id] = out[_KEPT[result]]
        return False

    tp_group.serve_commands(coll, handle)


class LLMEngine:
    def __init__(self, cfg: ArchConfig, params=None, *, max_len: int = 512,
                 seed: int = 0, flags: RuntimeFlags = DEFAULT_FLAGS,
                 device=None, mesh=None, pool=None, _collectives=None):
        """``params``: a flat ``state_dict`` (e.g. ``params_from_jax``);
        ``None`` draws random weights from ``seed``.

        ``mesh`` (``launch/mesh.py``'s ``make_serving_mesh``) serves on
        its ranks, rank ``r`` on ``mesh.devices[r]`` (``device``, if
        given, must be of the same type): at tp > 1 this engine is rank
        0 and starts the workers, each drawing (or, given ``params``,
        cutting) the full tree and keeping its slice.  The collectives
        are gloo, whose steps cannot be captured: on CUDA a mesh of more
        than one rank needs ``RuntimeFlags(cuda_graphs=False)``.
        :meth:`close` (also run at exit) stops the workers; with a
        ``pool`` (``sharding.group.WorkerPool``) this engine takes the
        pool's idle workers for the mesh, where it has some, and
        :meth:`close` hands its workers back to it.
        ``_collectives`` is a worker's own group (``_run_worker``)."""
        check_moe_impl(flags)
        self.cfg = cfg
        self.max_len = max_len
        self.mesh = mesh
        self.tp = mesh.tp if mesh is not None else 1
        rank = _collectives.rank if _collectives is not None else 0
        if mesh is not None:
            types_ = {torch.device(d).type for d in mesh.devices}
            if len(types_) != 1 or (device is not None and torch.device(
                    device).type not in types_):
                raise ValueError(f"mesh devices {mesh.devices} and device "
                                 f"{device!r}: every rank runs on one "
                                 f"device type")
            device = mesh.devices[rank]
            if self.tp > 1:
                check_tp_support(cfg, self.tp, max_len)
                if types_ == {"cuda"} and flags.cuda_graphs:
                    raise ValueError(
                        "a tensor-parallel mesh on CUDA runs its "
                        "collectives through gloo, host code that a CUDA "
                        "graph cannot capture: pass "
                        "RuntimeFlags(cuda_graphs=False)")
        self.device = resolve_device(device)
        self._mirror: Optional[_Mirror] = None
        #: a worker's caches, by the id rank 0 gave them
        self._objects: Dict[int, Any] = {}
        coll = _collectives
        workers = None
        if self.tp > 1 and coll is None:
            # the workers start while this rank draws its own weights
            payload = {
                "cfg": cfg, "max_len": max_len, "seed": seed,
                "flags": flags, "mesh": mesh,
                "params": None if params is None else
                {k: v.detach().cpu() for k, v in params.items()}}
            workers = pool.take(mesh, _run_worker, payload) \
                if pool is not None else \
                tp_group.Workers(mesh, _run_worker, payload)
        try:
            self.model = Model(cfg, device=self.device, seed=seed,
                               params=params, mesh=mesh, rank=rank)
        except BaseException:
            if workers is not None:
                workers.kill()
            raise
        if workers is not None:
            coll = workers.join()
            self._mirror = _Mirror(workers)
            weakref.finalize(self, self._mirror.close)
        #: this rank's group (None without a mesh of more than one rank)
        self.collectives = coll
        if coll is not None:
            flags = dataclasses.replace(flags, decode_shards=self.tp, tp=coll)
        self.flags = flags
        self.metrics: MetricsRegistry = \
            NullRegistry() if trace_mod.COMPILED_OUT else MetricsRegistry()
        self._prefill = make_prefill_step(self.model, max_len, flags)
        self._decode = make_decode_step(self.model, flags)
        self._serve_decode = make_serve_decode_step(self.model, flags)
        self._masked_decode = make_serve_decode_step(self.model, flags,
                                                     masked_state=True)
        self._verify = make_verify_step(self.model, flags)
        self._state_verify = make_state_verify_step(self.model, flags)
        self._state_rewind = make_state_rewind()
        self._slot_insert = make_slot_insert()
        #: the state layouts' verify-window stack buffers, one per
        #: (layout, N), as wide as the widest window yet (``_stack_views``)
        self._stacks: Dict[Tuple, Dict] = {}
        # per-(step, layout) kernel-path metric handles
        self._kernel_obs: Dict[Tuple, Tuple] = {}
        #: the compile labels already recorded (``_first_call``)
        self._called: set = set()
        #: the captured decode/verify steps (None: the steps run eagerly,
        #: on the CPU or with ``flags.cuda_graphs`` off)
        self.graphs: Optional[StepGraphs] = \
            StepGraphs(self.device) \
            if self.device.type == "cuda" and flags.cuda_graphs else None
        # generate's lockstep cache, one per batch width: the captured
        # lockstep decode writes the cache it was captured on
        self._lockstep: Dict[int, Dict] = {}
        if self._mirror is not None:
            self._ready()          # the workers' engines are built

    @_mirrored()
    def _ready(self) -> None:
        """A command that does nothing: its barrier waits for every
        rank."""

    def close(self) -> None:
        """Stop the workers of a tensor-parallel engine (also run when
        the engine is collected and at exit); later calls raise.  A
        no-op without workers."""
        if self._mirror is not None:
            self._mirror.close()

    @_mirrored()
    def rank_launches(self, reset: bool = False) -> List[Dict[str, int]]:
        """Every rank's kernel launch counts (``kernels.build.launches``),
        in rank order; ``reset`` zeroes them on every rank after the
        reading."""
        mine = dict(build.launches)
        if reset:
            for k in build.launches:
                build.launches[k] = 0
        return self._gather(mine)

    def rank_cache_ids(self) -> List[List[int]]:
        """The cache ids each rank holds, in rank order (after rank 0's
        garbage is collected): on a healthy engine every worker holds
        exactly rank 0's live ids."""
        gc.collect()
        return self._rank_cache_ids()

    @_mirrored()
    def _rank_cache_ids(self) -> List[List[int]]:
        mine = sorted(self._mirror.live) if self._mirror is not None \
            else sorted(self._objects)
        return self._gather(mine)

    @_mirrored()
    def rank_cache_shapes(self, cache) -> List[Dict[str, Tuple[int, ...]]]:
        """Every rank's shapes of ``cache``'s leaves (by flat path), in
        rank order."""
        return self._gather({p: tuple(a.shape)
                             for p, a in flatten(cache).items()})

    def _gather(self, obj) -> List[Any]:
        return [obj] if self.collectives is None \
            else self.collectives.all_gather(obj)

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

    def _first_call(self, labels: Tuple[str, str, str], run):
        """``run()``; the first call of a step of ``labels`` (``step``,
        ``layout``, ``width``: the JAX engine's jitted step) is timed to
        a device sync and recorded as the JAX engine's ``_timed`` records
        it: ``engine.jit_compiles`` and ``engine.jit_compile_ms``."""
        if labels in self._called:
            return run()
        self._called.add(labels)
        t0 = time.perf_counter()
        out = run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        step, layout, width = labels
        self.metrics.counter(
            "engine.jit_compiles",
            "jitted serving steps compiled, by cache key").inc(
                step=step, layout=layout, width=width)
        self.metrics.histogram(
            "engine.jit_compile_ms",
            "first-call wall time per jit cache entry "
            "(trace + compile + run)").observe(
                dt_ms, step=step, layout=layout, width=width)
        return out

    @staticmethod
    def _step_labels(key: Tuple) -> Tuple[str, str, str]:
        """The JAX engine's compile labels of a captured step's key:
        generate's lockstep decode is its ``decode`` on the ``batch``
        layout, a serving decode its ``serve_decode``, and a verify is
        labelled by its window's width."""
        name, kind, block_size = key[:3]
        if name == "generate":
            return "decode", "batch", ""
        if name == "decode":
            return "serve_decode", f"{kind}/{block_size}", ""
        return name, f"{kind}/{block_size}", str(key[5])

    def _step(self, key: Tuple, step, cache, args,
              stacks=None) -> torch.Tensor:
        """``step(args[0], cache, *args[1:])``'s tokens: through the
        captured graph of ``key`` and the addresses of the cache (and of
        the verify's ``stacks``, bound to the step) where the engine
        captures, else eagerly.  ``args`` are tensors on any device; the
        cache and the stacks are written in place.  The key's first
        call is recorded (``_first_call``)."""
        if stacks is not None:
            step = functools.partial(step, stacks=stacks)
        if self.graphs is None:
            def run():
                tokens, *rest = (a.to(self.device) for a in args)
                return step(tokens, cache, *rest)[0]
        else:
            def run():
                return self.graphs.run(
                    key, lambda tokens, *rest: step(tokens, cache,
                                                    *rest)[0],
                    args, bound=(cache, stacks or {}))
        return self._first_call(self._step_labels(key), run)

    def _serve_step(self, name: str, step, backend, cache, tokens,
                    positions, active, block_tables,
                    stacks=None) -> torch.Tensor:
        """A serving decode or verify step over all ``N`` slots, keyed
        like the JAX engine's jit cache: (step, layout, block size, N,
        table width P, window width W)."""
        args = [self._host(tokens, np.int64), self._host(positions, np.int32),
                self._host(active, np.bool_)]
        if backend.kind in ("paged", "hybrid"):
            args.append(self._host(block_tables, np.int32))
        N, W = args[0].shape
        P = args[3].shape[1] if len(args) > 3 else 0
        key = (name, backend.kind, getattr(backend, "block_size", 0), N, P,
               W)
        return self._step(key, step, cache, args, stacks)

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
    @_mirrored()
    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 enc_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """Greedy-decode a batch. tokens: [B, S] int -> [B, max_new].
        ``enc_embeds`` [B, T, d] (an encoder-decoder's stub frames, on
        the host) are encoded into the memory the decoder attends over;
        without them the decoder runs without cross attention, as the
        JAX engine serves it."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        next_tok, cache = self._run_prefill(tokens, enc_embeds)
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
    @_mirrored("rows")
    def prefill(self, tokens: np.ndarray,
                enc_embeds: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Dict]:
        """Prefill [B, S] prompts of one length; returns (first tokens
        [B], cache rows); ``enc_embeds`` as :meth:`generate` takes
        them."""
        next_tok, cache = self._run_prefill(self._tokens(tokens),
                                            enc_embeds)
        return next_tok.cpu().numpy(), cache

    @_mirrored()
    def prefill_logits(self, tokens: np.ndarray,
                       enc_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """The last prompt token's logits of a prefill of [B, S] prompts,
        [B, padded vocab] in f32 on the host (pad columns masked);
        ``enc_embeds`` as :meth:`generate` takes them."""
        enc = None if enc_embeds is None else torch.as_tensor(
            np.asarray(enc_embeds), device=self.device)
        logits, _ = self.model.prefill(self._tokens(tokens), self.max_len,
                                       flags=self.flags, enc_embeds=enc)
        return logits.float().cpu().numpy()

    def _run_prefill(self, tokens: torch.Tensor,
                     enc_embeds: Optional[np.ndarray] = None):
        if enc_embeds is None:
            return self._first_call(("prefill", "batch", ""),
                                    lambda: self._prefill(tokens))
        T = np.asarray(enc_embeds).shape[1]
        if cuts_positions(self.cfg, self.tp) and T % self.tp:
            raise ValueError(f"{T} encoder frames: the cross caches cut "
                             f"their positions over tp={self.tp}")
        enc = torch.as_tensor(np.asarray(enc_embeds), device=self.device)
        return self._first_call(
            ("prefill", "batch", "enc"),
            lambda: self._prefill(tokens, enc_embeds=enc))

    def _check_layout(self, kind: str) -> None:
        if kind not in LAYOUTS:
            raise ValueError(f"unknown cache layout {kind!r} (expected one "
                             f"of {LAYOUTS})")

    def _check_mla_layout(self, kind: str) -> None:
        """MLA's latent cache is served on every layout: slot rows on the
        slot and state layouts, a paged latent arena on the paged and
        hybrid ones.  As in JAX, the paged kernel (K5) reads GQA K/V
        only, so ``use_paged_kernel`` is refused with MLA on a paged
        arena."""
        if not self.cfg.use_mla:
            return
        if kind in ("paged", "hybrid") and self.flags.use_paged_kernel:
            raise ValueError("use_paged_kernel covers GQA/MHA/MQA only; "
                             "MLA paged decode uses the latent-gather "
                             "path (drop the flag)")

    def _check_blocks(self, block_size: int) -> None:
        if self.max_len % block_size != 0:
            raise ValueError(f"engine max_len {self.max_len} must be a "
                             f"multiple of block_size {block_size}")

    def check_extend_support(self, backend_kind: str = "slot") -> None:
        """Prefix/chunked-extend prefill.  The suffix attends through the
        flash op at ``q_offset = prefix_len`` (K3), chunk-invariant
        bitwise because its k blocks sit at absolute multiples of 128.
        On the slot and paged layouts it needs a pure-attention stack
        (``check_paged_support``); the state and hybrid layouts instead
        *continue the sequential state scan* of recurrent layers from
        their slab rows (docs/STATE_CACHE.md), and keep the limits of
        every layout (``check_mixed_extend_support``).  Both refuse an
        encoder-decoder and a sliding window over attention layers (its
        wrapping rows hold no stable prefix), as in JAX."""
        self._check_layout(backend_kind)
        self._check_mla_layout(backend_kind)
        if backend_kind in STATE_KINDS:
            check_mixed_extend_support(self.cfg)
        else:
            check_paged_support(self.cfg)

    def check_spec_support(self, backend_kind: str = "slot") -> None:
        """Speculative decoding verifies a multi-token window through the
        decode path: in-kernel under ``use_fused_decode`` (K2/K4 mask
        each query at ``idx <= pos + s``), else through the page gather.
        The slot and paged layouts need a pure-attention stack (their
        recurrent state has no rollback) and refuse an encoder-decoder,
        as in JAX (``check_paged_support``); the state and hybrid layouts
        verify recurrent layers through the window pass with state
        stacks and a rewind.  Neither has a sliding-window mask for a
        verify window: the paged arena refuses the window, the state
        layouts refuse it here, as in JAX.  The single-query paged
        kernel (K5) cannot express a window, so ``use_paged_kernel``
        without ``use_fused_decode`` is rejected, as in JAX."""
        self._check_layout(backend_kind)
        self._check_mla_layout(backend_kind)
        if backend_kind in STATE_KINDS:
            if self.cfg.sliding_window and "attn" in self.cfg.layer_kinds():
                raise ValueError("speculative decode has no "
                                 "sliding-window mask")
        else:
            check_paged_support(self.cfg)
        if self.flags.use_paged_kernel and not self.flags.use_fused_decode:
            raise ValueError("speculative decode reads paged K/V through "
                             "the page-gather path; drop use_paged_kernel "
                             "(the single-query paged kernel cannot "
                             "verify a window — use use_fused_decode)")

    @_mirrored("out")
    def new_cache(self, backend):
        """Zeroed decode cache in the backend's layout: ``num_slots``
        contiguous max_len rows (slot, and state: a recurrent layer's
        slot cache already is its O(1) state slab), a ``num_blocks`` x
        ``block_size`` block-pool arena with trash block 0 (paged), or
        the per-layer mix of both (hybrid)."""
        self._check_layout(backend.kind)
        self._check_mla_layout(backend.kind)
        if backend.kind in ("paged", "hybrid") and cuts_positions(
                self.cfg, self.tp) and backend.block_size % self.tp:
            raise ValueError(
                f"{self.cfg.name} at tp={self.tp} holds a rank's offsets "
                f"of every block: block_size {backend.block_size} must be "
                f"a multiple of {self.tp}")
        if backend.kind == "paged":
            check_paged_support(self.cfg)
            self._check_blocks(backend.block_size)
            return self.model.new_paged_cache(backend.num_blocks,
                                              backend.block_size)
        if backend.kind == "hybrid":
            self._check_blocks(backend.block_size)
            return self.model.new_hybrid_cache(
                backend.num_slots, backend.num_blocks, backend.block_size)
        return self.model.new_cache(backend.num_slots, self.max_len)

    @property
    def mesh_desc(self) -> Dict[str, Any]:
        """JSON-able mesh shape for observability tags (metrics,
        flight-recorder incidents, scheduler debug_state)."""
        return mesh_desc(self.mesh)

    def cache_shards(self) -> int:
        """Factor by which one cache block's per-rank bytes shrink under
        the serving mesh, i.e. how many times more blocks the same
        per-rank memory holds; ``GraphServer`` scales its default paged
        arena by it.  The JAX engine's rule: K/V shard on their kv heads,
        or on head_dim where the kv heads do not divide, and MLA's
        latents on their lora rank: each gives tp where it divides, else
        1 (K/V on the sequence are not counted); a stack with no
        attention layer reports 1, its O(1) state slabs are not the
        capacity bound."""
        cfg = self.cfg
        if self.tp <= 1 or "attn" not in cfg.layer_kinds():
            return 1
        if cfg.use_mla:
            return self.tp if cfg.kv_lora_rank % self.tp == 0 else 1
        if cfg.num_kv_heads % self.tp == 0 or cfg.head_dim % self.tp == 0:
            return self.tp
        return 1

    @_mirrored()
    def insert(self, backend, cache, rows, row: int, dst):
        """Land prefilled cache row ``row`` of ``rows`` in the cache.
        ``dst`` is the backend's write ref: a slot index (slot and state
        layouts), a [max_len // block_size] int32 page-id vector (paged
        layout, 0 = skip page), or a ``(page_ids, slot)`` pair
        (hybrid)."""
        self._check_layout(backend.kind)
        if backend.kind == "hybrid":
            page_ids, slot = dst
            run = functools.partial(
                make_hybrid_insert(self.model, backend.block_size,
                                   self.flags.tp),
                cache, rows, int(row), self._ints(page_ids), int(slot))
        elif backend.kind == "paged":
            run = functools.partial(
                make_paged_insert(backend.block_size, self.flags.tp),
                cache, rows, int(row), self._ints(dst))
        else:
            run = functools.partial(self._slot_insert, cache, rows,
                                    int(row), int(dst))
        return self._first_call(("insert", self._layout(backend), ""), run)

    @_mirrored()
    def decode(self, backend, cache, last_tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """One greedy decode step across all slots: ``last_tokens``,
        ``positions`` and ``active`` are [N]; paged and hybrid backends
        pass their ``block_tables`` ([N, P] int32; inactive rows all
        zero).  On the state layouts only active rows commit recurrent
        state.  Returns ([N] next tokens, cache); inactive slots yield
        the pad token."""
        self._check_layout(backend.kind)
        step = self._masked_decode if backend.kind in STATE_KINDS \
            else self._serve_decode
        t0 = time.perf_counter()
        tok = self._serve_step("decode", step, backend, cache,
                               np.asarray(last_tokens)[:, None], positions,
                               active, block_tables)
        out = tok[:, 0].cpu().numpy()
        self._observe_kernel("decode", backend, t0)
        return out, cache

    @_mirrored()
    def verify(self, backend, cache, tokens: np.ndarray,
               positions: np.ndarray, active: np.ndarray,
               block_tables: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Dict]:
        """Speculative verification of a [N, 1+k] window per slot; returns
        ([N, 1+k] greedy argmax at every window position, cache).  The
        caller guarantees ``positions[b] + k < max_len`` for every slot
        and, on paged backends, has backed every position it intends to
        keep (unbacked pages trash-route their writes).  The state
        layouts verify through :meth:`verify_window`: a window here would
        commit every row's recurrent state over the whole window."""
        self._check_layout(backend.kind)
        if backend.kind in STATE_KINDS:
            raise ValueError(f"layout {backend.kind!r}: verify through "
                             f"verify_window and state_rewind")
        t0 = time.perf_counter()
        guess = self._serve_step("verify", self._verify, backend, cache,
                                 tokens, positions, active, block_tables)
        out = guess.cpu().numpy()
        self._observe_kernel("verify", backend, t0)
        return out, cache

    @_mirrored("stacks")
    def verify_window(self, backend, cache, tokens: np.ndarray,
                      positions: np.ndarray, active: np.ndarray,
                      block_tables: Optional[np.ndarray] = None):
        """:meth:`verify` for the state and hybrid layouts: the same
        window contract, but recurrent state slabs are left
        *uncommitted* and the state after every window position comes
        back as stacks, which the backend's ``truncate`` commits for the
        accepted prefix through :meth:`state_rewind`
        (docs/STATE_CACHE.md).  The stacks are the engine's buffers for
        (layout, N, W), which the next verify of that key overwrites.
        Returns ([N, 1+k] guesses, cache, stacks); on a tensor-parallel
        engine every rank keeps its own stacks under this call's id,
        which :meth:`state_rewind` names."""
        kind = backend.kind
        self._check_layout(kind)
        if kind not in STATE_KINDS:
            raise ValueError(f"verify_window serves the state layouts "
                             f"{STATE_KINDS}, not {kind!r}")
        N, W = np.asarray(tokens).shape
        stacks = self._stack_views(kind, cache, N, W)
        t0 = time.perf_counter()
        guess = self._serve_step("verify_stacks", self._state_verify,
                                 backend, cache, tokens, positions, active,
                                 block_tables, stacks)
        out = guess.cpu().numpy()
        self._observe_kernel("verify", backend, t0)
        return out, cache, stacks

    def _stack_views(self, kind: str, cache, N: int, W: int):
        """Stack buffers for a window of ``W`` over ``N`` slots: views of
        the first ``W`` positions of one buffer per (layout, N), which
        the step writes in place and the backend reads right after,
        before the next verify.  A window wider than the buffer
        replaces it, dropping the captured steps that write the old one,
        so that windows of every width a tick takes share one buffer
        (for full-width xlstm_1_3b at 4 slots each position is 2.8 GB)."""
        buf = self._stacks.get((kind, N))
        if buf is None or _stack_width(buf) < W:
            if buf is not None and self.graphs is not None:
                self.graphs.drop_bound_to(buf)
            self._stacks[kind, N] = buf = None      # freed before the new
            buf = self._stacks[kind, N] = \
                self.model.new_state_stacks(cache, W)
        return tree_map(lambda a: a[:, :, :W] if a.numel() else a, buf)

    @_mirrored()
    def state_rewind(self, cache, stacks, slot: int, idx: int):
        """Commit the state after window position ``idx`` (0-based) of
        row ``slot`` from ``stacks`` (returned by :meth:`verify_window`)
        into the live state slabs, in place; attention leaves are left
        as they are."""
        return self._first_call(
            ("state_rewind", "state", ""),
            lambda: self._state_rewind(cache, stacks, int(slot), int(idx)))

    @_mirrored()
    def extend(self, backend, cache, suffix_tokens: np.ndarray,
               prefix_len: int, ref) -> Tuple[np.ndarray, Dict]:
        """Chunked/prefix prefill: compute ``suffix_tokens`` (positions
        ``prefix_len`` on) against the request's cached prefix and write
        the new K/V (and recurrent state) back.  ``ref`` is the backend's
        write ref — a slot index (slot and state), a ``(table_row,
        page_ids)`` pair (paged), or a ``(table_row, page_ids, slot)``
        triple (hybrid).  Returns ([1] next token after the suffix,
        cache)."""
        kind = backend.kind
        self._check_layout(kind)
        make = make_state_extend_step if kind in STATE_KINDS \
            else make_extend_step
        step = make(self.model, int(prefix_len), self.flags,
                    block_size=backend.block_size
                    if kind in ("paged", "hybrid") else 0,
                    max_cache_len=self.max_len)
        suffix = self._tokens(suffix_tokens)[None]
        if kind == "paged":
            table_row, page_ids = ref
            args = (self._ints(table_row), self._ints(page_ids))
        elif kind == "hybrid":
            table_row, page_ids, slot = ref
            args = (self._ints(table_row), self._ints(page_ids),
                    self._ints(slot))
        else:
            args = (self._ints(ref),)
        tok, cache = self._first_call(
            ("extend", self._layout(backend), str(int(prefix_len))),
            lambda: step(suffix, cache, *args))
        return tok.cpu().numpy(), cache


def _stack_width(stacks) -> float:
    """The positions a stack buffer holds: axis 2 of its state leaves;
    a stack of attention layers alone, all placeholders, holds any
    window."""
    return max((a.shape[2] for a in flatten(stacks).values() if a.numel()),
               default=float("inf"))
