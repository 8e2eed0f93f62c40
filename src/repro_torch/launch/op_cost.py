"""An op-level cost counter: the port's counterpart of the JAX package's
``launch/hlo_cost.py``.

JAX compiles a step and ``hlo_cost`` reads the optimized HLO.  The port
has no HLO: its program is the sequence of aten ops a step dispatches.
:class:`OpCounter` is a ``TorchDispatchMode`` that records every op a
step dispatches while it runs on ``meta`` tensors (shapes and dtypes,
no data, no device), so the port's own code is what is counted:

* **FLOPs** of the matmul family only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``dot``, ``mv``, ``addmv``; ``einsum``, ``matmul`` and
  ``linear`` as they decompose into these), 2 x |out| x contraction,
  and ``convolution`` at 2 x |out| x (in channels / groups x kernel):
  ``hlo_cost``'s ``dot`` rule, so the two counts compare.  A kernel
  (``kernels/ops.py`` on a ``meta`` operand) adds its analytic
  operations instead (:func:`record_kernel`), as one fused op.
* **Bytes**: the operands plus the outputs of every op that is not a
  view or a metadata op, each counted once a call: an eager program
  reads each operand from HBM and writes each output there.  Two
  refinements follow what an eager kernel touches: an indexed read
  (``index``, ``index_select``, ``gather``, ``embedding``) reads its
  source at the output's size, and an indexed write in place
  (``index_put_``, ``index_copy_``, ``scatter_``, ...) writes the values'
  size into its destination, not the whole destination.  This is a
  different proxy from ``hlo_cost``'s 2 x the outputs of top-level ops
  (a fusion's internals never touch HBM there; every op's do here).
* **Collectives** by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) and by axis
  line, each call's output bytes (``hlo_cost``'s rule), recorded by the
  recording stand-ins of the rank's group (``sharding/group.py``'s
  :class:`~repro_torch.sharding.group.RecordingCollectives`) through
  :func:`record_collective`.  A collective's operands and outputs also
  count as HBM bytes.
* **Peak memory**: the live bytes of the storages the step's ops
  allocate, highest over the step (each storage freed when the last
  tensor on it dies, read by weakref finalizers); the step's arguments
  are added by the caller (``launch/analysis.py``'s ``memory_stats``).

Python loops (layer groups, the sLSTM's token loop) are counted as they
run: nothing is multiplied by a trip count.  A data-dependent index (a
boolean mask) is read as if every element were selected (``torch.fx``'s
``meta_nonzero_assume_all_nonzero``): the most the step can touch.

All numbers are one rank's: the step the counter watches is rank 0's
program.
"""
from __future__ import annotations

import collections
import math
import time
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ops that move no bytes: views, aliases, metadata and fresh allocations
#: (an ``empty`` is written by whatever op fills it)
_FREE = {aten.view, aten._unsafe_view, aten.expand, aten.permute,
         aten.transpose, aten.t, aten.squeeze, aten.unsqueeze, aten.slice,
         aten.select, aten.as_strided, aten.alias, aten.detach,
         aten.split, aten.split_with_sizes, aten.unbind, aten.unfold,
         aten.diagonal, aten._reshape_alias, aten.view_as_real,
         aten.view_as_complex, aten.lift_fresh, aten.empty,
         aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten._local_scalar_dense, aten.set_}

#: indexed reads: the source is read at the output's size
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}

#: indexed writes in place: the destination is written at the values'
#: size (the first operand is the destination)
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
             aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
             aten.index_add_}


def nbytes(t) -> int:
    """A tensor's bytes (its elements x element size); 0 for anything
    else."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in an op's operands or outputs (nested lists, tuples
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _mm_flops(func, args, out) -> float:
    """2 x |out| x contraction of a matmul-family op; 0 elsewhere."""
    p = func.overloadpacket
    if p in (aten.mm, aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if p in (aten.addmm, aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    if p in (aten.dot, aten.vdot):
        return 2.0 * args[0].numel()
    if p == aten.mv:
        return 2.0 * args[0].numel()
    if p == aten.addmv:
        return 2.0 * args[1].numel()
    if p == aten.convolution:
        w = args[1]
        return 2.0 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))
    if p == aten.convolution_backward:
        # the input's and the weight's gradients: a product each
        grad_out, w = args[0], args[2]
        mask = args[10]
        per = 2.0 * grad_out.numel() * w.shape[1] * math.prod(w.shape[2:])
        return per * sum(bool(m) for m in mask[:2])
    return 0.0


class TraceTimeout(RuntimeError):
    """A counted step passed its counter's ``max_seconds``."""


class OpCounter(TorchDispatchMode):
    """Count a step's ops while it runs on ``meta`` tensors (see the
    module's docstring).  ``with OpCounter() as c: step(...)`` then read
    ``flops``, ``bytes``, ``coll`` (bytes by kind), ``coll_by_line``
    ({(line, kind): bytes}), ``coll_calls``, ``peak_bytes``, ``ops``
    (calls by op name) and ``kernels`` (one record a kernel call).
    ``max_seconds``: the step raises :class:`TraceTimeout` at the first
    op after that many seconds of counting."""

    def __init__(self, max_seconds: Optional[float] = None):
        super().__init__()
        self.max_seconds = max_seconds
        self.t0 = time.perf_counter()
        self.n_ops = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.coll_by_line: Dict[tuple, float] = collections.Counter()
        self.coll_calls = 0
        self.ops: Dict[str, int] = collections.Counter()
        self.kernels: List[dict] = []
        self.live = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._nonzero = None

    # ---- the mode -------------------------------------------------------
    def __enter__(self):
        self.t0 = time.perf_counter()
        _STACK.append(self)
        cfg = _fx_config()
        if cfg is not None:
            self._nonzero = cfg.meta_nonzero_assume_all_nonzero
            cfg.meta_nonzero_assume_all_nonzero = True
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)
            cfg = _fx_config()
            if cfg is not None and self._nonzero is not None:
                cfg.meta_nonzero_assume_all_nonzero = self._nonzero

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        p = func.overloadpacket
        self.ops[p.__name__] += 1
        self.n_ops += 1
        if self.max_seconds is not None and self.n_ops % 4096 == 0:
            spent = time.perf_counter() - self.t0
            if spent > self.max_seconds:
                raise TraceTimeout(
                    f"not run: the trace passed {self.max_seconds:.0f} s "
                    f"({self.n_ops} ops in {spent:.0f} s, "
                    f"{spent / self.n_ops * 1e3:.3f} ms an op)")
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._track(ins, outs)
        if p in _FREE:
            return out
        self.flops += _mm_flops(func, args, out)
        if p in _GATHERS:
            src = args[1] if p == aten.embedding else args[0]
            moved = sum(nbytes(t) for t in ins if t is not src) + \
                2 * sum(nbytes(t) for t in outs)
        elif p in _SCATTERS:
            dst = args[0]
            rest = [t for t in ins if t is not dst]
            moved = 2 * sum(nbytes(t) for t in rest)
        else:
            moved = sum(nbytes(t) for t in ins) + \
                sum(nbytes(t) for t in outs)
        self.bytes += moved
        return out

    # ---- peak memory ----------------------------------------------------
    def _track(self, ins, outs) -> None:
        """Count each output on a storage no input holds as an
        allocation, freed when the last tensor on it dies."""
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in held:
                continue
            size = t.untyped_storage().nbytes()
            if key in self._storages:
                self._storages[key] += 1
            else:
                self._storages[key] = 1
                self.live += size
                self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t, self._free, key, size)
            held.add(key)

    def _free(self, key: int, size: int) -> None:
        n = self._storages.get(key)
        if n is None:
            return
        if n > 1:
            self._storages[key] = n - 1
            return
        del self._storages[key]
        self.live -= size

    # ---- records from the stand-ins and the kernels ---------------------
    def collective(self, kind: str, line: str, out_bytes: int,
                   in_bytes: int) -> None:
        self.coll[kind] += out_bytes
        self.coll_by_line[(line, kind)] += out_bytes
        self.coll_calls += 1
        self.bytes += in_bytes + out_bytes

    def kernel(self, name: str, moved: float, flops: float,
               peak: str) -> None:
        self.kernels.append({"name": name, "bytes": float(moved),
                             "flops": float(flops), "peak": peak})
        self.ops[name] += 1
        self.flops += flops
        self.bytes += moved

    def totals(self) -> Dict[str, float]:
        """``hlo_cost``'s keys: flops, bytes, ``coll`` (every kind) and
        each kind's bytes; plus ``count``, the collective calls."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": sum(self.coll.values()), **self.coll,
                "count": self.coll_calls}


_STACK: List[OpCounter] = []


def _fx_config():
    try:
        import torch.fx.experimental._config as cfg
    except ImportError:                 # pragma: no cover - old torch
        return None
    return cfg if hasattr(cfg, "meta_nonzero_assume_all_nonzero") else None


def active() -> Optional[OpCounter]:
    """The innermost counter now recording, or None."""
    return _STACK[-1] if _STACK else None


def record_collective(kind: str, line: str, out_bytes: int,
                      in_bytes: int) -> None:
    """A stand-in group's collective, on the active counter (if any)."""
    c = active()
    if c is not None:
        c.collective(kind, line, out_bytes, in_bytes)


def record_kernel(name: str, moved: float, flops: float,
                  peak: str = "bf16") -> None:
    """A kernel's call on ``meta`` operands, as one fused op with its
    analytic bytes and operations (``peak``: the rate its operations run
    at, ``"bf16"`` tensor cores or ``"f32"``), on the active counter."""
    c = active()
    if c is not None:
        c.kernel(name, moved, flops, peak)


