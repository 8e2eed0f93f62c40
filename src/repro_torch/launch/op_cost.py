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

* **Token loops** (the recurrent mixers' per-token scans, routed
  through ``models/layers.py``'s :func:`~repro_torch.models.layers.scan`)
  are priced as ``hlo_cost`` prices a ``while`` body: once, times the
  trip count (:meth:`OpCounter.scan`).  Of a loop of ``n > 3`` steps the
  first and the last run and are counted; step 1 runs once and is
  recorded ``n - 2`` times (everything it records: FLOPs, bytes, ops,
  collectives, kernels), after a check that the carry's shapes and
  dtypes are those step 0 left, so that steps 2 to ``n - 2`` are the
  same ops.  Its backward is scaled alike, and the storages step 1
  leaves alive are counted ``n - 2`` times in the peak.
  ``OpCounter(scale_loops=False)`` runs every step, for the tests that
  hold the two counts equal.  Other Python loops (layer groups, chunks)
  are counted as they run.

A data-dependent index (a boolean mask) is read as if every element
were selected (``torch.fx``'s ``meta_nonzero_assume_all_nonzero``): the
most the step can touch.

All numbers are one rank's: the step the counter watches is rank 0's
program.
"""
from __future__ import annotations

import collections
import contextlib
import math
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

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
    (calls by op name) and ``kernels`` (one record a kernel call site,
    with its ``calls``).  ``max_seconds``: the step raises
    :class:`TraceTimeout` at the first op after that many seconds of
    counting.  ``scale_loops``: price a token loop's step once, times
    its trip count (:meth:`scan`); False runs every step."""

    def __init__(self, max_seconds: Optional[float] = None,
                 scale_loops: bool = True):
        super().__init__()
        self.max_seconds = max_seconds
        self.scale_loops = scale_loops
        #: what each record is multiplied by (:meth:`repeat`), and the
        #: factors entered, innermost last
        self.scale = 1
        self._scales: List[int] = []
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
        #: each live storage's (allocation serial, bytes)
        self._born: Dict[int, tuple] = {}
        self._allocs = 0
        #: bytes counted beside a live storage and freed with it: the
        #: copies a scaled loop step stands for (:meth:`scan`)
        self._phantom: Dict[int, int] = {}
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
            self._pop_to(0)
            cfg = _fx_config()
            if cfg is not None and self._nonzero is not None:
                cfg.meta_nonzero_assume_all_nonzero = self._nonzero

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        p = func.overloadpacket
        k = self.scale
        self.ops[p.__name__] += k
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
        self.flops += k * _mm_flops(func, args, out)
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
        self.bytes += k * moved
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
                self._allocs += 1
                self._born[key] = (self._allocs, size)
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
        del self._born[key]
        self.live -= size + self._phantom.pop(key, 0)

    # ---- records from the stand-ins and the kernels ---------------------
    def collective(self, kind: str, line: str, out_bytes: int,
                   in_bytes: int) -> None:
        k = self.scale
        self.coll[kind] += k * out_bytes
        self.coll_by_line[(line, kind)] += k * out_bytes
        self.coll_calls += k
        self.bytes += k * (in_bytes + out_bytes)

    def kernel(self, name: str, moved: float, flops: float,
               peak: str) -> None:
        k = self.scale
        self.kernels.append({"name": name, "bytes": float(k * moved),
                             "flops": float(k * flops), "peak": peak,
                             "calls": k})
        self.ops[name] += k
        self.flops += k * flops
        self.bytes += k * moved

    # ---- token loops ----------------------------------------------------
    def _push(self, k: int) -> int:
        """Multiply every record by ``k`` until :meth:`_pop_to` the depth
        returned."""
        self._scales.append(k)
        self.scale *= k
        return len(self._scales) - 1

    def _pop_to(self, depth: int) -> None:
        while len(self._scales) > depth:
            self.scale //= self._scales.pop()

    @contextlib.contextmanager
    def repeat(self, k: int):
        """Inside the block everything recorded (FLOPs, bytes, ``ops``,
        collectives, kernels) counts ``k`` times."""
        depth = self._push(k)
        try:
            yield
        finally:
            self._pop_to(depth)

    def _keep_copies(self, keys, copies: int) -> None:
        """Count ``copies`` more of each live storage in ``keys``, freed
        with it."""
        for key in keys:
            extra = copies * self._born[key][1]
            self._phantom[key] = self._phantom.get(key, 0) + extra
            self.live += extra
        self.peak_bytes = max(self.peak_bytes, self.live)

    def scan(self, body: Callable, carry, n: int, name: str):
        """``layers.scan``'s loop priced once and scaled (the module's
        docstring): steps 0 and ``n - 1`` run as they are, step 1 runs
        once under :meth:`repeat` ``(n - 2)``.  Returns the carry after
        step ``n - 1`` and the ``n`` outputs, step 1's standing for
        steps 1 to ``n - 2`` (one tensor ``n - 2`` times in a list, so
        a ``torch.stack`` of it is one op of the whole's bytes; under
        autograd ``n - 2`` aliases, each a distinct input of the stack,
        so that its backward adds no gradients together that the loop's
        does not).  Where autograd records, a pair of identity markers
        around step 1 scales its backward alike: the later marker's
        backward enters ``repeat(n - 2)``, the earlier one's leaves it;
        the engine runs a graph's nodes in descending creation order, so
        the nodes between the two are step 1's.  The peak counts the
        storages step 1 allocates and leaves alive ``n - 2`` times, each
        copy freed with its storage: its outputs, and under autograd
        what its backward keeps."""
        k = n - 2
        carry, out0 = body(0, carry)
        sig = _signature(carry)
        leaves, spec = pytree.tree_flatten(carry)
        grad = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)
        link: dict = {}
        if grad:
            carry = pytree.tree_unflatten(
                list(_Enter.apply(self, link, *leaves)), spec)
        del leaves
        first = self._allocs
        with self.repeat(k):
            carry, out1 = body(1, carry)
        if _signature(carry) != sig:
            raise ValueError(
                f"{name}: the carry after step 1 {_signature(carry)} is not "
                f"the carry after step 0 {sig}, so the loop's steps are not "
                f"one body: it cannot be priced once and scaled")
        leaves, spec = pytree.tree_flatten(carry)
        outs, out_spec = pytree.tree_flatten(out1)
        if grad:
            got = _Exit.apply(self, link, k, len(leaves), *leaves, *outs)
            carry = pytree.tree_unflatten(list(got[:len(leaves)]), spec)
            w = len(outs)
            copies = [pytree.tree_unflatten(
                list(got[len(leaves) + i * w:len(leaves) + (i + 1) * w]),
                out_spec) for i in range(k)]
            del got
        else:
            copies = [out1] * k
        # step 1's storages still alive: those only its carry holds die
        # in step n - 1 unless its backward keeps them
        born = {key for key in self._storages if self._born[key][0] > first}
        held = {t.untyped_storage()._cdata for t in leaves
                if isinstance(t, torch.Tensor)}
        shown = {t.untyped_storage()._cdata for t in outs
                 if isinstance(t, torch.Tensor)}
        now = {key for key in born if key not in held or key in shown}
        self._keep_copies(now, k - 1)
        del leaves, outs, out1
        before_last = self._allocs
        carry, last = body(n - 1, carry)
        later = {key for key in born - now if key in self._storages
                 and self._born[key][0] <= before_last}
        self._keep_copies(later, k - 1)
        return carry, [out0] + copies + [last]

    def totals(self) -> Dict[str, float]:
        """``hlo_cost``'s keys: flops, bytes, ``coll`` (every kind) and
        each kind's bytes; plus ``count``, the collective calls."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": sum(self.coll.values()), **self.coll,
                "count": self.coll_calls}


_STACK: List[OpCounter] = []


def _signature(tree):
    """The shapes and dtypes of the tensors in ``tree``, with its
    structure."""
    leaves, spec = pytree.tree_flatten(tree)
    return str(spec), [(tuple(t.shape), t.dtype) if isinstance(
        t, torch.Tensor) else t for t in leaves]


def _aliases(ts):
    """A new tensor object on each of ``ts``' storages, made unseen by the
    counter (no op of the step's)."""
    with _disable_current_modes():
        return tuple(t.view_as(t) for t in ts)


class _Enter(torch.autograd.Function):
    """The identity before a scaled loop step: its backward, which runs
    after the step's, leaves the step's ``repeat``."""

    @staticmethod
    def forward(ctx, counter, link, *ts):
        ctx.counter, ctx.link = counter, link
        ctx.set_materialize_grads(False)
        return _aliases(ts)

    @staticmethod
    def backward(ctx, *grads):
        if "depth" in ctx.link:
            ctx.counter._pop_to(ctx.link.pop("depth"))
        return (None, None) + grads


class _Exit(torch.autograd.Function):
    """The identity after a scaled loop step: the carry's ``n_carry``
    tensors once, then each output ``k`` times (distinct aliases, one
    per step it stands for); its backward enters ``repeat(k)`` and hands
    the step the gradient of the first alias of each output (the
    others' stand for steps 2 to ``k``)."""

    @staticmethod
    def forward(ctx, counter, link, k, n_carry, *ts):
        ctx.counter, ctx.link, ctx.k, ctx.n_carry = counter, link, k, n_carry
        ctx.set_materialize_grads(False)
        carry, outs = ts[:n_carry], ts[n_carry:]
        return _aliases(carry) + _aliases(
            [t for _ in range(k) for t in outs])

    @staticmethod
    def backward(ctx, *grads):
        ctx.link["depth"] = ctx.counter._push(ctx.k)
        n = len(grads) - ctx.n_carry
        width = n // ctx.k
        return (None, None, None, None) + grads[:ctx.n_carry] + \
            grads[ctx.n_carry:ctx.n_carry + width]


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


