"""The rank group of a tensor-parallel serving mesh: the processes, the
rendezvous, the two gloo groups, ``tp_reduce`` and the worker loop.

JAX drives a mesh from one controller and GSPMD inserts the
collectives; PyTorch has no such partitioner, so the port does its job
explicitly.  Rank 0 is the caller's process.  It starts ``tp - 1``
worker processes (``spawn``, daemonic, one intra-op thread each), rank
``r`` on ``mesh.devices[r]``, which meet it through a ``TCPStore`` on a
port picked at start-up.  Each process then holds two gloo groups built
on that store (not the process-wide default group, so one process may
hold several meshes):

* the **control** group carries rank 0's commands (pickled, broadcast
  from rank 0); a worker waits on it between commands, so its timeout
  is long;
* the **data** group carries every collective of a step — the
  ``all_reduce`` of :func:`tp_reduce` and the barrier that closes each
  command — with the mesh's timeout (60 s by default), so a dead or
  stuck rank fails the call instead of hanging it.

A CUDA tensor is all-reduced through the host (gathered by gloo and
summed on the CPU in rank order), so two or more ranks may share one
card; the collective is host code and cannot be captured in a CUDA
graph.  A worker that raises puts its traceback on an
error queue and exits; its peers' next collective then fails ("connection
closed"), and rank 0 raises with the worker's traceback.  A worker exits
when rank 0 sends ``close``, when rank 0's process dies (a watchdog
thread checks the parent every second) or when its control group fails.

A :class:`WorkerPool` keeps a closed engine's workers, groups included,
for the next engine on the same mesh: that engine sends them its
payload instead of starting processes (a start costs a process its
``import torch`` and its CUDA context, ~7 s on the card).
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing as mp
import os
import pickle
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

#: how long a worker waits for rank 0's next command
IDLE_TIMEOUT = datetime.timedelta(days=7)
HOST = "127.0.0.1"


def _gloo(store, rank: int, size: int, timeout: datetime.timedelta):
    """A gloo process group over the loopback interface, apart from the
    process-wide default group."""
    Options = getattr(dist.ProcessGroupGloo, "_Options", None) \
        or dist.ProcessGroupGloo.Options
    opts = Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=HOST)]
    opts._timeout = timeout
    return dist.ProcessGroupGloo(store, rank, size, opts)


class Collectives:
    """One rank's side of the mesh's groups.  ``reduce_calls`` and
    ``reduce_s`` count :meth:`all_reduce` calls and their host time.
    A training mesh's ranks hold a :class:`TrainGroup` beside it."""

    def __init__(self, mesh, rank: int, store):
        self.mesh, self.rank, self.size = mesh, rank, len(mesh.devices)
        timeout = datetime.timedelta(seconds=mesh.timeout_s)
        self.ctrl = _gloo(dist.PrefixStore("ctrl", store), rank, self.size,
                          IDLE_TIMEOUT)
        self.data = _gloo(dist.PrefixStore("data", store), rank, self.size,
                          timeout)
        self.store = store
        self.reduce_calls = 0
        self.reduce_s = 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in place, in the tensor's
        dtype, the same bits on every rank: the ranks' parts are
        gathered on the host and added in rank order, ``((p0 + p1) + p2)
        + ...``, element by element.  (gloo's own all-reduce splits a
        buffer by its size, so an element's order of addition, and so
        its bits at more than two ranks, would follow the number of rows
        beside it.)"""
        t0 = time.perf_counter()
        host = t.detach().to("cpu")
        parts = [torch.empty_like(host) for _ in range(self.size)]
        self.data.allgather([parts], [host.contiguous()]).wait()
        total = parts[0]
        for part in parts[1:]:
            total += part
        t.copy_(total)
        self.reduce_s += time.perf_counter() - t0
        self.reduce_calls += 1
        return t

    def barrier(self) -> None:
        self.data.allreduce([torch.zeros(1, dtype=torch.int32)]).wait()

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank (pickled over the control
        group)."""
        if self.rank == 0:
            payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                       dtype=torch.uint8)
            n = torch.tensor([payload.numel()], dtype=torch.int64)
        else:
            n = torch.zeros(1, dtype=torch.int64)
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self.ctrl.broadcast([n], opts).wait()
        if self.rank != 0:
            payload = torch.empty(int(n), dtype=torch.uint8)
        self.ctrl.broadcast([payload], opts).wait()
        return obj if self.rank == 0 else pickle.loads(payload.numpy())

    def gather_tensor(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` (one shape and dtype on every rank) on rank 0,
        in rank order, as CPU tensors; None on the others."""
        host = t.detach().to("cpu").contiguous()
        opts = dist.GatherOptions()
        opts.rootRank = 0
        out = [[torch.empty_like(host) for _ in range(self.size)]] \
            if self.rank == 0 else []
        self.data.gather(out, [host], opts).wait()
        return out[0] if self.rank == 0 else None

    def all_gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        mine = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        self.data.allgather([sizes], [torch.tensor([mine.numel()])]).wait()
        width = int(max(int(s) for s in sizes))
        buf = torch.zeros(width, dtype=torch.uint8)
        buf[:mine.numel()] = mine
        out = [torch.empty(width, dtype=torch.uint8)
               for _ in range(self.size)]
        self.data.allgather([out], [buf]).wait()
        return [pickle.loads(o[:int(s)].numpy().tobytes())
                for o, s in zip(out, sizes)]

    def train_group(self, mesh, tag: str) -> "TrainGroup":
        """This rank's side of a training mesh's lines."""
        return TrainGroup(self, mesh, tag)


def tp_reduce(y: torch.Tensor, flags, partial: bool = True) -> torch.Tensor:
    """The partial product ``y`` of a row-parallel weight summed over
    the ranks (the reduction GSPMD inserts after a product that
    contracts a sharded axis); the identity at one shard, and where
    ``partial`` is false: a product over a width ``resolve_spec`` left
    whole is the whole product on every rank, and summing it would
    count it tp times."""
    group = getattr(flags, "tp", None)
    return y if group is None or not partial else group.all_reduce(y)


def cut(group, local: int, whole: int):
    """``group`` where this rank holds a cut ``local`` of a width
    ``whole``; None where the rules left the width whole, which every
    rank then computes whole, as without a mesh."""
    return group if group is not None and local < whole else None


def placed(x: torch.Tensor, dim: int, index: torch.Tensor,
           whole: int) -> torch.Tensor:
    """``x`` written at ``index`` (a [n] long tensor) along ``dim`` of a
    zero tensor ``whole`` long there: summed over the ranks
    (:func:`tp_reduce_parts`), each rank's entries at their places —
    the gather of a cut tensor as an exact sum (one non-zero term an
    element)."""
    shape = list(x.shape)
    shape[dim] = whole
    return x.new_zeros(shape).index_copy_(dim, index, x)


def own_range(n: int, group, device=None) -> torch.Tensor:
    """The indices ``[rank * n, (rank + 1) * n)`` of the rank's contiguous
    slice of ``n`` (a [n] long tensor)."""
    return torch.arange(group.rank * n, (group.rank + 1) * n, device=device)


def tp_reduce_parts(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Several tensors summed over the ranks in one all-reduce: flattened
    into one f32 buffer (f64 where a part is), summed in rank order, and
    each returned in its own shape and dtype (a model-dtype part rounds
    once, after the sum).  A part that only one rank fills (zeros
    elsewhere) comes back with that rank's bits: the gather of a sharded
    tensor rides along."""
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    group.all_reduce(flat)
    out = flat.split([t.numel() for t in tensors])
    return [o.view(t.shape).to(t.dtype) for o, t in zip(out, tensors)]


# A rank's channels of an axis cut as blocks (a fused projection's, or a
# recurrent state's, ``ParamSpec.parts``): its slice of each block.

def rank_block(n: int, group) -> slice:
    """Rank ``group.rank``'s slice of a block of ``n``."""
    k = n // group.size
    return slice(group.rank * k, (group.rank + 1) * k)


def block_rows(w: torch.Tensor, block: int, group) -> torch.Tensor:
    """The rank's rows of a replicated ``w`` [K, N] whose rows are cut as
    blocks of ``block`` (its slice of each block, in order)."""
    N = w.shape[-1]
    return w.view(-1, block, N)[:, rank_block(block, group)].reshape(-1, N)


def gather_blocks(x: torch.Tensor, block: int, group) -> torch.Tensor:
    """``x`` [..., n/tp], the rank's slice of each block of ``block`` of
    a last axis of n, written into a zero [..., n]: summed over the
    ranks, the whole axis (exact: one non-zero term an element)."""
    full = x.new_zeros(x.shape[:-1] + (x.shape[-1] * group.size,))
    full.view(x.shape[:-1] + (-1, block))[..., rank_block(block, group)] = \
        x.view(x.shape[:-1] + (-1, block // group.size))
    return full


# ---------------------------------------------------------------------------
# a training mesh: a group per axis line, collectives with a backward
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each mesh axis (row-major over
    ``mesh.axis_names``, as JAX lays a mesh's devices out)."""
    out = {}
    for name in reversed(tuple(mesh.axis_names)):
        n = mesh.shape[name]
        out[name] = rank % n
        rank //= n
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


class Line:
    """The ranks of a training mesh that differ from this one only on
    ``axes`` (the ``model`` line, the ``data`` line, the batch line over
    ``("pod", "data")``), in rank order, and this rank's gloo group over
    them.  Every sum adds the members' parts in rank order, element by
    element, so a result's bits do not depend on timing or on the tensor
    beside it.  A line of one rank makes no call.  ``calls``, ``bytes``
    (what this rank receives) and ``seconds`` (host time) count its
    traffic."""

    def __init__(self, name: str, members: List[int], rank: int, store,
                 timeout: datetime.timedelta):
        self.name, self.members = name, members
        self.size, self.index = len(members), members.index(rank)
        self.pg = None
        if self.size > 1:
            self.pg = _gloo(dist.PrefixStore(f"line/{name}/{members[0]}",
                                             store),
                            self.index, self.size, timeout)
        self.reset()

    @property
    def rank(self) -> int:
        """This rank's place on the line (what a serving group's ``rank``
        is to the helpers that cut blocks, such as :func:`rank_block`)."""
        return self.index

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def _count(self, t0: float, nbytes: int) -> None:
        self.calls += 1
        self.bytes += int(nbytes)
        self.seconds += time.perf_counter() - t0

    def _parts(self, host: torch.Tensor) -> List[torch.Tensor]:
        parts = [torch.empty_like(host) for _ in range(self.size)]
        self.pg.allgather([parts], [host]).wait()
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the line in rank order, in place."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        parts = self._parts(_host(t))
        total = parts[0]
        for part in parts[1:]:
            total += part
        t.copy_(total)
        self._count(t0, (self.size - 1) * total.numel() * total.element_size())
        return t

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the line, in place."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        parts = self._parts(_host(t))
        t.copy_(torch.stack(parts).amax(0))
        self._count(t0, (self.size - 1) * t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        out = torch.cat(self._parts(_host(t)), dim).to(t.device)
        self._count(t0, (self.size - 1) * t.numel() * t.element_size())
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` (the ``index``-th of ``size``)
        of ``t`` summed over the line in rank order: each member sends
        every other its slice (one all-to-all), and each adds the slices
        it receives in rank order."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        host = _host(t.movedim(dim, 0))
        out = torch.empty_like(host)
        self.pg.alltoall_base(out, host, [], [],
                              dist.AllToAllOptions()).wait()
        parts = out.chunk(self.size)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        self._count(t0, (self.size - 1) * total.numel()
                    * total.element_size())
        return total.to(t.device).movedim(0, dim)


#: each training rank's lines: (name, the axes its members differ on)
LINES = (("model", ("model",)), ("data", ("data",)), ("pod", ("pod",)),
         ("batch", ("pod", "data")))


class TrainGroup:
    """One rank's side of a training mesh (``launch/mesh.py``'s
    :class:`~repro_torch.launch.mesh.TrainingMesh`, over the devices of
    its :class:`Collectives`, which carry rank 0's commands): its
    coordinates and a :class:`Line` per axis line, on the store under
    ``tag`` (a trainer's own, so that a pool's workers build new lines
    for each).  The autograd collectives below take its lines.  The
    train step sets ``specs`` (each param leaf's spec by flat path) and
    ``split`` (whether the rank holds its rows of the batch or all of
    them); ``drops``, a dict, makes the MoE layers record their dropped
    pairs under the running ``layer``'s name."""

    def __init__(self, coll: "Collectives", mesh, tag: str):
        rank = coll.rank
        self.mesh, self.rank, self.coll = mesh, rank, coll
        self.coords = mesh_coords(mesh, rank)
        self.tag = tag
        n = len(mesh.devices)
        every = [mesh_coords(mesh, r) for r in range(n)]
        self.lines: Dict[str, Line] = {}
        for name, axes in LINES:
            members = [r for r in range(n)
                       if all(every[r][a] == self.coords[a]
                              for a in mesh.axis_names if a not in axes)]
            self.lines[name] = self._line(name, members)
        self.specs: Dict[str, Tuple] = {}
        self.split = False
        self.drops: Optional[Dict[str, int]] = None
        self.layer: Optional[str] = None
        #: the step's embedding and head gathered over data, which an MTP
        #: head reuses (``transformer.mesh_mtp_logits``)
        self.vocab: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _line(self, name: str, members: List[int]) -> Line:
        timeout = datetime.timedelta(seconds=self.mesh.timeout_s)
        store = dist.PrefixStore(f"train/{self.tag}", self.coll.store)
        return Line(name, members, self.rank, store, timeout)

    @property
    def model(self) -> Line:
        return self.lines["model"]

    @property
    def data(self) -> Line:
        return self.lines["data"]

    @property
    def pod(self) -> Line:
        return self.lines["pod"]

    @property
    def batch(self) -> Line:
        return self.lines["batch"]

    def traffic(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """Each line's calls, bytes received and host seconds since the
        last reset."""
        out = {name: {"calls": ln.calls, "bytes": ln.bytes,
                      "seconds": ln.seconds}
               for name, ln in self.lines.items() if ln.size > 1}
        if reset:
            for ln in self.lines.values():
                ln.reset()
        return out


class _Sum(torch.autograd.Function):
    """The sum of the line's partials; the identity backward (what
    follows is computed alike on every rank of the line)."""

    @staticmethod
    def forward(ctx, x, line):
        return line.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the line
    (each rank used the input for its own part)."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.line.all_reduce(g.contiguous().clone()), None


class _Gather(torch.autograd.Function):
    """The members' slices concatenated along ``dim``; the backward keeps
    this rank's slice of the gradient, summed over the line first where
    ``summed`` (each rank used the whole for its own part), as it is
    otherwise (what follows is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, line, dim, summed):
        ctx.line, ctx.dim, ctx.summed, ctx.n = line, dim, summed, x.shape[dim]
        return line.all_gather(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        line, dim = ctx.line, ctx.dim
        if ctx.summed:
            g = line.reduce_scatter(g.contiguous(), dim)
        else:
            g = g.narrow(dim, line.index * ctx.n, ctx.n)
        return g, None, None, None


def _one(line: Optional[Line]) -> bool:
    return line is None or line.size == 1


def line_sum(x: torch.Tensor, line: Optional[Line]) -> torch.Tensor:
    """A row-parallel partial summed over ``line``: an all-reduce
    forward, the identity backward."""
    return x if _one(line) else _Sum.apply(x, line)


def line_enter(x: torch.Tensor, line: Optional[Line]) -> torch.Tensor:
    """``x`` at the entry of a column-parallel region: the identity
    forward, an all-reduce of its gradient backward."""
    return x if _one(line) else _Enter.apply(x, line)


def line_gather(x: torch.Tensor, line: Optional[Line], dim: int,
                summed: bool = True,
                parts: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``line``.  Backward: this
    rank's slice of the gradient summed over the line (a reduce-scatter:
    ZeRO's gather of a data-sharded weight, or activations each rank
    then uses for its own part), or with ``summed=False`` its slice
    alone (activations that every rank then uses alike).  ``parts``:
    ``dim`` is a fused axis of these blocks (``ParamSpec.parts``), of
    which ``x`` holds its slice of each; the blocks come back whole, in
    order."""
    if _one(line):
        return x
    out = _Gather.apply(x, line, dim, summed)
    if parts is None:
        return out
    n, k = x.shape[dim], line.size
    at, order = 0, []
    for p in parts:
        # block p's slice of rank r sits at r * n + at in the gathered axis
        order += [r * n + at + i for r in range(k) for i in range(p // k)]
        at += p // k
    return out.index_select(dim, torch.tensor(order, device=x.device))


def line_reduce(x: torch.Tensor, line: Optional[Line]) -> torch.Tensor:
    """A partial summed over ``line`` that each rank then uses for its own
    part: an all-reduce forward and backward (``line_sum`` then
    ``line_enter``)."""
    return line_enter(line_sum(x, line), line)


# ---------------------------------------------------------------------------
# a recording stand-in for a rank's group (the cost analysis)
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RecordingCollectives:
    """A stand-in for one rank's :class:`Collectives` on a mesh whose
    other ranks do not exist: the same methods, no process, no store.
    Each collective returns a result of the right shape (on ``meta``
    tensors, the cost analysis's, an empty one) and records its kind,
    its axis line and its output bytes (JAX's ``hlo_cost`` rule) with
    the active ``launch/op_cost.py`` counter.  A serving rank's sums run
    on the ``model`` line; a training rank's lines are
    :class:`RecordingLine` (:meth:`train_group`).  A sum returns its
    operand as it is: the cost analysis reads shapes, not values."""

    def __init__(self, mesh, rank: int = 0):
        self.mesh, self.rank, self.size = mesh, rank, len(mesh.devices)
        self.reduce_calls = 0
        self.reduce_s = 0.0

    def record(self, kind: str, line: str, out: int, inp: int) -> None:
        from ..launch import op_cost
        op_cost.record_collective(kind, line, int(out), int(inp))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            self.record("all-reduce", "model", _nbytes(t), _nbytes(t))
            self.reduce_calls += 1
        return t

    def barrier(self) -> None:
        pass

    def broadcast(self, obj: Any = None) -> Any:
        return obj

    def gather_tensor(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        return [t] * self.size if self.rank == 0 else None

    def all_gather(self, obj: Any) -> List[Any]:
        return [obj] * self.size

    def train_group(self, mesh, tag: str) -> "RecordingGroup":
        return RecordingGroup(self, mesh, tag)


class RecordingLine(Line):
    """A :class:`Line` whose other members do not exist: each collective
    returns a result of its shape and records itself with the rank's
    :class:`RecordingCollectives`, under the line's name.  The line's own
    ``calls`` and ``bytes`` count as a gloo line's do (what the rank
    would receive)."""

    def __init__(self, name: str, members: List[int], rank: int,
                 recorder: RecordingCollectives):
        self.name, self.members = name, members
        self.size, self.index = len(members), members.index(rank)
        self.pg = None
        self.recorder = recorder
        self.reset()

    def _record(self, kind: str, out: torch.Tensor, inp: torch.Tensor,
                received: int) -> None:
        self.recorder.record(kind, self.name, _nbytes(out), _nbytes(inp))
        self._count(time.perf_counter(), received)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            self._record("all-reduce", t, t, (self.size - 1) * _nbytes(t))
        return t

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.size == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= self.size
        out = t.new_empty(shape)
        self._record("all-gather", out, t, (self.size - 1) * _nbytes(t))
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.size == 1:
            return t
        shape = list(t.shape)
        shape[dim] //= self.size
        out = t.new_empty(shape)
        self._record("reduce-scatter", out, t,
                     (self.size - 1) * _nbytes(out))
        return out


class RecordingGroup(TrainGroup):
    """A :class:`TrainGroup` of :class:`RecordingLine` s: one rank of a
    training mesh whose other ranks do not exist (the cost analysis runs
    rank 0's step on ``meta`` tensors through it)."""

    def _line(self, name: str, members: List[int]) -> Line:
        return RecordingLine(name, members, self.rank, self.coll)


# ---------------------------------------------------------------------------
# rank 0: start the workers
# ---------------------------------------------------------------------------

class Workers:
    """Rank 0's handle on the worker processes."""

    def __init__(self, mesh, target: Callable, payload: Any, pool=None):
        """Start ranks 1 .. tp-1, each running ``target(collectives,
        payload)`` (a module-level function) and then, while rank 0
        sends them one, the next payload's (:meth:`reuse`); :meth:`join`
        joins their groups.  ``pool`` (a :class:`WorkerPool`) takes them
        back at :meth:`close`."""
        timeout = datetime.timedelta(seconds=mesh.timeout_s)
        self.mesh, self.pool, self.coll = mesh, pool, None
        self.store = dist.TCPStore(HOST, 0, len(mesh.devices), True,
                                   timeout=timeout,
                                   wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self.errors = ctx.SimpleQueue()
        self.procs = [ctx.Process(
            target=_worker_main, daemon=True, name=f"tp-rank{r}",
            args=(r, mesh, self.store.port, target, payload, self.errors,
                  os.getpid()))
            for r in range(1, len(mesh.devices))]
        for p in self.procs:
            p.start()

    def reuse(self, target: Callable, payload: Any) -> None:
        """Send the idle workers the next engine's (or trainer's) target
        and payload (they run ``target`` on it while rank 0 builds its
        own part)."""
        self.coll.reduce_calls, self.coll.reduce_s = 0, 0.0
        self.coll.broadcast((target, payload))

    def join(self) -> Collectives:
        """Rank 0's side of the groups, once every worker has joined."""
        if self.coll is not None:
            return self.coll
        try:
            self.coll = Collectives(self.mesh, 0, self.store)
        except Exception as e:
            self.kill()
            raise RuntimeError(self.failure("joining the groups")) from e
        return self.coll

    def failure(self, what: str) -> str:
        """A message naming the workers' tracebacks (waiting up to 2 s
        for a dying worker to post its own)."""
        msgs: List[Tuple[int, str]] = []
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            while not self.errors.empty():
                msgs.append(self.errors.get())
            if msgs or all(not p.is_alive() for p in self.procs):
                break
            time.sleep(0.05)
        dead = [p.name for p in self.procs if not p.is_alive()]
        text = f"tensor-parallel rank group failed while {what}"
        if dead:
            text += f" ({', '.join(dead)} exited)"
        for rank, tb in msgs:
            text += f"\n--- rank {rank} ---\n{tb}"
        return text

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=5)

    def close(self, timeout: float = 10.0) -> None:
        """Join the workers (rank 0 has sent them ``close``), killing
        any that do not exit within ``timeout``; or, with a pool and
        every worker alive, hand them back to it idle."""
        alive = all(p.is_alive() for p in self.procs)
        if self.pool is not None and alive and self.coll is not None:
            self.pool.give(self)
            return
        if alive and self.coll is not None:
            try:
                self.coll.broadcast(None)       # no next payload: exit
            except Exception:               # noqa: BLE001 - they die
                pass
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()


class WorkerPool:
    """Idle workers kept across engines, by mesh (its devices and
    timeout): ``LLMEngine(cfg, mesh=mesh, pool=pool)`` takes a closed
    engine's workers from the pool where it holds some for the mesh,
    and its :meth:`~repro_torch.serving.LLMEngine.close` hands them
    back.  A worker holds no engine while idle (it has freed the last
    one's memory).  :meth:`close` (also at exit) stops them."""

    def __init__(self):
        self._idle: Dict[Tuple, List[Workers]] = {}
        weakref.finalize(self, WorkerPool._stop, self._idle)

    @staticmethod
    def key(mesh) -> Tuple:
        return (tuple(mesh.devices), mesh.timeout_s)

    def take(self, mesh, target: Callable, payload: Any) -> Workers:
        """Workers for ``mesh`` running ``target(coll, payload)``: idle
        ones of the pool, or new ones."""
        idle = self._idle.get(self.key(mesh), [])
        while idle:
            workers = idle.pop()
            if all(p.is_alive() for p in workers.procs):
                workers.reuse(target, payload)
                return workers
            workers.kill()
        return Workers(mesh, target, payload, pool=self)

    def give(self, workers: Workers) -> None:
        """Keep a closed engine's live workers idle for the next one."""
        self._idle.setdefault(self.key(workers.mesh), []).append(workers)

    def close(self) -> None:
        WorkerPool._stop(self._idle)

    @staticmethod
    def _stop(idle) -> None:
        for group in idle.values():
            for workers in group:
                workers.pool = None
                workers.close()
        idle.clear()


# ---------------------------------------------------------------------------
# a worker process
# ---------------------------------------------------------------------------

def _watch_parent(parent: int) -> None:
    """Exit when rank 0's process is gone (the worker is re-parented)."""
    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(0)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def _worker_main(rank: int, mesh, port: int, target: Callable, payload: Any,
                 errors, parent: int) -> None:
    torch.set_num_threads(1)
    _watch_parent(parent)
    try:
        timeout = datetime.timedelta(seconds=mesh.timeout_s)
        store = dist.TCPStore(HOST, port, len(mesh.devices), False,
                              timeout=timeout)
        coll = Collectives(mesh, rank, store)
        while payload is not None:
            target(coll, payload)
            payload = None
            gc.collect()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.empty_cache()
            # the next engine's target and payload from rank 0, or None:
            # exit
            nxt = coll.broadcast()
            if nxt is not None:
                target, payload = nxt
    except BaseException:           # noqa: BLE001 - reported, then exit
        errors.put((rank, traceback.format_exc()))
        os._exit(1)
    os._exit(0)


def serve_commands(coll: Collectives,
                   handle: Callable[[Any], Optional[bool]]) -> None:
    """A worker's loop: receive rank 0's commands and ``handle`` each,
    then meet the others at the barrier that ends it.  ``handle``
    returns True for the command that closes the worker."""
    while True:
        cmd = coll.broadcast()
        if handle(cmd):
            return
        coll.barrier()
