"""Training on a mesh: the ranks of ``make_train_step(model, ...,
mesh=)`` (ROADMAP item 11c-i).

JAX trains on a mesh through GSPMD: ``jax.jit`` of the train step with
the state laid out by ``train_state_specs`` and ``shard_map`` islands
for expert parallelism and sequence-parallel attention.  PyTorch has no
partitioner, so the port does that job by hand, as it does for serving.
Rank 0 is the caller's process; it starts the other ranks
(``sharding/group.py``'s ``Workers``, or a ``WorkerPool``'s idle ones)
and mirrors each call to them as a command.  Every rank:

* holds its slices of the ``TrainState`` (``sharding.rules.
  train_state_specs``: ZeRO through ``embed→data``, heads, ``mlp``
  columns, experts and vocabulary on ``model``), drawn from the seed or
  cut from a whole state;
* takes its rows of the batch (``batch_specs``);
* runs ``forward`` with ``flags.train`` its ``TrainGroup``
  (``transformer.mesh_forward``: each layer's weights gathered over data
  as it runs, the model axis through collectives with a backward);
* computes the CE on its vocabulary columns (the max, the sum of
  exponentials and the gold logit reduced over the model line:
  :func:`mesh_nll`), the NLL summed over its rows and the mask count
  summed over the batch line, so that the loss is the global batch's;
* after the backward, sums the gradients of leaves the rules keep whole
  on the batch axes over the batch line, and of data-cut leaves over the
  pod line (one flat buffer each), so that each rank holds the whole
  gradient of its slices;
* reads the grad norm by summing each leaf's squares over the ranks
  that hold distinct slices of it (a leaf replicated on an axis counts
  once), and updates its slices in place: by AdamW with no collective,
  or by Adafactor, whose state is laid out by each leaf's whole shape
  and whose row and column means and update-RMS clip sum the rank's
  parts over the lines that cut the leaf (``optim.optimizers.
  LeafCut``).

An architecture with an MTP head (deepseek_v3_671b) adds its loss at
weight 0.3, through the same vocabulary-parallel CE
(``transformer.mesh_mtp_logits``).

Every sum adds the ranks' parts in rank order.  A rank that raises
fails the step: rank 0 then raises with its traceback and stops the
others.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import uuid
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from ..models import transformer as tf
from ..models.moe import check_moe_impl
from ..models.params import DTYPES, _init_leaf, flatten, tree_map, unflatten
from ..optim import make_optimizer
from ..optim.optimizers import LeafCut, OptState, adafactor_init
from ..sharding import group as tp_group
from ..sharding.group import line_sum, tp_reduce_parts
from ..sharding.rules import (Factors, _batch_axes, _entry_slice, _names,
                              batch_specs, local_train_state, owned,
                              param_parts, param_specs, place, shard_tensor,
                              state_leaves)
from .steps import TrainState, _square_sum


def mesh_nll(logits: torch.Tensor, labels: torch.Tensor, padded_vocab: int,
             line) -> torch.Tensor:
    """Each token's NLL [B, S] in f32 from logits [B, S, V'] that are
    this rank's columns of a vocabulary the model ``line`` cuts (V' <
    ``padded_vocab``; whole otherwise): the logsumexp through the max
    over the line (no gradient), the sum of exponentials summed over
    the line, and the gold logit from the rank that holds its column,
    summed over the line.  Three [B, S] f32 reductions a step instead
    of a gather of the [B, S, V] logits."""
    logits = logits.float()
    V = logits.shape[-1]
    if V == padded_vocab:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return lse - gold
    m = line.all_max(logits.detach().amax(dim=-1))
    se = line_sum(torch.exp(logits - m[..., None]).sum(dim=-1), line)
    local = labels.long() - line.index * V
    inside = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    gold = line_sum(torch.where(inside, gold, torch.zeros_like(gold)), line)
    return m + torch.log(se) - gold


def _reduce_parts(tensors: List[torch.Tensor], line) -> None:
    """Sum ``tensors`` over ``line`` in place, in one all-reduce
    (``tp_reduce_parts``: an f32 buffer, each rounded once)."""
    if tensors and line.size > 1:
        for t, total in zip(tensors, tp_reduce_parts(tensors, line)):
            t.copy_(total)


class Rank:
    """One rank of a training mesh: its group, its ``TrainState`` slices
    (``state``; rank 0's caller holds its own) and the step."""

    def __init__(self, coll, payload: Dict[str, Any]):
        self.cfg, self.mesh = payload["cfg"], payload["mesh"]
        self.optimizer = payload["optimizer"]
        self.rank = coll.rank
        self.coll = coll
        self.device = torch.device(self.mesh.devices[self.rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.group = coll.train_group(self.mesh, payload["tag"])
        self.template = tf.model_template(self.cfg)
        self.specs = flatten(param_specs(self.template, self.mesh))
        self.parts = param_parts(self.template)
        self.group.specs = self.specs
        self.group.parts = self.parts
        self.flags = dataclasses.replace(payload["flags"], train=self.group)
        self.opt_init, self.opt_update = make_optimizer(self.optimizer)
        self.whole = flatten(tree_map(lambda s: s.shape, self.template))
        self.cuts = None
        if self.optimizer == "adafactor":
            self.cuts = {k: self._leaf_cut(k) for k in self.specs}
            self.opt_init = functools.partial(adafactor_init,
                                              shapes=self.whole)
        self.state = None
        self.grads_finite = True

    def _leaf_cut(self, path: str) -> LeafCut:
        """The leaf's whole shape and, for each dimension, the lines that
        cut it.  A factored leaf's row and column statistics are those of
        the rank's slice, laid out by the param's spec
        (:meth:`_factor_specs`)."""
        spec = self._padded(path)
        return LeafCut(self.whole[path],
                       tuple([self.group.lines[a] for a in _names(e)
                              if self.group.lines[a].size > 1]
                             for e in spec))

    def _padded(self, path: str) -> tuple:
        spec = tuple(self.specs[path])
        return spec + (None,) * (len(self.whole[path]) - len(spec))

    def _factor_specs(self, path: str) -> Factors:
        """A factored leaf's row and column specs: the param's without
        its last dimension, and without its second to last.  These are
        JAX's ``factor_specs`` for every leaf of the ten architectures
        on every mesh (held by the tests), so that a rank's statistics
        of its own slice are its slices of the factors."""
        spec = self._padded(path)
        return Factors(spec[:-1], spec[:-2] + spec[-1:])

    # ---- the state ------------------------------------------------------
    def _local(self, path: str, t: torch.Tensor) -> torch.Tensor:
        return owned(shard_tensor(t, self.specs[path], self.mesh, self.rank,
                                  self.parts[path]))

    def init(self, params: Optional[Dict[str, torch.Tensor]], seed: int):
        """The rank's TrainState: its slices of ``params`` (a whole flat
        tree), or of the tree drawn from ``seed`` leaf by leaf as
        ``Model(cfg, seed=seed)`` draws it on this device (each leaf cut
        as it is drawn)."""
        dt = DTYPES[self.cfg.dtype]
        if params is None and self.device.type == "meta":
            # the cost analysis's rank: shapes only, nothing drawn
            local = {path: self._local(path, torch.empty(
                spec.shape, dtype=dt, device=self.device))
                for path, spec in flatten(self.template).items()}
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            local = {path: self._local(path, _init_leaf(spec, gen, dt,
                                                        self.device))
                     for path, spec in flatten(self.template).items()}
        else:
            local = {path: self._local(path, params[path].to(self.device))
                     for path in flatten(self.template)}
        params = unflatten(local)
        self.state = TrainState(params, self.opt_init(params))
        return self.state

    def resume(self, state):
        """The rank's slices of a whole ``TrainState`` (such as a loaded
        checkpoint's), on its device."""
        st = local_train_state(state, self.template, self.mesh, self.rank)
        self.state = TrainState(_on(st.params, self.device), OptState(
            st.opt.step, _on(st.opt.m, self.device),
            _on(st.opt.v, self.device)))
        return self.state

    def shapes(self) -> Dict[str, tuple]:
        """The local shape of every leaf of the rank's TrainState, by the
        flat paths of ``rules.local_train_state_shapes``."""
        st = self.state
        out = {"step": tuple(st.opt.step.shape)}
        out.update({f"params.{k}": tuple(v.shape)
                    for k, v in flatten(st.params).items()})
        out.update({k: tuple(v.shape)
                    for k, v in state_leaves(st.opt).items()})
        return out

    # ---- the step -------------------------------------------------------
    def rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's rows of each batch entry (``batch_specs``), on its
        device; sets the group's ``split``."""
        specs = batch_specs({k: tuple(v.shape) for k, v in batch.items()},
                            self.mesh)
        out, split = {}, False
        for k, v in batch.items():
            entry = specs[k][0] if specs[k] else None
            if entry is not None:
                idx, count = _entry_slice(self.mesh, entry, self.rank)
                n = v.shape[0] // count
                v = v[idx * n:(idx + 1) * n]
                split = True
            out[k] = v.to(self.device)
        self.group.split = split
        return out

    def _cut_axes(self, path: str) -> tuple:
        names = {a for e in self.specs[path] for a in _names(e)}
        return tuple(a for a in ("data", "model") if a in names)

    def step(self, state, batch: Dict[str, torch.Tensor], lr):
        """One step of the rank: (state, metrics) with the metrics of the
        global batch (the same on every rank)."""
        cfg, g = self.cfg, self.group
        state = self.state if state is None else state
        rows = self.rows(batch)
        leaves = flatten(state.params)
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            kw = {k: rows[k] for k in ("prefix_embeds", "enc_embeds")
                  if k in rows}
            logits, aux, hidden = tf.forward(state.params, cfg,
                                             rows["tokens"], flags=self.flags,
                                             **kw)
            labels = rows["labels"]
            nll = mesh_nll(logits, labels, cfg.padded_vocab, g.model)
            mask = torch.ones_like(nll)
            if "prefix_embeds" in rows:
                P = rows["prefix_embeds"].shape[1]
                pos = torch.arange(labels.shape[1], device=labels.device)
                mask = (pos >= P).expand(labels.shape).float()
            count = mask.sum().detach().clone()
            if g.split:
                g.batch.all_reduce(count)
            count = torch.clamp(count, min=1.0)
            ce = (nll * mask).sum() / count
            loss = ce + cfg.router_aux_weight * aux
            parts = {"loss": ce}
            if cfg.mtp_depth:
                # MTP: predict token t+2 from hidden_t (+ embed of t+1)
                mtp = tf.mesh_mtp_logits(state.params, cfg, hidden,
                                         rows["tokens"], self.flags)
                mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], 1)
                parts["mtp_loss"] = (mesh_nll(
                    mtp, mtp_labels, cfg.padded_vocab, g.model) * mask
                ).sum() / count
                loss = loss + 0.3 * parts["mtp_loss"]
            # each rank's share of the global loss: its rows' part, or,
            # where every rank holds the whole batch, 1/n of it
            (loss if g.split else loss / g.batch.size).backward()
        g.vocab = None
        grads = {path: p.grad if p.grad is not None else torch.zeros_like(p)
                 for path, p in leaves.items()}
        for p in leaves.values():
            p.grad = None
        with torch.no_grad():
            _reduce_parts([v for k, v in grads.items()
                           if "data" not in self._cut_axes(k)], g.batch)
            _reduce_parts([v for k, v in grads.items()
                           if "data" in self._cut_axes(k)], g.pod)
            gnorm = self._grad_norm(grads)
            finite = torch.stack([torch.isfinite(v).all()
                                  for v in grads.values()]).all()
            # a meta step (the cost analysis) has no values to read
            self.grads_finite = None if finite.is_meta else bool(finite)
            parts = {k: v.detach().clone() for k, v in parts.items()}
            if g.split:
                for v in parts.values():
                    g.batch.all_reduce(v)
            aux = aux.detach()
            kw = {"cuts": self.cuts} if self.cuts is not None else {}
            new_params, new_opt = self.opt_update(unflatten(grads), state.opt,
                                                  state.params, lr, **kw)
        del grads
        self.state = state = type(state)(new_params, new_opt)
        total = parts["loss"] + cfg.router_aux_weight * aux
        if "mtp_loss" in parts:
            total = total + 0.3 * parts["mtp_loss"]
        return state, {**parts, "aux": aux, "total_loss": total, "lr": lr,
                       "grad_norm": gnorm}

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global grad norm: each leaf's squares (f32), summed over
        the leaves cut on the same axes, then over the lines of those
        axes (so a leaf whole on an axis counts once), then over the
        sets, in a fixed order."""
        sets: Dict[tuple, List[torch.Tensor]] = {}
        for k, v in grads.items():
            sets.setdefault(self._cut_axes(k), []).append(_square_sum(v))
        total = torch.zeros((), dtype=torch.float32)
        for axes in sorted(sets):
            t = torch.stack(sets[axes]).sum()
            # the sums are read on the host; a meta step's stay meta
            t = t if t.is_meta else t.cpu()
            for a in axes:
                self.group.lines[a].all_reduce(t)
            total = total + t
        return torch.sqrt(total)

    def update_sums(self, seed: int) -> Dict[str, List[float]]:
        """Each param leaf's change since the draw from ``seed`` (what
        :meth:`init` drew): the sum of its squares and its dot product
        with the draw, in f64, each summed over the ranks that hold
        distinct slices of the leaf (:meth:`_grad_norm`'s rule), by flat
        path; the same on every rank.  A fingerprint of the updated
        params that needs no gather."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dt = DTYPES[self.cfg.dtype]
        params = flatten(self.state.params)
        sets: Dict[tuple, List[tuple]] = {}
        for path, spec in flatten(self.template).items():
            p0 = self._local(path, _init_leaf(spec, gen, dt, self.device)
                             ).double()
            d = params[path].detach().double().sub_(p0)
            sq = torch.linalg.vector_norm(d) ** 2
            sets.setdefault(self._cut_axes(path), []).append(
                (path, torch.stack([sq, d.mul_(p0).sum()])))
            del p0, d
        out = {}
        for axes in sorted(sets):
            t = torch.stack([v for _, v in sets[axes]]).cpu()
            for a in axes:
                self.group.lines[a].all_reduce(t)
            out.update({k: t[i].tolist()
                        for i, (k, _) in enumerate(sets[axes])})
        return out

    # ---- reports --------------------------------------------------------
    def report(self, reset: bool = False) -> List[Dict[str, Any]]:
        """Every rank's coordinates, traffic since the last reset, peak
        memory, whether its last gradients were finite, its MoE drops and
        its state's local shapes (on every rank, in rank order)."""
        mine = {"rank": self.rank, "coords": self.group.coords,
                "traffic": self.group.traffic(reset),
                "max_memory_allocated":
                    torch.cuda.max_memory_allocated(self.device)
                    if self.device.type == "cuda" else None,
                "grads_finite": self.grads_finite,
                "drops": dict(self.group.drops or {}),
                "shapes": self.shapes() if self.state is not None else None}
        if reset and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return self.coll.all_gather(mine)

    def record_drops(self, on: bool) -> None:
        self.group.drops = {} if on else None

    def gather(self, state, params_only: bool = False,
               opt_only: bool = False) -> Optional[Any]:
        """The whole TrainState on rank 0 (CPU tensors; None elsewhere):
        every leaf's slices gathered to rank 0 and placed by its spec (an
        Adafactor factor by :meth:`_factor_specs`); ``params_only``: m and v stay
        None; ``opt_only``: the params stay None."""
        state = self.state if state is None else state
        out = {"params": None, "m": None, "v": None}
        trees = [("params", state.params), ("m", state.opt.m),
                 ("v", state.opt.v)]
        trees = trees[:1] if params_only else trees[1:] if opt_only else \
            trees

        def whole(v, spec, parts=None):
            got = self.coll.gather_tensor(v)
            return None if got is None else place(got, spec, self.mesh,
                                                  parts)
        for name, tree in trees:
            if tree is None:
                continue
            flat = {}
            for k, v in flatten(tree).items():
                if isinstance(v, tuple):
                    # the column factor's last axis is the param's
                    flat[k] = tuple(whole(f, s, p) for f, s, p in zip(
                        v, self._factor_specs(k), (None, self.parts[k])))
                else:
                    flat[k] = whole(v, self.specs[k], self.parts[k])
            out[name] = unflatten(flat)
        if self.rank != 0:
            return None
        return TrainState(out["params"], OptState(
            state.opt.step.detach().cpu().clone(), out["m"], out["v"]))


def _on(tree, device):
    """A state tree (an Adafactor leaf a tuple of factors; None stays
    None) with its tensors on ``device``, detached."""
    if tree is None:
        return None
    return unflatten({k: tuple(f.detach().to(device) for f in v)
                      if isinstance(v, tuple) else v.detach().to(device)
                      for k, v in flatten(tree).items()})


def _run_rank(coll, payload: Dict[str, Any]) -> None:
    """A worker rank: its :class:`Rank`, then rank 0's commands until
    close."""
    rank = Rank(coll, payload)
    payload = None

    def handle(cmd) -> bool:
        name, args = cmd
        if name == "close":
            return True
        getattr(rank, name)(*args)
        return False

    tp_group.serve_commands(coll, handle)


def check_mesh_flags(cfg, flags, mesh, optimizer: str) -> None:
    """Raise where the flags do not name the mesh they run on."""
    check_moe_impl(flags)
    mp = mesh.shape["model"]
    if flags.model_size not in (1, mp):
        raise ValueError(f"flags.model_size={flags.model_size} on a mesh "
                         f"whose model axis is {mp}")
    axes = _batch_axes(mesh)
    div = math.prod(mesh.shape[a] for a in axes)
    if flags.batch_axes and (tuple(flags.batch_axes) != axes
                             or flags.batch_divisor != div):
        raise ValueError(f"flags.batch_axes={flags.batch_axes} and "
                         f"batch_divisor={flags.batch_divisor} on a mesh "
                         f"whose batch axes are {axes} of {div}")
    if flags.train is not None or flags.tp is not None:
        raise ValueError("make_train_step sets the rank group itself: pass "
                         "flags without train or tp")


class MeshTrainer:
    """Rank 0's end of a training mesh: the workers, the commands, and
    rank 0's own :class:`Rank`.  ``make_train_step`` returns its
    :meth:`train_step` and :meth:`init_state`."""

    def __init__(self, cfg, schedule: Callable, flags, optimizer: str,
                 mesh, pool=None):
        self.schedule, self.mesh = schedule, mesh
        check_mesh_flags(cfg, flags, mesh, optimizer)
        payload = {"cfg": cfg, "mesh": mesh, "optimizer": optimizer,
                   "flags": flags, "tag": uuid.uuid4().hex}
        self.closed: Optional[str] = None
        self.workers = pool.take(mesh, _run_rank, payload) \
            if pool is not None else \
            tp_group.Workers(mesh, _run_rank, payload)
        try:
            coll = self.workers.join()
            self.rank = Rank(coll, payload)
        except BaseException:
            self.workers.kill()
            raise
        self._finalizer = weakref.finalize(self, MeshTrainer._stop,
                                           self.workers, coll)

    @staticmethod
    def _stop(workers, coll) -> None:
        try:
            coll.broadcast(("close", ()))
        except Exception:               # noqa: BLE001 - the workers die
            pass
        workers.close()

    def close(self) -> None:
        """Stop the workers (or hand them back to the pool); later calls
        raise.  Also run when the trainer is collected and at exit."""
        if self.closed is None:
            self.closed = "closed"
        self._finalizer()

    def call(self, name: str, *args, local=None):
        """Run ``name`` on every rank: the command to the workers, then
        rank 0's own (``local``: rank 0's arguments where they differ),
        then the barrier."""
        if self.closed is not None:
            raise RuntimeError(f"this training mesh is closed: "
                               f"{self.closed}")
        coll = self.rank.coll
        try:
            coll.broadcast((name, args))
            out = getattr(self.rank, name)(*(local if local is not None
                                             else args))
            coll.barrier()
        except BaseException as e:
            msg = self.workers.failure(f"running {name}") + \
                f"\n--- rank 0 ---\n{e!r}"
            self.closed = msg
            self.workers.kill()
            raise RuntimeError(msg) from e
        return out

    # ---- the API --------------------------------------------------------
    def init_state(self, params=None, *, seed: Optional[int] = None):
        """Rank 0's TrainState: every rank's slices of ``params`` (a whole
        tree, such as ``model.params``, or a whole ``TrainState`` to
        resume from, optimizer moments and step included; the workers
        receive CPU copies), or of the tree drawn from ``seed`` (each rank
        draws it)."""
        if params is None and seed is None:
            raise ValueError("init_state needs params or a seed")
        if params is None:
            return self.call("init", None, seed)
        if isinstance(params, TrainState):
            cpu = TrainState(_on(params.params, "cpu"), OptState(
                params.opt.step.cpu(), _on(params.opt.m, "cpu"),
                _on(params.opt.v, "cpu")))
            return self.call("resume", cpu, local=(params,))
        flat = flatten(params)
        cpu = {k: v.detach().cpu() for k, v in flat.items()}
        return self.call("init", cpu, 0,
                         local=({k: v.detach() for k, v in flat.items()}, 0))

    def train_step(self, state, batch: Dict[str, torch.Tensor]):
        """The step on every rank: ``batch`` whole (each rank takes its
        rows); returns rank 0's state and the global metrics."""
        lr = self.schedule(state.opt.step + 1)
        cpu = {k: v.detach().cpu() for k, v in batch.items()}
        return self.call("step", None, cpu, lr, local=(state, batch, lr))

    def report(self, reset: bool = False) -> List[Dict[str, Any]]:
        return self.call("report", reset)

    def record_drops(self, on: bool = True) -> None:
        self.call("record_drops", on)

    def update_sums(self, seed: int) -> Dict[str, List[float]]:
        """Every param leaf's change since the ranks drew it from
        ``seed`` (:meth:`Rank.update_sums`), summed over the ranks."""
        return self.call("update_sums", seed)

    def gather_state(self, state, params_only: bool = False,
                     opt_only: bool = False):
        """The whole TrainState (CPU tensors), gathered from every rank
        (``params_only``: its m and v None; ``opt_only``: its params
        None)."""
        return self.call("gather", None, params_only, opt_only,
                         local=(state, params_only, opt_only))
