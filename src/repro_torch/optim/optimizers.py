"""Optimizers, the JAX package's ``optim/optimizers.py`` on torch tensors.

* AdamW — f32 m/v state; for <=100B-class models.
* Adafactor — factored second moment (row/col statistics), no first
  moment; the memory-sane choice for the 398B/671B giants: its state is
  ~2/d_model of AdamW's.

The state mirrors the param tree (nested dicts; an Adafactor leaf is a
``(row, col)`` tuple where ``_factored`` admits it).  Each update
computes what the JAX update computes, leaf by leaf, and writes the new
params and state **in place** (the tensors the caller passed), so that
a card holds one copy of the weights: it returns ``(params, OptState)``
with the same tensors and the step advanced.  A leaf of more than
``BLOCK`` elements is updated a block of its leading rows at a time
(AdamW is elementwise; Adafactor's row and column statistics are per
trailing matrix, and its RMS clip sums over the whole leaf first), so
the f32 temporaries of a multi-GB leaf stay small.

On a rank of a training mesh (``runtime/train_mesh.py``) the params,
gradients and state are the rank's slices.  AdamW is elementwise and
runs on them as they are.  Adafactor's state is laid out by the whole
leaf's shape (``adafactor_init(params, shapes=)``), and its update takes
``cuts``: each leaf's whole shape and the lines of ranks that cut each
of its dimensions (:class:`LeafCut`).  A mean then sums the rank's part
over the line that cuts the dimension it reduces, and the update-RMS
clip sums the rank's squares over every line that cuts the leaf, so
that each rank updates its slices as the whole leaf's update would.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.params import flatten

#: the most elements of a leaf whose f32 temporaries one block holds
BLOCK = 1 << 27


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the CPU
    m: Any              # first moment (None for adafactor)
    v: Any              # second moment ((row, col) leaves for adafactor)


def _step(state: OptState) -> Tuple[torch.Tensor, torch.Tensor]:
    step = state.step + 1
    return step, step.to(torch.float32)


def _blocks(n: int, per: int):
    """Slices of ``n`` leading rows of ``per`` elements each, at most
    ``BLOCK`` elements a slice (one row at least)."""
    k = max(1, BLOCK // max(per, 1))
    return [slice(i, min(i + k, n)) for i in range(0, n, k)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> OptState:
    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device)
                for k, v in tree.items()}
    return OptState(torch.zeros((), dtype=torch.int32), zeros(params),
                    zeros(params))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    step, t = _step(state)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    fg, fm, fv = flatten(grads), flatten(state.m), flatten(state.v)
    for path, p in flatten(params).items():
        g, m, v = fg[path], fm[path], fv[path]
        pr, gr, mr, vr = (a.view(-1) for a in (p, g, m, v))
        for s in _blocks(pr.numel(), 1):
            gf = gr[s].float()
            m2 = b1 * mr[s] + (1 - b1) * gf
            v2 = b2 * vr[s] + (1 - b2) * gf * gf
            mhat = m2 / c1
            vhat = v2 / c2
            pf = pr[s].float()
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
            pr[s] = (pf - lr * delta).to(p.dtype)
            mr[s], vr[s] = m2, v2
    return params, OptState(step, state.m, state.v)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moment
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


class LeafCut(NamedTuple):
    """A leaf on a rank of a training mesh: its whole shape, and for each
    of its dimensions the lines of ranks (``sharding.group.Line``) that
    cut it, in the order of the spec entry's axes (none: whole)."""
    shape: Tuple[int, ...]
    lines: Tuple[List[Any], ...]


def adafactor_init(params, shapes: Optional[Dict[str, Tuple[int, ...]]]
                   = None) -> OptState:
    """Adafactor's zero state.  ``shapes``: each leaf's whole shape by
    flat path, where ``params`` are a rank's slices: a leaf is factored
    by its whole shape (a [16, 8] leaf cut to [16, 4] is), and its
    factors are the slices' row and column statistics."""
    def v_init(path, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        whole = p.shape if shapes is None else shapes[path]
        if _factored(whole):
            return (torch.zeros(p.shape[:-1], **f32),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
        return torch.zeros(p.shape, **f32)

    def tree(t, prefix=""):
        return {k: tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                else v_init(f"{prefix}{k}", v) for k, v in t.items()}
    return OptState(torch.zeros((), dtype=torch.int32), None, tree(params))


def _mean(t: torch.Tensor, dim: int, cut: Optional[LeafCut],
          pdim: int) -> torch.Tensor:
    """``t.mean(dim)``, where ``t``'s ``dim`` is the leaf's dimension
    ``pdim``: on a rank that holds a cut of it, the rank's sum summed
    over the lines that cut it (in rank order), over the whole
    length."""
    if cut is None or not cut.lines[pdim]:
        return t.mean(dim)
    s = t.sum(dim)
    for line in cut.lines[pdim]:
        line.all_reduce(s)
    return s / cut.shape[pdim]


def _adafactor_dir(gf, v, beta, eps, cut: Optional[LeafCut] = None):
    """The unclipped update of a block of gradient rows ``gf`` (f32) and
    the new second moment of those rows (``cut``: the leaf's on a
    rank)."""
    g2 = gf * gf + eps
    if isinstance(v, tuple):
        row, col = v
        row2 = beta * row + (1 - beta) * _mean(g2, -1, cut, -1)
        col2 = beta * col + (1 - beta) * _mean(g2, -2, cut, -2)
        del g2
        rms_factor = row2 / torch.clamp(_mean(row2, -1, cut, -2)[..., None],
                                        min=eps)
        # in place: a leaf's f32 temporaries are two copies, not five
        precond = rms_factor[..., None] * col2[..., None, :]
        return precond.clamp_(min=eps).rsqrt_().mul_(gf), (row2, col2)
    v2 = beta * v + (1 - beta) * g2
    return gf * torch.rsqrt(torch.clamp(v2, min=eps)), v2


@torch.no_grad()
def adafactor_update(grads, state: OptState, params, lr,
                     decay=0.8, eps=1e-30, clip=1.0, weight_decay=0.0,
                     cuts: Optional[Dict[str, LeafCut]] = None):
    """The update; ``cuts`` (each leaf's :class:`LeafCut` by flat path):
    on a rank of a training mesh, whose ``params``, ``grads`` and state
    are its slices."""
    step, t = _step(state)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    beta = 1.0 - t ** (-decay)
    fg, fv = flatten(grads), flatten(state.v)
    for path, p in flatten(params).items():
        g, v = fg[path], fv[path]
        fact = isinstance(v, tuple)
        # leading rows: the matrices of a factored leaf, else elements
        if fact:
            shape = (-1,) + tuple(p.shape[-2:])
            pr, gr = p.view(shape), g.view(shape)
            vr = (v[0].view(shape[:2]), v[1].view(-1, shape[2]))
        else:
            pr, gr, vr = p.view(-1), g.view(-1), v.view(-1)
        blocks = _blocks(pr.shape[0], pr[0].numel())

        cut = cuts[path] if cuts is not None else None

        def rows(s):
            vs = (vr[0][s], vr[1][s]) if fact else vr[s]
            return _adafactor_dir(gr[s].float(), vs, beta, eps, cut)

        # update clipping by RMS over the whole leaf
        if len(blocks) == 1:
            upd, v_new = rows(blocks[0])
            ss = torch.sum(upd * upd)
        else:
            ss = sum(torch.sum(u * u) for u, _ in map(rows, blocks))
        numel = p.numel()
        if cut is not None:
            for line in [ln for lines in cut.lines for ln in lines]:
                line.all_reduce(ss)
            numel = math.prod(cut.shape)
        rms = torch.sqrt(ss / numel + 1e-30)
        scale = torch.clamp(rms / clip, min=1.0)
        for s in blocks:
            if len(blocks) > 1:
                upd, v_new = rows(s)
            upd.div_(scale)
            pf = pr[s].float()
            if weight_decay:
                upd = upd + weight_decay * pf
            pr[s].copy_(pf.sub_(upd.mul_(lr)))
            if fact:
                vr[0][s], vr[1][s] = v_new
            else:
                vr[s] = v_new
    return params, OptState(step, None, state.v)


# ---------------------------------------------------------------------------

def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    if name == "adafactor":
        return adafactor_init, adafactor_update
    return adamw_init, adamw_update
