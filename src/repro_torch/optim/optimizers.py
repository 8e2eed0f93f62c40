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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

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


def adafactor_init(params) -> OptState:
    def v_init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return (torch.zeros(p.shape[:-1], **f32),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
        return torch.zeros(p.shape, **f32)

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else v_init(v)
                for k, v in t.items()}
    return OptState(torch.zeros((), dtype=torch.int32), None, tree(params))


def _adafactor_dir(gf, v, beta, eps):
    """The unclipped update of a block of gradient rows ``gf`` (f32) and
    the new second moment of those rows."""
    g2 = gf * gf + eps
    if isinstance(v, tuple):
        row, col = v
        row2 = beta * row + (1 - beta) * g2.mean(-1)
        col2 = beta * col + (1 - beta) * g2.mean(-2)
        rms_factor = row2 / torch.clamp(row2.mean(-1, keepdim=True),
                                        min=eps)
        precond = rms_factor[..., None] * col2[..., None, :]
        return gf * torch.rsqrt(torch.clamp(precond, min=eps)), (row2, col2)
    v2 = beta * v + (1 - beta) * g2
    return gf * torch.rsqrt(torch.clamp(v2, min=eps)), v2


@torch.no_grad()
def adafactor_update(grads, state: OptState, params, lr,
                     decay=0.8, eps=1e-30, clip=1.0, weight_decay=0.0):
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

        def rows(s):
            vs = (vr[0][s], vr[1][s]) if fact else vr[s]
            return _adafactor_dir(gr[s].float(), vs, beta, eps)

        # update clipping by RMS over the whole leaf
        if len(blocks) == 1:
            upd, v_new = rows(blocks[0])
            ss = torch.sum(upd * upd)
        else:
            ss = sum(torch.sum(u * u) for u, _ in map(rows, blocks))
        rms = torch.sqrt(ss / p.numel() + 1e-30)
        scale = torch.clamp(rms / clip, min=1.0)
        for s in blocks:
            if len(blocks) > 1:
                upd, v_new = rows(s)
            upd = upd / scale
            pf = pr[s].float()
            if weight_decay:
                upd = upd + weight_decay * pf
            pr[s] = (pf - lr * upd).to(p.dtype)
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
