"""Mamba selective-SSM block (Jamba's sequence mixer, arXiv:2403.19887),
the serving half: the JAX package's ``models/mamba``.

Every serving entry point runs one per-token update: the window's input
projection, causal conv and SSM inputs come from one product each, then
the state advances one token at a time (the JAX ``_mamba_seq``), so the
state after position t is bitwise the same whether the tokens came as
one prompt, as chunks, or as t + 1 decode calls: the products run
``blocked`` (``layers.linear``), and the readout over the state
dimension goes one row at a time (``layers.each_row``), so that a row's
bits do not depend on its batch.

``mamba_apply`` is the training form (the JAX ``mamba_apply``): the
sequence in chunks of ``ssm_chunk`` carrying the state, each chunk an
inclusive scan of ``_scan_combine`` in log depth (Hillis-Steele, where
JAX has ``lax.associative_scan``; the two reassociate the products
differently, so they agree to rounding, not bitwise) under one
activation checkpoint a chunk.  Its products are plain: the serving
rule of blocked rows has no place under autograd.  On a training mesh
it runs the serving cut under autograd (``line``, the model line): each
rank its channels of ``d_inner`` (its ``in_proj`` and ``dt_proj``
columns, its conv, ``dt_bias``, ``A_log`` and ``D`` channels, its slice
of the scan), the products that contract the cut channels (``x_proj``'s
and ``out_proj``'s) summed over the line.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ref import upcast
from .config import ArchConfig
from .layers import each_row, linear, remat, scan, softplus
from .params import DTYPES, ParamSpec, Template
from ..sharding.group import (cut, line_enter, line_reduce, line_sum,
                              tp_reduce_parts)

State = Dict[str, torch.Tensor]


def mamba_template(cfg: ArchConfig) -> Template:
    d, di = cfg.d_model, cfg.d_inner
    ds, dtr, wc = cfg.ssm_state_dim, cfg.ssm_dt_rank, cfg.ssm_conv_width
    return {
        # fused [x | z]: a tensor-parallel rank holds its channels of both
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner"),
                             parts=(di, di)),
        "conv_w": ParamSpec((wc, di), (None, "ssm_inner_vec"), init="scaled",
                            scale=0.1),
        "conv_b": ParamSpec((di,), ("ssm_inner_vec",), init="zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * ds), ("ssm_inner", None)),
        "dt_proj": ParamSpec((dtr, di), (None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), ("ssm_inner_vec",), init="zeros"),
        "A_log": ParamSpec((di, ds), ("ssm_inner", None), init="alog"),
        "D": ParamSpec((di,), ("ssm_inner_vec",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def mamba_cache(cfg: ArchConfig, batch: int, device) -> State:
    """The zero state (``device="meta"``: its shapes and dtypes): the
    conv tail in the model dtype, ``h`` in f32."""
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di),
                            dtype=DTYPES[cfg.dtype], device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state_dim),
                         dtype=torch.float32, device=device),
    }


def _causal_conv(params, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S after the tail ``prev``.
    x: [B, S, di]."""
    wc = params["conv_w"].shape[0]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    # windowed sum: out[t] = sum_j w[j] * xp[t+j]
    out = sum(xp[:, j:j + x.shape[1], :] * params["conv_w"][j]
              for j in range(wc))
    return out + params["conv_b"]


def _ssm_inputs(params, cfg: ArchConfig, xc: torch.Tensor,
                blocked: bool = True, tp=None, line=None):
    """xc: [B, L, di] (post conv + silu).  Returns (dt [B, L, di] f32,
    B [B, L, ds], C [B, L, ds] f32, A [di, ds] f32): the JAX
    ``_ssm_params`` before the per-token ``a`` and ``b``.  On a
    tensor-parallel rank (``tp``, its group) di is the rank's channels:
    ``x_proj`` contracts them, so its product is summed over the ranks
    (one all-reduce a window) before it is split; on a training rank
    (``line``) under autograd, its gradient summed back."""
    dtr, ds = cfg.ssm_dt_rank, cfg.ssm_state_dim
    # the serving form in f32; the training form in the accumulation
    # dtype (f32, or f64 for an f64 run)
    acc = (lambda t: t.float()) if blocked else upcast
    proj = linear(xc, params["x_proj"], blocked=blocked)
    if tp is not None:
        proj, = tp_reduce_parts([proj], tp)
    proj = line_reduce(proj, line)
    dt_raw, Bmat, Cmat = proj.split([dtr, ds, ds], dim=-1)
    dt = softplus(acc(linear(dt_raw, params["dt_proj"], blocked=blocked))
                  + acc(params["dt_bias"]))
    A = -torch.exp(acc(params["A_log"]))
    return dt, Bmat, acc(Cmat), A


def _mamba_step(state: State, dt_t, B_t, C_t, xc_t, xin_t, A):
    """One token on every row: ``h = a * h + b`` and its readout, with
    ``a``/``b`` of the JAX ``_ssm_params`` at this position (dt, B, C
    and xc in f32).  Returns (y [B, di] f32, new state)."""
    a = torch.exp(dt_t[..., None] * A)                       # [B, di, ds]
    b = dt_t[..., None] * B_t[:, None, :] * xc_t[..., None]
    h = a * state["h"] + b
    y = each_row(lambda hh, cc: (hh * cc[:, None, :]).sum(-1), h, C_t)
    conv0 = state["conv"]
    conv = torch.cat([conv0[:, 1:], xin_t[:, None].to(conv0.dtype)], dim=1)
    return y, {"conv": conv, "h": h}


def _mamba_seq(params, cfg: ArchConfig, x: torch.Tensor, state: State,
               stack: Optional[State] = None,
               tp=None) -> Tuple[torch.Tensor, State]:
    """Advance the state over x [B, L, d] one token at a time (the JAX
    ``_mamba_seq``).  Returns (y [B, L, d], final state).  On a
    tensor-parallel rank the weights, the state and y's ``out_proj``
    product are the rank's channels of ``d_inner`` (the caller sums y
    over the ranks); a d_inner the ranks do not divide is left whole,
    and the window runs whole on every rank."""
    tp = cut(tp, params["in_proj"].shape[-1], 2 * cfg.d_inner)
    xz = linear(x, params["in_proj"], blocked=True)
    x_in, z = xz.split(xz.shape[-1] // 2, dim=-1)
    xc = F.silu(_causal_conv(params, x_in, state["conv"]).float()
                ).to(x.dtype)
    dt, Bm, Cm, A = _ssm_inputs(params, cfg, xc, tp=tp)
    # elementwise, so converted for the whole window with the same bits
    Bf, xcf = Bm.float(), xc.float()

    def step(t: int, state: State):
        y_t, state = _mamba_step(state, dt[:, t], Bf[:, t], Cm[:, t],
                                 xcf[:, t], x_in[:, t], A)
        if stack is not None:
            for k, a in state.items():
                stack[k][:, t].copy_(a)
        return state, y_t

    state, ys = scan(step, state, x.shape[1], "_mamba_seq")
    y = torch.stack(ys, dim=1).to(x.dtype)
    y = y + params["D"].to(x.dtype) * xc
    y = y * F.silu(z.float()).to(x.dtype)
    return linear(y, params["out_proj"], blocked=True), state


def mamba_window(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 stack: Optional[State] = None, tp=None):
    """Multi-token continuation from a live state (chunked-prefill
    ingest windows and speculative verify windows).  x: [B, L, d]."""
    return _mamba_seq(params, cfg, x, cache, stack, tp)


def mamba_prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                             initial_state: Optional[State] = None,
                             tp=None):
    """The prompt's output and its final state for decode."""
    if initial_state is None:
        initial_state = mamba_cache(cfg, x.shape[0], x.device)
    return _mamba_seq(params, cfg, x, initial_state, tp=tp)


def mamba_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 tp=None):
    """One-token step.  x: [B, 1, d]."""
    return _mamba_seq(params, cfg, x, cache, tp=tp)


# ---------------------------------------------------------------------------
# training: the chunked scan
# ---------------------------------------------------------------------------

def _scan_combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of ``_scan_combine`` along dim 1 in log depth
    (Hillis-Steele): position t becomes (prod a[0..t], h_t) with
    ``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0``."""
    k = 1
    while k < a.shape[1]:
        a2, b2 = _scan_combine((a[:, :-k], b[:, :-k]), (a[:, k:], b[:, k:]))
        a = torch.cat([a[:, :k], a2], dim=1)
        b = torch.cat([b[:, :k], b2], dim=1)
        k *= 2
    return a, b


def _chunk_step(params, cfg: ArchConfig, h0: torch.Tensor,
                xc: torch.Tensor, line=None):
    """One chunk xc [B, L, di] from the state h0 [B, di, ds]: (y [B, L,
    di] f32, the state after the chunk)."""
    dt, Bm, Cm, A = _ssm_inputs(params, cfg, xc, blocked=False, line=line)
    a = torch.exp(dt[..., None] * A)                         # [B,L,di,ds]
    b = dt[..., None] * upcast(Bm[:, :, None, :]) * upcast(xc[..., None])
    A_cum, B_cum = associative_scan(a, b)
    h = A_cum * h0[:, None] + B_cum
    y = torch.einsum("blds,bls->bld", h, Cm)
    return y, h[:, -1]


def mamba_apply(params, cfg: ArchConfig, x: torch.Tensor, line=None
                ) -> Tuple[torch.Tensor, None]:
    """Full sequence (training): x [B, S, d] -> ([B, S, d], None), the
    chunked scan with one activation checkpoint a chunk.  ``line``: a
    training rank's model line, over which the rules cut ``d_inner``
    (where they leave it whole, the layer runs whole on every rank): x
    enters the channel-parallel region, and ``out_proj``'s partial
    product is summed over the line."""
    B, S, d = x.shape
    line = cut(line, params["in_proj"].shape[-1], 2 * cfg.d_inner)
    x = line_enter(x, line)
    di = params["in_proj"].shape[-1] // 2
    xz = linear(x, params["in_proj"])
    x_in, z = xz.split(di, dim=-1)
    tail = x_in.new_zeros((B, cfg.ssm_conv_width - 1, di))
    xc = F.silu(upcast(_causal_conv(params, x_in, tail))).to(x.dtype)
    chunk = min(cfg.ssm_chunk, S)
    pad = -S % chunk
    xcp = F.pad(xc, (0, 0, 0, pad)) if pad else xc
    h = torch.zeros((B, di, cfg.ssm_state_dim),
                    dtype=upcast(x[:0]).dtype, device=x.device)
    ys = []
    for c0 in range(0, S + pad, chunk):
        y_c, h = remat(_chunk_step, params, cfg, h, xcp[:, c0:c0 + chunk],
                       line)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S].to(x.dtype)
    y = y + params["D"].to(x.dtype) * xc
    y = y * F.silu(upcast(z)).to(x.dtype)
    return line_sum(linear(y, params["out_proj"]), line), None
