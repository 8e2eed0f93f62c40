"""Mixture-of-Experts FFN with top-k routing, capacity-based token
dropping and a load-balance auxiliary loss (configs: Granite 40e top-8,
Jamba 16e top-2, DeepSeek-V3 1 shared + 256 routed top-8).

The ``gather`` implementation of the JAX package's ``models/moe.py``:
a global sort-based dispatch of each token's k choices into a capacity
buffer of ``C`` rows per expert, the expert FFN as batched products over
all (padded) experts, and a combine back to the tokens.  It computes
exactly what the JAX function computes, drops included: an expert's
rows past ``C = capacity(cfg, N)`` are dropped, so a token's output
depends on the other tokens of its call (ROADMAP Hazard 7).

Nothing on the path waits on the card: ``C`` comes from the static
token count, counts are integer scatter-adds (no ``bincount``), the
dispatch writes overflow to a trash row, and the combine is a gather
and a fixed-order sum, so a MoE layer captures inside the engine's
decode and verify graphs and its sums do not change from run to run.

Expert parallelism (``RuntimeFlags(moe_impl="ep")``, ``shard_map`` over
a mesh in JAX) is not ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import linear, mlp_apply, mlp_template
from .params import ParamSpec, Template
from ..kernels.ref import upcast

EP_REFUSAL = ("expert-parallel MoE (moe_impl='ep'): not yet ported to "
              "repro_torch (ROADMAP Queue 1 item 11)")


def check_moe_impl(flags) -> None:
    """Raise for a MoE implementation the port does not run."""
    impl = getattr(flags, "moe_impl", "gather")
    if impl == "ep":
        raise NotImplementedError(EP_REFUSAL)
    if impl != "gather":
        raise ValueError(f"unknown moe_impl {impl!r}")


def padded_experts(cfg: ArchConfig) -> int:
    m = cfg.expert_pad_multiple
    return -(-cfg.num_experts // m) * m


def moe_template(cfg: ArchConfig) -> Template:
    d, ff = cfg.d_model, cfg.d_ff
    E = padded_experts(cfg)
    t: Template = {
        "router": ParamSpec((d, E), scale=0.02, init="scaled"),
        "w_gate": ParamSpec((E, d, ff)),
        "w_up": ParamSpec((E, d, ff)),
        "w_down": ParamSpec((E, ff, d)),
    }
    if cfg.num_shared_experts:
        t["shared"] = mlp_template(d, cfg.num_shared_experts * ff)
    return t


def capacity(cfg: ArchConfig, num_tokens: int) -> int:
    c = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


@contextlib.contextmanager
def _no_tf32(device: torch.device):
    """f32 products on the card in true f32 for the block, whatever the
    caller set: TF32 is turned off, through the API the caller's
    setting came by (torch refuses a mix of its two), and restored
    after.  Touches nothing when TF32 is already off."""
    m = torch.backends.cuda.matmul
    prec = getattr(m, "fp32_precision", None) if device.type == "cuda" \
        else "ieee"
    if prec is None:                    # a torch without the newer API
        name, prev, off, on = "allow_tf32", True, False, m.allow_tf32
    else:
        name, prev, off = "fp32_precision", prec, "ieee"
        on = prec == "tf32" or (prec == "none" and getattr(
            torch.backends, "fp32_precision", "ieee") == "tf32")
    if on:
        setattr(m, name, off)
    try:
        yield
    finally:
        if on:
            setattr(m, name, prev)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg: ArchConfig, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on [N, d] tokens -> (gates [N, k], expert_idx [N, k] int64,
    aux)."""
    E_real = cfg.num_experts
    with _no_tf32(xf.device):
        logits = linear(upcast(xf), upcast(params["router"]))
    E_pad = logits.shape[-1]
    if E_pad != E_real:  # mask pad experts
        col = torch.arange(E_pad, device=xf.device)
        logits = torch.where(col[None, :] < E_real, logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)                    # [N, E]
    gates, idx = _top_k(probs, cfg.num_experts_per_tok)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss: E * sum_e (fraction routed to e) * (mean prob e)
    N = xf.shape[0]
    top1 = torch.zeros(E_pad, dtype=torch.float32, device=xf.device)
    top1.scatter_add_(0, idx[:, 0], torch.ones(N, device=xf.device))
    frac = top1 / N
    mean_prob = probs.mean(0)
    aux = E_real * torch.sum(frac * mean_prob)
    return gates.to(xf.dtype), idx, aux


def dispatch_plan(il: torch.Tensor, E_l: int, C: int, e_offset: int = 0):
    """Where each of the N x k (token, choice) pairs goes, sorted by
    expert (stable): (order [N*k], dest [N*k], keep [N*k]).  ``dest`` is
    the pair's row of the [E_l * C] capacity buffer, or ``E_l * C`` (the
    trash row) where the pair is dropped or not this shard's."""
    Nk = il.numel()
    flat_e = il.reshape(Nk) - e_offset
    mine = (flat_e >= 0) & (flat_e < E_l)
    eid = torch.where(mine, flat_e, torch.full_like(flat_e, E_l))
    sorted_e, order = torch.sort(eid, stable=True)
    # counts per expert as an integer scatter-add: ``bincount`` would wait
    # on the card for its output size
    counts = torch.zeros(E_l + 1, dtype=torch.int64, device=il.device)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Nk, device=il.device) - starts[sorted_e]
    keep = (sorted_e < E_l) & (pos < C)
    dest = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E_l * C))
    return order, dest, keep


def count_dropped(idx: torch.Tensor, E_pad: int, C: int) -> int:
    """(token, expert) pairs of one call that overflow their expert's C
    rows (a plain reading; it waits on the card)."""
    counts = torch.zeros(E_pad, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return int(torch.clamp(counts - C, min=0).sum())


def _dispatch_ffn_combine(xl, gl, il, wg, wu, wd, *, cfg: ArchConfig,
                          e_offset: int, E_l: int, C: int):
    """Local dispatch -> expert FFN -> combine for E_l experts.
    xl [N,d]; gl/il [N,k]; wg/wu [E_l,d,ff]; wd [E_l,ff,d]."""
    N, d = xl.shape
    k = cfg.num_experts_per_tok
    order, dest, keep = dispatch_plan(il, E_l, C, e_offset)
    token_of = torch.div(order, k, rounding_mode="floor")

    # rows of dropped pairs all land on the trash row, which is cut off
    buf = torch.zeros(E_l * C + 1, d, dtype=xl.dtype, device=xl.device)
    buf.index_copy_(0, dest, xl[token_of])
    buf = buf[:E_l * C].view(E_l, C, d)

    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = F.silu(upcast(g)).to(xl.dtype) * u
    out_buf = torch.bmm(h, wd).view(E_l * C, d)

    gathered = out_buf[torch.clamp(dest, max=E_l * C - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    weighted = gathered * gl.reshape(N * k)[order][:, None]
    # the combine: each token's k weighted outputs summed in ascending
    # expert order — where they stand in the sorted list, the order in
    # which the JAX scatter-add meets them — one fixed add after another
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * k, device=order.device))
    at = torch.sort(inv.view(N, k), dim=1).values
    parts = weighted[at]                                     # [N, k, d]
    out = torch.zeros(N, d, dtype=xl.dtype, device=xl.device)
    for j in range(k):
        out = out + parts[:, j]
    return out


def moe_apply(params, cfg: ArchConfig, x: torch.Tensor, flags=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss)."""
    if flags is not None:
        check_moe_impl(flags)
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, idx, aux = route(params, cfg, xf)
    E_pad = params["w_gate"].shape[0]
    C = capacity(cfg, B * S)
    out = _dispatch_ffn_combine(
        xf, gates, idx, params["w_gate"], params["w_up"], params["w_down"],
        cfg=cfg, e_offset=0, E_l=E_pad, C=C).view(B, S, d)
    if cfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], x)
    return out, aux.to(torch.float32)
