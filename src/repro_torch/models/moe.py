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

On a tensor-parallel serving mesh (ROADMAP item 11b-i) a rank holds the
padded experts ``[r E/tp, (r+1) E/tp)`` and its columns of the router:
every rank gathers the whole router logits (one all-reduce), routes
every token alike, and dispatches over the *global* plan with the
global capacity, so its drops are the unsharded call's; the pairs of
other ranks' experts go to the trash row, and the rank's output, its
experts' terms in ascending expert order, is summed over the ranks by
the caller.  The pad experts sit on the last ranks (granite's 8 on
rank 1 at tp 2, on rank 3 at tp 4), which compute them for nothing.
Padded experts the ranks do not divide are held whole, and the rules
then cut each expert's FFN width instead (``resolve_spec`` gives the
model axis to the first dimension that divides): every rank dispatches
to every expert and its output is its columns' part of the sum.  A
router or shared expert left whole is computed whole.

On a training mesh (``RuntimeFlags.train``, ROADMAP item 11c-i)
:func:`mesh_moe` computes the JAX function of ``moe_impl``: ``"ep"``'s
two branches (``_moe_ep`` and ``_moe_ep_decode``, chosen by JAX's rule
on the global token count) and the gather dispatch.  The training-sized
``_moe_ep`` gives each data shard its own capacity, ``capacity(cfg,
N_l)``, so its drops are a shard's, not the unsharded call's; the others
dispatch every token with the global capacity.  :func:`ep_plain` is the
same function in one process (``moe_impl="ep"`` without a mesh).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import linear, mlp_apply, mlp_template, no_tf32
from .params import ParamSpec, Template
from ..kernels.ref import upcast
from ..sharding.group import cut, gather_blocks

#: ``moe_impl="ep"`` where the flags name no mesh
EP_NEEDS_MESH = ("expert-parallel MoE (moe_impl='ep') needs a training "
                 "mesh, as JAX's shard_map does: flags with model_size > 1 "
                 "or batch_axes, on make_train_step(mesh=...) (ROADMAP "
                 "Queue 1 item 11c-i)")

#: JAX's branch rule: the weight-stationary decode branch at or below
#: this many tokens per padded expert
DECODE_TOKENS_PER_EXPERT = 16


def check_moe_impl(flags) -> None:
    """Raise for a MoE implementation the port does not run: ``"ep"``
    without ``model_size > 1`` or ``batch_axes`` (JAX's needs a mesh)."""
    impl = getattr(flags, "moe_impl", "gather")
    if impl == "ep":
        if getattr(flags, "model_size", 1) <= 1 \
                and not getattr(flags, "batch_axes", ()):
            raise NotImplementedError(EP_NEEDS_MESH)
        return
    if impl != "gather":
        raise ValueError(f"unknown moe_impl {impl!r}")


def padded_experts(cfg: ArchConfig) -> int:
    m = cfg.expert_pad_multiple
    return -(-cfg.num_experts // m) * m


def moe_template(cfg: ArchConfig) -> Template:
    d, ff = cfg.d_model, cfg.d_ff
    E = padded_experts(cfg)
    t: Template = {
        "router": ParamSpec((d, E), ("embed", "experts_vec"), scale=0.02,
                            init="scaled"),
        "w_gate": ParamSpec((E, d, ff), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((E, d, ff), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((E, ff, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        t["shared"] = mlp_template(d, cfg.num_shared_experts * ff)
    return t


def capacity(cfg: ArchConfig, num_tokens: int) -> int:
    c = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg: ArchConfig, xf: torch.Tensor, tp=None, train=None,
          over=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on [N, d] tokens -> (gates [N, k], expert_idx [N, k] int64,
    aux).  On a tensor-parallel rank (``tp``, its group) the router is
    the rank's expert columns: its logits are written into a zero [N,
    E_pad] and summed over the ranks (exact: one non-zero term a
    column), so that every rank routes on every expert's logit.  On a
    training rank (``train``, its group) the same gather runs under
    autograd on the model line, and ``over`` (the batch line, where the
    rank holds its rows of the batch) makes the load-balance loss the
    global batch's: the top-1 counts and the probability sums are each
    summed over the line before their product."""
    from ..sharding.group import line_enter, line_sum
    E_real = cfg.num_experts
    E_pad = padded_experts(cfg)
    line = train.model if train is not None else None
    cols = params["router"].shape[-1]
    if line is not None and cols < E_pad:
        xf_in = line_enter(xf, line)
    else:
        xf_in, line = xf, None
    with no_tf32(xf.device):
        logits = linear(upcast(xf_in), upcast(params["router"]))
    if line is not None:
        lo = line.index * cols
        logits = line_sum(F.pad(logits, (lo, E_pad - lo - cols)), line)
    tp = cut(tp, logits.shape[-1], E_pad)
    if tp is not None:
        logits = tp.all_reduce(gather_blocks(logits,
                                             logits.shape[-1] * tp.size, tp))
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
    if over is None or over.size == 1:
        frac = top1 / N
        mean_prob = probs.mean(0)
    else:
        n = N * over.size
        frac = over.all_reduce(top1) / n
        mean_prob = line_sum(probs.sum(0), over) / n
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


def partial_sum(params, cfg: ArchConfig) -> bool:
    """Whether a rank's MoE output is its part of a sum over the ranks:
    its experts, or its columns of every expert's FFN, are cut."""
    E, ff, _ = params["w_down"].shape
    return E < padded_experts(cfg) or ff < cfg.d_ff


def moe_apply(params, cfg: ArchConfig, x: torch.Tensor, flags=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss).  On a tensor-parallel
    rank (``flags.tp``) out is the rank's part of a sum over the ranks
    (its experts' terms, or its columns of each expert's, and its
    columns of a shared expert) where :func:`partial_sum` holds, else
    the whole output.  On a training rank (``flags.train``) it is
    :func:`mesh_moe`'s; ``moe_impl="ep"`` without one is :func:`ep_plain`."""
    tp = None
    if flags is not None:
        if getattr(flags, "train", None) is not None:
            return mesh_moe(params, cfg, x, flags)
        check_moe_impl(flags)
        if flags.moe_impl == "ep":
            return ep_plain(params, cfg, x, flags.batch_divisor
                            if flags.batch_axes else 1)
        tp = flags.tp
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, idx, aux = route(params, cfg, xf, tp)
    E_l = params["w_gate"].shape[0]
    C = capacity(cfg, B * S)
    experts = cut(tp, E_l, padded_experts(cfg))
    out = _dispatch_ffn_combine(
        xf, gates, idx, params["w_gate"], params["w_up"], params["w_down"],
        cfg=cfg, e_offset=0 if experts is None else tp.rank * E_l, E_l=E_l,
        C=C).view(B, S, d)
    if cfg.num_shared_experts:
        shared = mlp_apply(params["shared"], x)
        whole = cut(tp, params["shared"]["w_down"].shape[0],
                    cfg.num_shared_experts * cfg.d_ff) is None
        if tp is not None and whole == partial_sum(params, cfg):
            # one of the two is whole: the shared expert's whole output
            # joins rank 0's part, or its part is summed on its own
            shared = shared * (tp.rank == 0) if whole \
                else tp.all_reduce(shared)
        out = out + shared
    return out, aux.to(torch.float32)


# ---------------------------------------------------------------------------
# expert parallelism (moe_impl="ep"): the JAX ``_moe_ep`` and
# ``_moe_ep_decode`` on a training mesh, and the same function in one
# process
# ---------------------------------------------------------------------------

def ep_shards(cfg: ArchConfig, B: int, S: int, batch_divisor: int) -> int:
    """How many shards of the batch ``moe_impl="ep"`` dispatches apart,
    each with its own capacity: ``batch_divisor`` on JAX's training-sized
    branch (``_moe_ep``, more than 16 tokens a padded expert) where it
    divides B, else 1 (``_moe_ep_decode`` and an undivided batch: every
    token with the global capacity)."""
    E_pad = padded_experts(cfg)
    if B * S > DECODE_TOKENS_PER_EXPERT * E_pad and batch_divisor > 1 \
            and B % batch_divisor == 0:
        return batch_divisor
    return 1


def ep_dropped(cfg: ArchConfig, idx: torch.Tensor, B: int, S: int,
               batch_divisor: int) -> int:
    """The (token, expert) pairs a ``moe_impl="ep"`` call on routing
    ``idx`` [B*S, k] drops (``batch_divisor`` 1: the gather dispatch's)."""
    n = ep_shards(cfg, B, S, batch_divisor)
    C = capacity(cfg, B * S // n)
    return sum(count_dropped(part, padded_experts(cfg), C)
               for part in idx.chunk(n))


def ep_plain(params, cfg: ArchConfig, x: torch.Tensor,
             batch_divisor: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of JAX's ``moe_impl="ep"`` in one process, for a
    batch cut ``batch_divisor`` ways on the data axes: the gather
    dispatch over each shard's rows with ``capacity(cfg, N_l)`` on the
    training-sized branch (:func:`ep_shards`), else over every token with
    the global capacity; routing and the load-balance loss over the
    whole batch.  The tests and the card check hold :func:`mesh_moe` to
    it."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gates, idx, aux = route(params, cfg, xf)
    n = ep_shards(cfg, B, S, batch_divisor)
    C = capacity(cfg, B * S // n)
    out = torch.cat([_dispatch_ffn_combine(
        xs, gs, is_, params["w_gate"], params["w_up"], params["w_down"],
        cfg=cfg, e_offset=0, E_l=params["w_gate"].shape[0], C=C)
        for xs, gs, is_ in zip(xf.chunk(n), gates.chunk(n), idx.chunk(n))])
    out = out.view(B, S, d)
    if cfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], x)
    return out, aux.to(torch.float32)


def mesh_moe(params, cfg: ArchConfig, x: torch.Tensor, flags
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on a training rank (``flags.train``: its group; x [B_l,
    S, d], its rows of the batch, the same on every rank of its model
    line; the layer's weights gathered over data).  JAX's functions:

    * ``moe_impl="ep"`` on more than 16 tokens a padded expert, the batch
      cut on ``batch_axes`` (``_moe_ep``): the rank dispatches its own
      ``N_l`` tokens with ``C = capacity(cfg, N_l)``;
    * ``"ep"`` otherwise (``_moe_ep_decode``), and ``"gather"``: every
      token with the global ``C``, the rows gathered over the batch line
      first and the rank's kept after.  (JAX's decode branch keeps the
      weights in place and contracts their ``d`` slices; here they are
      gathered, as on the training branch: the same function.)

    Routing is every expert's (the router's columns gathered on the model
    line) and the load-balance loss the global batch's (:func:`route`).
    The rank dispatches to its experts (or every expert, on its columns
    of each, where the rules cut the FFN width instead) and the parts are
    summed over the model line.  With ``train.drops`` a dict, the rank
    records its dropped pairs under ``train.layer``."""
    from ..sharding.group import line_enter, line_gather, line_sum
    from .layers import mesh_mlp
    g = flags.train
    B_l, S, d = x.shape
    split = g.split and g.batch.size > 1
    B = B_l * (g.batch.size if split else 1)
    local = flags.moe_impl == "ep" and bool(flags.batch_axes) and \
        ep_shards(cfg, B, S, flags.batch_divisor) > 1
    xf = x.reshape(B_l * S, d)
    gates, idx, aux = route(params, cfg, xf, train=g,
                            over=g.batch if split else None)
    gathered = split and not local
    if gathered:
        xf = line_gather(xf, g.batch, 0)
        gates = line_gather(gates, g.batch, 0)
        idx = g.batch.all_gather(idx, 0)
    C = capacity(cfg, xf.shape[0])
    E_l, _, ff_l = params["w_gate"].shape
    experts = E_l < padded_experts(cfg)
    parallel = experts or ff_l < cfg.d_ff
    line = g.model if parallel else None
    out = _dispatch_ffn_combine(
        line_enter(xf, line), line_enter(gates, line), idx,
        params["w_gate"], params["w_up"], params["w_down"], cfg=cfg,
        e_offset=g.model.index * E_l if experts else 0, E_l=E_l, C=C)
    out = line_sum(out, line)
    if g.drops is not None:
        g.drops[g.layer] = count_dropped(idx, padded_experts(cfg), C) \
            if local or g.batch.index == 0 else 0
    if gathered:
        out = out.narrow(0, g.batch.index * B_l * S, B_l * S)
    out = out.reshape(B_l, S, d)
    if cfg.num_shared_experts:
        out = out + mesh_mlp(params["shared"], x,
                             cfg.num_shared_experts * cfg.d_ff, g.model)
    return out, aux.to(torch.float32)
