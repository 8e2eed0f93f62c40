"""xLSTM blocks (arXiv:2405.04517), the serving half: mLSTM (matrix
memory) and sLSTM (scalar memory), the JAX package's ``models/xlstm``.

Every serving entry point runs one per-token update: the gates and
q/k/v of a window come from one product each, then the state advances
one token at a time, so the state after position t is bitwise the same
whether the tokens came as one prompt, as chunks, or as t + 1 decode
calls (given products whose rows do not depend on the row count,
ROADMAP Hazard 4): the weight products run ``blocked`` (``layers.
linear``), in blocks of a fixed row count on the card.  The state's
own products are f32 and run without TF32: the sLSTM recurrence
through ``linear`` too, and the mLSTM readouts, whose matrix is each
row's own state, one row at a time (``layers.each_row``), so that a
row's bits do not depend on the batch it rides in.

Window functions take the live state and return ``(y, final state)``;
``stack``, where given, is a dict of buffers ``[B, L, ...]`` per state
leaf that receives the state after every position (the speculative
verify's stacks).  Gate accumulations are stabilised in log space with
a running max ``m`` as in the paper (eqs. 15-19).

The training forms are the JAX package's: the chunkwise-parallel mLSTM
(``mlstm_apply``: gated attention inside a chunk of ``mlstm_chunk``,
the (C, n, m) state carried across chunks, one activation checkpoint a
chunk) and the sLSTM's two-level checkpointed scan (``slstm_apply``:
one checkpoint per outer chunk of 64 tokens).  Their products are plain
(unblocked): the serving row rule has no place under autograd.

On a training mesh's model line (``transformer.mesh_block``) the mLSTM
runs one of three arms, counted in :data:`ARMS`:

* ``"sp"``, JAX's dispatch at ``SP_TOKENS`` tokens or more with
  ``model_size > 1`` (:func:`mlstm_apply_sp`): each rank scans its
  ``S/mp`` rows from a zero state, the ranks' segment summaries are
  gathered and folded in rank order, and each rescans its rows from the
  prefix; the weights whole on every rank;
* ``"dk"`` below it: the serving ``dk`` cut under autograd
  (``mlstm_apply(..., line=)``): q, k, v and the gates summed over the
  line, each rank's chunks over its ``dk`` rows of C and n, the
  readout's numerator and denominator summed, ``down_proj``'s rows
  summed;
* ``"whole"`` where the rules leave ``dk`` whole.

The sLSTM runs whole on every rank of the line (its cut leaves gathered
on entry): cutting its gate columns would gather h every token.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ref import NEG_INF, upcast
from .config import ArchConfig
from .layers import (each_row, linear, no_tf32, pointwise, remat, scan,
                     softplus)
from .params import ParamSpec, Template
from ..sharding.group import (block_rows, cut, gather_blocks, line_enter,
                              line_gather, line_reduce, line_sum, rank_block,
                              tp_reduce_parts)

State = Dict[str, torch.Tensor]


def _heads(x: torch.Tensor, w: torch.Tensor,
           blocked: bool = True) -> torch.Tensor:
    """``einsum("bshd,hde->bshe")``: a block-diagonal product, one head
    at a time through ``linear`` (``blocked``), or as one einsum."""
    if not blocked:
        return torch.einsum("bshd,hde->bshe", x, w)
    return torch.stack([linear(x[..., i, :], w[i], blocked=True)
                        for i in range(w.shape[0])], dim=-2)


def _inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` rounded as the JAX package computes it, in f32."""
    return (1.0 / torch.tensor(float(n)).sqrt()).item()


def _write_stack(stack: Optional[State], t: int, state: State) -> None:
    if stack is not None:
        for k, a in state.items():
            stack[k][:, t].copy_(a)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_template(cfg: ArchConfig) -> Template:
    d = cfg.d_model
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    return {
        # fused [xm | z]; a tensor-parallel rank holds its dk slice of
        # each head of xm (the dk rows of wq/wk/wv and of the C state it
        # holds) and its slice of z (the rows of down_proj it holds)
        "up_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner"),
                             parts=(hd,) * H + (di,)),
        # block-diagonal (head-wise) q/k/v, as in the paper's
        # LinearHeadwiseExpand — di^2/H params each, not di^2
        "wq": ParamSpec((H, hd, hd), (None, "mlstm_dk", None)),
        "wk": ParamSpec((H, hd, hd), (None, "mlstm_dk", None)),
        "wv": ParamSpec((H, hd, hd), (None, "mlstm_dk", None)),
        "w_igate": ParamSpec((di, H), ("ssm_inner_b", None), init="scaled",
                             scale=0.01),
        "b_igate": ParamSpec((H,), (None,), init="zeros"),
        "w_fgate": ParamSpec((di, H), ("ssm_inner_b", None), init="scaled",
                             scale=0.01),
        "b_fgate": ParamSpec((H,), (None,), init="ones"),
        "down_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _mlstm_products(params, cfg: ArchConfig, x: torch.Tensor,
                    blocked: bool = True, tp=None):
    """The window's products: (q, k, v [B, S, H, hd], the gates' raw
    products [B, S, H] each, z).  On a tensor-parallel rank ``xm`` is
    the rank's dk slice of each head, so q, k, v and the gates are the
    rank's parts of sums over the ranks."""
    H = cfg.num_heads
    up = linear(x, params["up_proj"], blocked=blocked)
    xm, z = up.split(up.shape[-1] // 2, dim=-1)
    B, S, _ = xm.shape
    xh = xm.reshape(B, S, H, -1)
    q = _heads(xh, params["wq"], blocked)
    k = _heads(xh, params["wk"], blocked)
    v = _heads(xh, params["wv"], blocked)
    wi, wf = params["w_igate"], params["w_fgate"]
    if tp is not None:
        hd = wi.shape[0] // H
        wi, wf = (block_rows(w, hd, tp) for w in (wi, wf))
    gi = linear(xm, wi, blocked=blocked)
    gf = linear(xm, wf, blocked=blocked)
    return q, k, v, gi, gf, z


def _mlstm_gates(params, gi: torch.Tensor, gf: torch.Tensor,
                 blocked: bool = True):
    """The log input and forget gates from their raw products."""
    # the serving forms compute the gates in f32; the training forms in
    # the accumulation dtype (f32, or f64 for an f64 run)
    acc = (lambda t: t.float()) if blocked else upcast
    li = acc(gi + params["b_igate"])
    f_raw = acc(gf + params["b_fgate"])
    lf = -pointwise(softplus, -f_raw)                        # log sigmoid(f)
    return li, lf


def _mlstm_qkv_gates(params, cfg: ArchConfig, x: torch.Tensor,
                     blocked: bool = True):
    q, k, v, gi, gf, z = _mlstm_products(params, cfg, x, blocked)
    li, lf = _mlstm_gates(params, gi, gf, blocked)
    return q, k, v, li, lf, z


def mlstm_cache(cfg: ArchConfig, batch: int, device) -> State:
    """The zero state (``device="meta"``: its shapes and dtypes)."""
    H = cfg.num_heads
    hd = 2 * cfg.d_model // H
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=f32, device=device),
            "m": torch.zeros((batch, H), dtype=f32, device=device)}


def _readout(q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``einsum("bhd,bhde->bhe")`` for one row: a product batched over
    its heads."""
    return torch.matmul(q[..., None, :], C)[..., 0, :]


def _mlstm_step(state: State, qs, kf, vf, li0, lf0):
    """One token of the mLSTM recurrence on every row: the JAX
    ``mlstm_decode`` update.  qs (q scaled by 1/sqrt(hd)), kf, vf [B, H,
    hd] f32, li0/lf0 [B, H]; returns the readout's numerator [B, H, hd]
    and denominator [B, H] (f32) and the new state.  On a
    tensor-parallel rank qs, kf, C and n hold the rank's dk slice, so
    the readouts are the rank's parts of sums over dk."""
    C0, n0, m0 = state["C"], state["n"], state["m"]
    decay = lf0 + m0
    m = torch.maximum(decay, li0)
    fw = pointwise(torch.exp, decay - m)[..., None]
    iw = pointwise(torch.exp, li0 - m)[..., None]
    C = fw[..., None] * C0 + (iw * kf)[..., :, None] * vf[..., None, :]
    n = fw * n0 + iw * kf
    num = each_row(_readout, qs, C)
    den = each_row(lambda a, b: (a * b).sum(-1), qs, n)
    return num, den, {"C": C, "n": n, "m": m}


def _mlstm_seq(params, cfg: ArchConfig, x: torch.Tensor, state: State,
               stack: Optional[State] = None,
               tp=None) -> Tuple[torch.Tensor, State]:
    """Advance (C, n, m) over x [B, L, d] one token at a time.  Returns
    (y [B, L, d], final state).

    On a tensor-parallel rank (``tp``) the state is the rank's dk slice
    of C and n and its heads of m, and y is the rank's part of a sum
    over the ranks.  Two all-reduces a window: q, k, v and the gates'
    products, with the rank's m gathered whole beside them (every rank
    then advances m alike), and the readouts' numerators and
    denominators, which the recurrence does not read, once after the
    window's last token.  A width the rules left whole is computed
    whole: with dk whole the window runs as without a mesh (m, cut by
    heads, gathered whole, and y the rank's rows of ``down_proj`` where
    d_inner is cut); with the heads whole m is whole on every rank."""
    B, S, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    dk_tp = cut(tp, params["wq"].shape[1], di // H)
    m_tp = cut(tp, state["m"].shape[-1], H)
    out_tp = cut(tp, params["down_proj"].shape[0], di)
    q, k, v, gi, gf, z = _mlstm_products(params, cfg, x, tp=dk_tp)
    sums = [q, k, v, gi, gf] if dk_tp is not None else []
    if m_tp is not None:
        sums.append(gather_blocks(state["m"], H, tp))
    if sums:
        sums = tp_reduce_parts(sums, tp)
        if dk_tp is not None:
            q, k, v, gi, gf = sums[:5]
        if m_tp is not None:
            state = dict(state, m=sums[-1])
    li, lf = _mlstm_gates(params, gi, gf)
    # elementwise, so converted for the whole window with the same bits
    qs = q.float() * _inv_sqrt(di // H)
    kf, vf = k.float(), v.float()
    if dk_tp is not None:
        dk = rank_block(di // H, tp)
        qs, kf = qs[..., dk], kf[..., dk]

    def held(st: State) -> State:
        """The state as this rank holds it (its heads of m)."""
        return st if m_tp is None else \
            dict(st, m=st["m"][:, rank_block(H, tp)])

    def step(t: int, state: State):
        num, den, state = _mlstm_step(state, qs[:, t], kf[:, t], vf[:, t],
                                      li[:, t], lf[:, t])
        _write_stack(stack, t, held(state))
        return state, (num, den, state["m"])

    with no_tf32(x.device):
        state, outs = scan(step, state, S, "_mlstm_seq")
    nums, dens, ms = zip(*outs)
    num, den = torch.stack(nums, dim=1), torch.stack(dens, dim=1)
    if dk_tp is not None:
        num, den = tp_reduce_parts([num, den], tp)
    m = torch.stack(ms, dim=1)
    h = num / torch.maximum(den.abs(), pointwise(torch.exp, -m))[..., None]
    h = h.reshape(B, S, di)
    if out_tp is not None:
        h = h[..., rank_block(di, tp)]
        if dk_tp is None:                   # z whole beside a cut d_inner
            z = z[..., rank_block(di, tp)]
    h = h.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return linear(h, params["down_proj"], blocked=True), held(state)


def mlstm_window(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 stack: Optional[State] = None, tp=None):
    """Multi-token continuation from a live state (ingest and verify
    windows).  x: [B, L, d]."""
    return _mlstm_seq(params, cfg, x, cache, stack, tp)


def mlstm_prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                             initial_state: Optional[State] = None,
                             tp=None):
    if initial_state is None:
        initial_state = mlstm_cache(cfg, x.shape[0], x.device)
    return _mlstm_seq(params, cfg, x, initial_state, tp=tp)


def mlstm_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 tp=None):
    """One token.  x: [B, 1, d]."""
    return _mlstm_seq(params, cfg, x, cache, tp=tp)


def _mlstm_chunk(C0, n0, m0, q, k, v, li, lf, hd: int, parts: bool = False):
    """One chunk of the chunkwise-parallel mLSTM (the JAX
    ``_mlstm_chunk``): from the state (C0 [B,H,hd,hd], n0 [B,H,hd], m0
    [B,H]) over q, k, v [B,L,H,hd] and the log gates li, lf [B,L,H];
    returns (C, n, m after the chunk, h [B,L,H,hd] f32).  ``parts``:
    q, k, C0 and n0 hold a rank's ``dk`` rows, and it returns (C, n, m,
    the readout's numerator [B,L,H,hd] and denominator [B,L,H], the
    rank's parts of sums over dk, and the floor exp(-m) [B,L,H])."""
    L = q.shape[1]
    F_t = torch.cumsum(lf, dim=1).transpose(1, 2)           # [B,H,L]
    li_t = li.transpose(1, 2)
    # D[t,s] = F_t - F_s + li_s   (s <= t)
    D = F_t[..., :, None] - F_t[..., None, :] + li_t[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(causal, D, NEG_INF)
    G = F_t + m0[..., None]                                  # inter-chunk
    m = torch.maximum(D.amax(-1), G)                         # [B,H,L]
    qf = upcast(q) * _inv_sqrt(hd)   # scale q once: intra AND inter
    kf, vf = upcast(k), upcast(v)
    qk = torch.einsum("bthd,bshd->bhts", qf, kf)             # [B,H,L,L]
    Sc = qk * torch.exp(D - m[..., None])
    inter_w = torch.exp(G - m).transpose(1, 2)               # [B,L,H]
    num = (torch.einsum("bhts,bshd->bthd", Sc, vf)
           + inter_w[..., None] * torch.einsum("bthd,bhde->bthe", qf, C0))
    den = (Sc.sum(-1).transpose(1, 2)
           + inter_w * torch.einsum("bthd,bhd->bth", qf, n0))
    # stabilised denominator floor: max(|den|, exp(-m)) (paper eq. 19)
    floor = torch.exp(-m).transpose(1, 2)
    if parts:
        out = (num, den, floor)
    else:
        out = (num / torch.maximum(den.abs(), floor)[..., None],)
    # ---- the state at the end of the chunk
    decay_s = F_t[..., -1:] - F_t + li_t                     # [B,H,L]
    m_next = torch.maximum(F_t[..., -1] + m0, decay_s.amax(-1))
    w_s = torch.exp(decay_s - m_next[..., None])
    w0 = torch.exp(F_t[..., -1] + m0 - m_next)
    C = (w0[..., None, None] * C0
         + torch.einsum("bhs,bshd,bshe->bhde", w_s, kf, vf))
    n = w0[..., None] * n0 + torch.einsum("bhs,bshd->bhd", w_s, kf)
    return (C, n, m_next) + out


def _dk_inputs(params, cfg: ArchConfig, x: torch.Tensor, line):
    """q, k, v, the log gates and z of a rank that holds its ``dk`` slice
    of each head of ``xm`` (``up_proj``'s columns, ``wq``/``wk``/``wv``'s
    rows) over the model ``line``: the products' parts summed over the
    line in one all-reduce (both ways: each rank then runs its own dk
    rows), q and k cut to the rank's dk rows; z is the rank's slice."""
    H = cfg.num_heads
    hd = 2 * cfg.d_model // H
    # the gate weights and biases are whole, and each rank runs its own
    # part with them (the weights' rows of each head's block, the gates
    # its dk rows' readout): their gradients summed over the line
    entered = dict(params, **{n: line_enter(params[n], line) for n in (
        "w_igate", "w_fgate", "b_igate", "b_fgate")})
    q, k, v, gi, gf, z = _mlstm_products(entered, cfg, x, False, tp=line)
    pack = line_reduce(torch.cat([q, k, v, gi[..., None], gf[..., None]],
                                 dim=-1), line)
    q, k, v, gi, gf = pack.split([hd, hd, hd, 1, 1], dim=-1)
    li, lf = _mlstm_gates(entered, gi[..., 0], gf[..., 0], blocked=False)
    dk = rank_block(hd, line)
    return q[..., dk], k[..., dk], v, li, lf, z


def mlstm_apply(params, cfg: ArchConfig, x: torch.Tensor,
                initial_state: Optional[State] = None, line=None
                ) -> Tuple[torch.Tensor, State]:
    """Full sequence (training, the JAX ``_mlstm_forward``): x [B, S, d]
    -> (y [B, S, d], the state after it), in chunks of ``mlstm_chunk``
    with one activation checkpoint a chunk.  Padded positions have the
    input gate closed (li = NEG_INF) and the forget gate open (lf = 0),
    so they touch neither the outputs nor the state.

    ``line``: a training rank's model line, over which the rules cut
    ``dk`` (the ``"dk"`` arm; the state returned is then the rank's dk
    rows of C and n, and ``initial_state`` is not taken)."""
    B, S, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    line = cut(line, params["wq"].shape[1], hd)
    if line is None:
        q, k, v, li, lf, z = _mlstm_qkv_gates(params, cfg, x, blocked=False)
    else:
        q, k, v, li, lf, z = _dk_inputs(params, cfg, line_enter(x, line),
                                        line)
    L = min(cfg.mlstm_chunk, S)
    pad = -S % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        lf = F.pad(lf, (0, 0, 0, pad))
    st = initial_state or mlstm_cache(cfg, B, x.device)
    C, n, m = (st[k].to(li.dtype) for k in ("C", "n", "m"))
    if line is not None:
        C, n = C[:, :, :q.shape[-1]], n[:, :, :q.shape[-1]]
    outs = []
    for c0 in range(0, S + pad, L):
        c = slice(c0, c0 + L)
        C, n, m, *out = remat(_mlstm_chunk, C, n, m, q[:, c], k[:, c],
                              v[:, c], li[:, c], lf[:, c], hd,
                              line is not None)
        outs.append(out)
    if line is None:
        h = torch.cat([o[0] for o in outs], dim=1)[:, :S]
    else:
        num, den, floor = (torch.cat([o[i] for o in outs], dim=1)[:, :S]
                           for i in range(3))
        nd = line_reduce(torch.cat([num, den[..., None]], dim=-1), line)
        num, den = nd[..., :hd], nd[..., hd]
        h = num / torch.maximum(den.abs(), floor)[..., None]
    h = h.reshape(B, S, di)
    if line is not None:
        h = h[..., rank_block(di, line)]
    h = h.to(x.dtype) * F.silu(upcast(z)).to(x.dtype)
    y = line_sum(linear(h, params["down_proj"]), line)
    return y, {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# the mLSTM on a training mesh's model line
# ---------------------------------------------------------------------------

#: the sequence length from which a model axis of more than one rank
#: scans the sequence in parallel (JAX's dispatch,
#: ``transformer.layer_apply``'s ``use_sp``)
SP_TOKENS = 8192

#: the arm of every mLSTM layer a training rank of this process ran
#: (``"sp"``, ``"dk"``, ``"whole"``: a reading for the tests)
ARMS: collections.Counter = collections.Counter()


def mesh_mlstm(params, cfg: ArchConfig, x: torch.Tensor, flags,
               gathered) -> torch.Tensor:
    """The mLSTM layer on a training rank (``flags.train``): x [B, S, d],
    the same on every rank of the model line, in; the output, the same
    on every rank, out.  ``params`` are the rank's slices (gathered over
    data); ``gathered(parallel)`` gives them whole on the line (the
    gradient of a cut leaf reduce-scattered and of a whole one summed
    where ``parallel``, else kept as this rank's slice)."""
    line = flags.train.model
    S, mp = x.shape[1], flags.model_size
    if mp > 1 and S >= SP_TOKENS and S % mp == 0 and S // mp >= 2:
        ARMS["sp"] += 1
        return mlstm_apply_sp(gathered(True), cfg, x, line)
    if cut(line, params["wq"].shape[1], 2 * cfg.d_model // cfg.num_heads):
        ARMS["dk"] += 1
        return mlstm_apply(params, cfg, x, line=line)[0]
    ARMS["whole"] += 1
    return mlstm_apply(gathered(False), cfg, x)[0]


def _combine_states(left: State, right: State) -> State:
    """The summary of two consecutive segments (the JAX
    ``_combine_states``): each (C, n, m, F) with (C, n) stabilised by
    exp(m) and F the segment's total log-forget; ``left`` first."""
    m_new = torch.maximum(left["m"] + right["F"], right["m"])
    wl = torch.exp(left["m"] + right["F"] - m_new)
    wr = torch.exp(right["m"] - m_new)
    return {"C": wl[..., None, None] * left["C"]
            + wr[..., None, None] * right["C"],
            "n": wl[..., None] * left["n"] + wr[..., None] * right["n"],
            "m": m_new, "F": left["F"] + right["F"]}


def mlstm_apply_sp(params, cfg: ArchConfig, x: torch.Tensor, line
                   ) -> torch.Tensor:
    """The sequence-parallel mLSTM (the JAX ``mlstm_apply_sp``'s body)
    over the model ``line``: x [B, S, d], the same on every rank, in
    (its gradient summed over the line); the rank scans its ``S/mp``
    rows from a zero state (pass 1), keeping the segment's total
    log-forget, gathers every rank's (C, n, m, F) summary, folds those
    of lower rank in rank order from a zero summary (as JAX does:
    every segment combined, the later ones discarded), and rescans its
    rows from that prefix (pass 2).  ``params`` whole.  Returns y [B,
    S, d], the ranks' rows gathered."""
    B, S, d = x.shape
    di = 2 * d
    n = S // line.size
    x = line_enter(x, line)[:, line.index * n:(line.index + 1) * n]
    # pass 1: the segment's total log-forget and its end state from zero
    xm = linear(x, params["up_proj"][:, :di])
    _, lf = _mlstm_gates(params, linear(xm, params["w_igate"]),
                         linear(xm, params["w_fgate"]), blocked=False)
    _, end = mlstm_apply(params, cfg, x)
    seg = dict(end, F=lf.sum(dim=1))
    keys = ("C", "n", "m", "F")
    flat = torch.cat([seg[k].reshape(B, -1) for k in keys], dim=-1)
    every = line_gather(flat[None], line, 0)                 # [mp, B, K]
    sizes = [seg[k][0].numel() for k in keys]
    prefix = {k: torch.zeros_like(seg[k]) for k in keys}
    for i in range(line.size):
        parts = every[i].split(sizes, dim=-1)
        nxt = _combine_states(prefix, {k: p.reshape(seg[k].shape)
                                       for k, p in zip(keys, parts)})
        # only the segments before this rank's, but every one folded on
        # every rank (as JAX's ``where``), so that the ranks' graphs, and
        # their collectives backward, are one
        keep = torch.tensor(i < line.index, device=x.device)
        prefix = {k: torch.where(keep, nxt[k], prefix[k]) for k in keys}
    # pass 2: the rows again from the state of every row before them
    y, _ = mlstm_apply(params, cfg, x, initial_state=prefix)
    return line_gather(y, line, 1, summed=False)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block(cfg: ArchConfig) -> int:
    """The sLSTM's gate block: the channels ``hd * gcd(H, 4)`` that one
    run of the recurrence's output columns covers.  The recurrence's
    [B, H, 4 hd] product is read as [B, 4 d] and split into the gates
    i, f, z, o of d channels each, so gate g's channel c is column ``(g
    d + c) % 4 hd`` of head ``(g d + c) // 4 hd``: head and gate
    boundaries both fall on multiples of this block.  A tensor-parallel
    rank holds its slice of every block of the state's d channels, of
    w_x's and b's 4 d gate columns and of w_h's 4 hd columns, so that
    the columns it holds of each produce the channels it holds."""
    H = cfg.slstm_num_heads
    return cfg.d_model // H * math.gcd(H, 4)


def slstm_template(cfg: ArchConfig) -> Template:
    d = cfg.d_model
    H = cfg.slstm_num_heads
    hd = d // H
    a = slstm_block(cfg)
    return {
        # input weights for i, f, z, o gates
        "w_x": ParamSpec((d, 4 * d), ("embed", "ssm_inner"),
                         parts=(a,) * (4 * d // a)),
        "b": ParamSpec((4 * d,), ("ssm_inner_vec",), init="zeros",
                       parts=(a,) * (4 * d // a)),
        # block-diagonal recurrent weights per head
        "w_h": ParamSpec((H, hd, 4 * hd), (None, "head_dim", "ssm_inner"),
                         parts=(a,) * (4 * hd // a)),
        "out_proj": ParamSpec((d, d), ("embed_b", "embed")),
    }


def slstm_cache(cfg: ArchConfig, batch: int, device) -> State:
    """The zero state (``device="meta"``: its shapes and dtypes)."""
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


def _slstm_step(w_h: torch.Tensor, b: torch.Tensor, state: State,
                x_t: torch.Tensor, blocked: bool = True,
                h_all: Optional[torch.Tensor] = None):
    """One token on every row: the JAX ``_slstm_step``.  ``w_h`` and
    ``b`` are the f32 weights, converted once per window; x_t: [B, 4d],
    the precomputed input projection.  On a tensor-parallel rank the
    state, x_t, b and w_h's columns are the rank's channels and
    ``h_all`` is the whole of h [B, d_model], which every head's
    recurrence reads."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B, d = c.shape
    H = w_h.shape[0]
    hh = (h if h_all is None else h_all).reshape(B, H, w_h.shape[1])
    if blocked:
        rec = torch.stack([linear(hh[:, i], w_h[i], blocked=True)
                           for i in range(H)], dim=1).reshape(B, 4 * d)
    else:
        rec = torch.einsum("bhd,hdk->bhk", hh, w_h).reshape(B, 4 * d)
    g = (x_t.float() if blocked else upcast(x_t)) + rec + b
    gi, gf, gz, go = g.split(d, dim=-1)
    li = gi                                                  # exp input gate
    lf = -softplus(-gf)                                      # log sigmoid
    m_new = torch.maximum(lf + m, li)
    iw = torch.exp(li - m_new)
    fw = torch.exp(lf + m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = fw * c + iw * z
    n_new = fw * n + iw
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_seq(params, cfg: ArchConfig, x: torch.Tensor, state: State,
               stack: Optional[State] = None,
               tp=None) -> Tuple[torch.Tensor, State]:
    """Sequential (c, n, h, m) advance, one ``_slstm_step`` per token.
    Returns (y [B, L, d], final state).  On a tensor-parallel rank
    (``tp``) the state is the rank's slice of each gate block
    (:func:`slstm_block`), h is gathered whole before every token (one
    all-reduce a token) and y is the product of the rank's channels
    with their rows of the replicated ``out_proj``: the rank's part of a
    sum over the ranks.  Gate blocks the ranks do not divide are left
    whole, and the recurrence runs whole on every rank (y whole); a
    state the rules cut all the same (d_model divided) is the rank's
    contiguous slice, gathered whole before the window (one all-reduce)
    and cut again after every position."""
    d = cfg.d_model
    xg = linear(x, params["w_x"], blocked=True)              # [B, L, 4d]
    # hoisted out of the token loop: the same values, converted once
    w_h = params["w_h"].float()
    b = params["b"].float()
    w_out = params["out_proj"]
    gate_tp = cut(tp, xg.shape[-1], 4 * d)
    state_tp = cut(tp, state["c"].shape[-1], d) if gate_tp is None else None
    if gate_tp is not None:
        a = slstm_block(cfg)
        w_out = block_rows(w_out, a, tp)
    if state_tp is not None:
        keys = list(state)
        state = dict(zip(keys, tp_reduce_parts(
            [gather_blocks(state[k], d, tp) for k in keys], tp)))

    def held(st: State) -> State:
        return st if state_tp is None else \
            {k: v[:, rank_block(d, tp)] for k, v in st.items()}

    def step(t: int, state: State):
        h_all = None if gate_tp is None else tp_reduce_parts(
            [gather_blocks(state["h"], a, tp)], tp)[0]
        state = _slstm_step(w_h, b, state, xg[:, t], h_all=h_all)
        _write_stack(stack, t, held(state))
        return state, state["h"]

    with no_tf32(x.device):
        state, hs = scan(step, state, x.shape[1], "_slstm_seq")
    y = linear(torch.stack(hs, dim=1).to(x.dtype), w_out, blocked=True)
    return y, held(state)


def slstm_window(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 stack: Optional[State] = None, tp=None):
    """Multi-token continuation from a live state (ingest and verify
    windows).  x: [B, L, d]."""
    return _slstm_seq(params, cfg, x, cache, stack, tp)


def slstm_prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                             initial_state: Optional[State] = None,
                             tp=None):
    if initial_state is None:
        initial_state = slstm_cache(cfg, x.shape[0], x.device)
    return _slstm_seq(params, cfg, x, initial_state, tp=tp)


def slstm_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: State,
                 tp=None):
    """One token.  x: [B, 1, d]."""
    return _slstm_seq(params, cfg, x, cache, tp=tp)


def _slstm_outer(w_h, b, c, n, h, m, xg):
    """One outer chunk of the sLSTM scan: the tokens of xg [B, L, 4d]
    one at a time from the state (c, n, h, m); returns the state after
    it and h [B, L, d] f32."""
    def step(t: int, state: State):
        state = _slstm_step(w_h, b, state, xg[:, t], blocked=False)
        return state, state["h"]

    state, hs = scan(step, {"c": c, "n": n, "h": h, "m": m}, xg.shape[1],
                     "_slstm_outer")
    return (state["c"], state["n"], state["h"], state["m"],
            torch.stack(hs, dim=1))


def slstm_apply(params, cfg: ArchConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, State]:
    """Full sequence (training, the JAX ``_slstm_forward``): x [B, S, d]
    -> (y [B, S, d], the state after it).  The two-level scan: outer
    chunks of L = 64 tokens (S itself below 64, single tokens where 64
    does not divide S), one activation checkpoint each, so the backward
    keeps the state at chunk boundaries only."""
    B, S, d = x.shape
    xg = linear(x, params["w_x"])                            # [B, S, 4d]
    w_h, b = upcast(params["w_h"]), upcast(params["b"])
    L = 64 if S % 64 == 0 else (S if S < 64 else 1)
    if S % L:
        L = 1
    st = slstm_cache(cfg, B, x.device)
    c, n, h, m = (st[k].to(w_h.dtype) for k in ("c", "n", "h", "m"))
    hs = []
    for c0 in range(0, S, L):
        c, n, h, m, hc = remat(_slstm_outer, w_h, b, c, n, h, m,
                               xg[:, c0:c0 + L])
        hs.append(hc)
    y = linear(torch.cat(hs, dim=1).to(x.dtype), params["out_proj"])
    return y, {"c": c, "n": n, "h": h, "m": m}
