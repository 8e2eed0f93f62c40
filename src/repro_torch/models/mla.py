"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437): the port
of the JAX package's ``models/mla.py``, with its sequence-parallel
training branch on a training mesh (:func:`mesh_forward`).

Keys and values are compressed into a latent ``c_kv`` (rank
``kv_lora_rank``) plus one shared RoPE key per position, and the caches
hold only those: ``c_kv`` ``[B, max_len, r]`` and ``k_rope`` ``[B,
max_len, rope]`` in slot rows (on the slot and state layouts),
``[num_blocks, block_size, ...]`` arenas on the paged and hybrid
layouts.  Prefill and extend materialise per-head K/V from the latents
and attend through ``chunked_attention``; decode and verify windows use
weight absorption: the queries go into latent space and attend over the
latents themselves.  Caches are written in place.  With a sliding
window the slot rows hold ``min(max_len, window)`` positions that wrap,
as a GQA layer's do (``attention.cache_len``): prefill keeps the last
of them rotated, decode writes at ``pos % size`` and masks the slots
below ``min(pos + 1, size)``, and a verify window is refused, as in
JAX.

The port's rules, beside the reference's arithmetic:

* Every product whose rows are tokens goes through ``layers.linear``,
  and the per-head absorbed products (``q_nope . wk_b``, ``out_lat .
  wv_b``) through :func:`_per_head`, which keeps the same single-row
  rule: on the CPU one row is multiplied as two, so a row decoded alone
  rounds as it does in a batch (ROADMAP Hazard 4).
* The latent norms ``q_a_norm`` and ``kv_a_norm`` run through
  ``rms_norm(..., flags.fused_rmsnorm)``: the fused RMSNorm op (K1) on
  the card.  The JAX package calls them plain; the port routes them so
  that K1's plain version runs nowhere on the card's main path.
* On a tensor-parallel serving mesh a rank holds its heads of
  ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` (all of them where the ranks
  do not divide the heads) and the latent projections whole; its cache
  holds its lanes of ``c_kv``'s lora rank and its positions of
  ``k_rope`` (a slot row's contiguous range, every block's offsets of a
  paged arena), each whole where the ranks do not divide it.  Prefill
  and extend materialise the rank's heads from whole latents (an
  extend gathers its prefix whole first, one all-reduce) and store the
  rank's slices.  Decode and verify are absorbed (:func:`tp_decode`):
  every head's absorbed query is gathered, each rank scores its lora
  lanes over every position and the rope part over its positions, and
  one all-reduce adds them in f32, so each score is the sum of the lora
  rank's partials and the rope term of the rank that holds the
  position; the latent output is gathered whole and each rank expands
  its heads through ``wv_b`` and ``wo``.
* Decode and verify are capturable as CUDA graphs: masks come from
  tensor comparisons and ``torch.where``, cache writes are
  ``index_put_``, and nothing waits for the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels.ref import NEG_INF, two_rows, upcast
from ..sharding.group import own_range, placed, rank_block, tp_reduce_parts
from . import attention as attn
from . import paging
from .chunked_attention import chunked_attention
from .config import ArchConfig
from .layers import apply_rope, each_row, linear, rms_norm
from .params import DTYPES, ParamSpec, Template


def mla_template(cfg: ArchConfig) -> Template:
    d = cfg.d_model
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, cfg.q_lora_rank), ("embed", "q_lora")),
        "q_a_norm": {"scale": ParamSpec((cfg.q_lora_rank,), ("q_lora",),
                                        init="ones")},
        "wq_b": ParamSpec((cfg.q_lora_rank, H, nope + rope),
                          ("q_lora", "heads", "qk_dim")),
        "wkv_a": ParamSpec((d, cfg.kv_lora_rank + rope), ("embed", "kv_lora")),
        "kv_a_norm": {"scale": ParamSpec((cfg.kv_lora_rank,), ("kv_lora",),
                                         init="ones")},
        "wk_b": ParamSpec((cfg.kv_lora_rank, H, nope),
                          ("kv_lora", "heads", "qk_dim")),
        "wv_b": ParamSpec((cfg.kv_lora_rank, H, vd),
                          ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((H, vd, d), ("heads", "head_dim", "embed")),
    }


def _latents(cfg: ArchConfig, lead) -> Dict[str, torch.Tensor]:
    dt = DTYPES[cfg.dtype]
    return {"c_kv": torch.empty(lead + (cfg.kv_lora_rank,), dtype=dt,
                                device="meta"),
            "k_rope": torch.empty(lead + (cfg.qk_rope_head_dim,), dtype=dt,
                                  device="meta")}


def abstract_mla_cache(cfg: ArchConfig, batch: int, max_len: int):
    """Slot rows of latents (the JAX ``abstract_mla_cache``): ``max_len``
    positions, or a sliding window's ``min(max_len, window)``, which
    wrap as a GQA layer's do (``attention.cache_len``)."""
    return _latents(cfg, (batch, attn.cache_len(cfg, max_len)))


def abstract_paged_mla_cache(cfg: ArchConfig, num_blocks: int,
                             block_size: int):
    """The paged latent arena (block 0 = trash)."""
    return _latents(cfg, (num_blocks, block_size))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _per_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkn->...hn")``: one product per head, batched over
    the heads, whose rows are the tokens.  On the CPU a single row is
    multiplied as two and the first kept, as ``layers.linear`` does."""
    *lead, H, K = x.shape
    rows = x.reshape(-1, H, K).transpose(0, 1)              # [H, M, K]
    if rows.device.type == "cpu" and rows.shape[1] == 1:
        y = torch.bmm(two_rows(rows, 1), w)[:, :1]
    else:
        y = torch.bmm(rows, w)
    return y.transpose(0, 1).reshape(*lead, H, w.shape[-1])


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...r,rhk->...hk")`` as one product."""
    r, h, k = w.shape
    return linear(x, w.reshape(r, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one product."""
    h, k, d = wo.shape
    return linear(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def _project_q(params, cfg: ArchConfig, x, positions, flags):
    cq = linear(x, params["wq_a"])
    cq = rms_norm(params["q_a_norm"], cq, cfg.norm_eps, flags.fused_rmsnorm)
    q = _heads(cq, params["wq_b"])
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, cfg: ArchConfig, x, positions, flags):
    ckv = linear(x, params["wkv_a"])
    r = cfg.kv_lora_rank
    c_kv = rms_norm(params["kv_a_norm"], ckv[..., :r].contiguous(),
                    cfg.norm_eps, flags.fused_rmsnorm)
    # rope on the shared key: [B, S, rope] with a head axis of 1
    k_rope = apply_rope(ckv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _scale(cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    # a host scalar: a tensor made on the card would wait for the card
    return 1.0 / torch.sqrt(torch.tensor(
        float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim), dtype=dtype))


# ---------------------------------------------------------------------------
# prefill and extend: per-head K/V materialised from the latents
# ---------------------------------------------------------------------------

def _materialised(params, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope,
                  q_offset: int) -> torch.Tensor:
    """Causal attention of the queries over per-head K/V made from the
    position-ordered latents ``[B, T, ...]``; query row ``s`` at
    absolute position ``q_offset + s``.  Returns the block's output."""
    B, T, _ = c_kv.shape
    k_nope = _heads(c_kv, params["wk_b"])
    v = _heads(c_kv, params["wv_b"])
    qh = torch.cat([q_nope, q_rope], dim=-1)
    kh = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, k_nope.shape[2], k_rope.shape[-1])], dim=-1)
    out = chunked_attention(qh, kh, v, causal=True,
                            window=cfg.sliding_window, q_offset=q_offset)
    return _out_proj(out, params["wo"])


def mla_forward(params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, flags):
    """The prefill arm of the JAX ``mla_apply`` (no cache): returns (the
    block's output, the latents ``c_kv`` and ``k_rope`` of ``x``)."""
    q_nope, q_rope = _project_q(params, cfg, x, positions, flags)
    c_kv, k_rope = _project_kv_latent(params, cfg, x, positions, flags)
    y = _materialised(params, cfg, q_nope, q_rope, c_kv, k_rope, 0)
    return y, c_kv, k_rope


def mesh_forward(params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, flags) -> torch.Tensor:
    """The prefill arm on a training rank (``flags.train``; the JAX
    ``mla_apply``'s branch through ``sequence_parallel_attention``): x
    [B, S, d], the same on every rank of the model line, in; the block's
    whole output out.  Per-head K/V are made from whole latents (the
    latent projections and norms whole on every rank), with KV = H, and
    the arm is ``chunked_attention.sp_arm(H, H, S, mp)``'s:

    * ``"heads"``: the rank's heads of ``wq_b``, ``wk_b``, ``wv_b`` and
      ``wo`` (the rules cut them), their attention, and the rank's part
      of the output projection summed over the line;
    * ``"seq"``: the rank's ``S/mp`` query rows against K/V of every
      position, the head-cut weights gathered, the rows' outputs
      gathered over the line;
    * ``"whole"``: everything whole on every rank.

    In the first two x and the whole weights enter through
    ``line_enter`` (their gradients summed over the line), a gathered
    weight's gradient is reduce-scattered."""
    from ..sharding.group import line_enter, line_gather, line_sum
    from .chunked_attention import sequence_parallel_attention, sp_arm
    line = flags.train.model
    H, S = cfg.num_heads, x.shape[1]
    arm = sp_arm(H, H, S, line.size)
    parallel = arm != "whole"

    def whole(w):
        return line_enter(w, line) if parallel else w

    def weight(name, dim):
        w = params[name]
        if w.shape[dim] < H:                        # the rank's heads
            return w if arm == "heads" else \
                line_gather(w, line, dim, summed=parallel)
        return whole(w)

    p = {"wq_a": whole(params["wq_a"]), "wkv_a": whole(params["wkv_a"]),
         "q_a_norm": {"scale": whole(params["q_a_norm"]["scale"])},
         "kv_a_norm": {"scale": whole(params["kv_a_norm"]["scale"])},
         "wq_b": weight("wq_b", 1), "wk_b": weight("wk_b", 1),
         "wv_b": weight("wv_b", 1), "wo": weight("wo", 0)}
    xin = whole(x)
    rows = slice(None)
    if arm == "seq":
        n = S // line.size
        rows = slice(line.index * n, (line.index + 1) * n)
    q_nope, q_rope = _project_q(p, cfg, xin[:, rows], positions[:, rows],
                                flags)
    c_kv, k_rope = _project_kv_latent(p, cfg, xin, positions, flags)
    B, T, _ = c_kv.shape
    k_nope, v = _heads(c_kv, p["wk_b"]), _heads(c_kv, p["wv_b"])
    qh = torch.cat([q_nope, q_rope], dim=-1)
    kh = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, k_nope.shape[2], k_rope.shape[-1])], dim=-1)
    out = sequence_parallel_attention(qh, kh, v, causal=True,
                                      window=cfg.sliding_window,
                                      flags=flags, arm=arm)
    y = _out_proj(out, p["wo"])
    if arm == "heads":
        return line_sum(y, line)
    if arm == "seq":
        return line_gather(y, line, 1, summed=False)
    return y


def prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor,
                       cache: Dict[str, torch.Tensor], flags) -> torch.Tensor:
    """The JAX ``mla_prefill_into_cache``: attend over the prompt (with
    the layer's window mask) and write its latents into ``cache`` **in
    place**: positions ``[0, S)``, zero beyond, or past a window's
    ``size`` the last ``size`` positions wrapped to slot ``p % size``
    (``attention.window_rows``).  Returns the block's output."""
    y, c_kv, k_rope = mla_forward(params, cfg, x, positions, flags)
    tp = flags.tp
    size = cache["c_kv"].shape[1]
    c_kv, k_rope = attn.window_rows(c_kv, size), attn.window_rows(k_rope,
                                                                  size)
    S = c_kv.shape[1]
    if tp is None:
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope
        return y
    # a rank's slices: its lanes of c_kv, its positions of k_rope
    cache["c_kv"][:, :S] = _lanes(c_kv, cache["c_kv"].shape[-1], tp)
    kr = cache["k_rope"]
    M = kr.shape[1]
    lo, hi = tp.rank * M, min(S, (tp.rank + 1) * M)
    if hi > lo:
        kr[:, :hi - lo] = k_rope[:, lo:hi]
    return y


def _lanes(c: torch.Tensor, width: int, tp) -> torch.Tensor:
    """The rank's lanes of whole latents ``c`` [..., r], where its cache
    holds ``width`` < r of them; ``c`` itself where it holds all."""
    return c if width == c.shape[-1] else c[..., rank_block(c.shape[-1],
                                                           tp)]


def prefill_extend_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                              positions: torch.Tensor,
                              prefix_kv: Dict[str, torch.Tensor],
                              prefix_len: int, flags):
    """The JAX ``mla_prefill_extend``: the prompt suffix attends over the
    cached prefix *latents* ++ its own, re-materialised with the same
    products as a cold prefill (a position's K/V do not depend on its
    neighbours), so the suffix rows are bitwise the cold prefill's.
    Returns (the block's output, the suffix's latents: on a
    tensor-parallel rank its lanes of ``c_kv`` and every position of
    ``k_rope``, which the layout's writer cuts).  ``prefix_kv`` is
    whole."""
    q_nope, q_rope = _project_q(params, cfg, x, positions, flags)
    c_suf, kr_suf = _project_kv_latent(params, cfg, x, positions, flags)
    c_full = torch.cat([prefix_kv["c_kv"].to(c_suf.dtype), c_suf], dim=1)
    kr_full = torch.cat([prefix_kv["k_rope"].to(kr_suf.dtype), kr_suf],
                        dim=1)
    y = _materialised(params, cfg, q_nope, q_rope, c_full, kr_full,
                      prefix_len)
    if flags.tp is not None:
        lanes = cfg.kv_lora_rank // flags.tp.size \
            if cfg.kv_lora_rank % flags.tp.size == 0 else cfg.kv_lora_rank
        c_suf = _lanes(c_suf, lanes, flags.tp)
    return y, {"c_kv": c_suf, "k_rope": kr_suf}


# ---------------------------------------------------------------------------
# decode and verify: weight absorption over the latents
# ---------------------------------------------------------------------------

def _absorbed(params, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope,
              valid: torch.Tensor) -> torch.Tensor:
    """Query ``s`` of row ``b`` over the row's position-ordered latents
    ``c_kv`` [B, T, r] and ``k_rope`` [B, T, rope] where ``valid`` [B,
    S', T]: ``wk_b`` absorbed into the query, ``wv_b`` applied to the
    latent output.  The products and the sum of the two score terms
    run in the model dtype, the softmax in f32, as in JAX."""
    B, Sq, H, _ = q_nope.shape
    T = c_kv.shape[1]
    dt = q_nope.dtype
    q_lat = _per_head(q_nope, params["wk_b"].permute(1, 2, 0))  # [B,S',H,r]
    scores = (torch.bmm(q_lat.reshape(B, Sq * H, -1), c_kv.transpose(1, 2))
              + torch.bmm(q_rope.reshape(B, Sq * H, -1),
                          k_rope.transpose(1, 2)))
    scores = upcast(scores)
    scores = scores * _scale(cfg, scores.dtype)
    scores = torch.where(valid[:, :, None, :], scores.view(B, Sq, H, T),
                         NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    out_lat = torch.bmm(probs.view(B, Sq * H, T), c_kv).view(B, Sq, H, -1)
    out = _per_head(out_lat, params["wv_b"].permute(1, 0, 2))  # [B,S',H,vd]
    return _out_proj(out, params["wo"])


def _window(params, cfg: ArchConfig, x, pos: torch.Tensor, flags):
    """(absolute window positions [B, S'], q_nope, q_rope, the window's
    latents) of a decode or verify window starting at ``pos`` [B]."""
    S_q = x.shape[1]
    pos_s = pos.long()[:, None] + torch.arange(S_q, device=x.device)
    q_nope, q_rope = _project_q(params, cfg, x, pos_s, flags)
    c_new, kr_new = _project_kv_latent(params, cfg, x, pos_s, flags)
    return pos_s, q_nope, q_rope, c_new, kr_new


def _slots(cfg: ArchConfig, pos_s: torch.Tensor, T: int):
    """(the places [B, S'] a window's latents are written to, the places
    [B, S', T] each query sees) in slot rows of ``T``: the positions
    themselves and ``idx <= pos + s``, or in a windowed row slot ``pos %
    T`` and the slots below ``min(pos + 1, T)`` (``attention.
    window_slots``, ``window_valid``).  A verify window over a sliding
    window is refused, as in JAX."""
    if not cfg.sliding_window:
        return pos_s, attn.causal_valid(pos_s, T)
    if pos_s.shape[1] > 1:
        raise ValueError(attn.WINDOW_VERIFY)
    return attn.window_slots(pos_s, T), attn.window_valid(pos_s, T)


def slot_decode(params, cfg: ArchConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                flags) -> torch.Tensor:
    """Decode (S' = 1) or verify (S' > 1) a window against slot rows
    ``[B, size, ...]``: the window's latents land at ``pos .. pos + S' -
    1`` of each row (a windowed row's at ``pos % size``) **in place**
    and query ``s`` attends over ``idx <= pos + s`` (:func:`_slots`).
    Window positions at or past ``size`` (an inactive row's stray
    window) are not written, as JAX drops such writes.  Returns the
    block's output."""
    if flags.tp is not None:
        return tp_decode(params, cfg, x, cache, pos, None, flags)
    B, T, _ = cache["c_kv"].shape
    pos_s, q_nope, q_rope, c_new, kr_new = _window(params, cfg, x, pos,
                                                   flags)
    wpos, valid = _slots(cfg, pos_s, T)
    rows = torch.arange(B, device=x.device)
    for s in range(x.shape[1]):
        # one write per row, so no index repeats within a write; a
        # position past the row writes back what its last slot holds
        idx = wpos[:, s].clamp(max=T - 1)
        keep = (wpos[:, s] < T)[:, None]
        for key, new in (("c_kv", c_new), ("k_rope", kr_new)):
            leaf = cache[key]
            leaf[rows, idx] = torch.where(keep, new[:, s].to(leaf.dtype),
                                          leaf[rows, idx])
    return _absorbed(params, cfg, q_nope, q_rope, cache["c_kv"],
                     cache["k_rope"], valid)


def paged_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                 tables: torch.Tensor, flags) -> torch.Tensor:
    """The JAX ``_mla_paged_decode``: the window's latents scattered into
    each row's tail block(s) **in place**, then the pages gathered back
    into position order (exactly the slot row), so the arithmetic is
    the slot layout's at ``max_len = P * block_size``.  Rows whose table
    entry is the trash block 0 write there harmlessly; their output is
    unspecified, and window positions past the row's pages write the
    trash block."""
    if flags.tp is not None:
        return tp_decode(params, cfg, x, cache, pos, tables, flags)
    bs = cache["c_kv"].shape[1]
    T = tables.shape[1] * bs
    pos_s, q_nope, q_rope, c_new, kr_new = _window(params, cfg, x, pos,
                                                   flags)
    blk, off = paging.tail_refs(tables, pos_s.clamp(max=T - 1), bs)
    blk = torch.where(pos_s < T, blk, 0)
    paging.scatter_token(cache["c_kv"], blk, off, c_new)
    paging.scatter_token(cache["k_rope"], blk, off, kr_new)
    c_seq = paging.gather_pages(cache["c_kv"], tables)
    kr_seq = paging.gather_pages(cache["k_rope"], tables)
    return _absorbed(params, cfg, q_nope, q_rope, c_seq, kr_seq,
                     attn.causal_valid(pos_s, T))


# ---------------------------------------------------------------------------
# a tensor-parallel rank: heads, lora lanes and rope positions
# ---------------------------------------------------------------------------

def partial(params, cfg: ArchConfig, tp) -> bool:
    """Whether a rank's MLA output is its heads' part of a sum."""
    return tp is not None and params["wo"].shape[0] < cfg.num_heads


def tp_decode(params, cfg: ArchConfig, x: torch.Tensor,
              cache: Dict[str, torch.Tensor], pos: torch.Tensor,
              tables, flags) -> torch.Tensor:
    """Absorbed decode or verify of a window on a tensor-parallel rank,
    over slot rows (``tables`` None: a row is one block of its slots) or
    a paged arena: the window's latents land in the rank's slices **in
    place** (``attention.write_window``; a windowed row's at ``pos %
    size``, :func:`_slots`), then each score is the
    sum, in f32 over the ranks in rank order, of every rank's lora
    lanes' product and the rope product of the rank that holds the
    position.  Returns the rank's heads' part of the block's output (the
    whole output where the heads are whole)."""
    tp = flags.tp
    B, S_q = x.shape[:2]
    pos_s, q_nope, q_rope, c_new, kr_new = _window(params, cfg, x, pos,
                                                   flags)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    if tables is None:
        tables = attn.row_tables(B, x.device)
    block = c_kv.shape[1]
    loc = k_rope.shape[1]
    r_l = c_kv.shape[-1]
    T = tables.shape[1] * block
    wpos, valid = _slots(cfg, pos_s, T)
    attn.write_window((c_kv,), (_lanes(c_new, r_l, tp),), tables, wpos,
                      block)
    attn.write_window((k_rope,), (kr_new,), tables, wpos, block,
                      tp if loc < block else None)
    c_seq = paging.gather_pages(c_kv, tables)                 # [B, T, r_l]
    kr_seq = paging.gather_pages(k_rope, tables)              # [B, T', rope]
    H, H_l = cfg.num_heads, q_nope.shape[2]
    h0 = 0 if H_l == H else tp.rank * H_l
    q_lat = _per_head(q_nope, params["wk_b"].permute(1, 2, 0))  # [B,S',H_l,r]
    if H_l < H:
        idx = torch.arange(h0, h0 + H_l, device=x.device)
        q_lat, q_rope = tp_reduce_parts(
            [placed(q_lat, 2, idx, H), placed(q_rope, 2, idx, H)], tp)
    dt = q_nope.dtype
    lora_cut = r_l < cfg.kv_lora_rank
    ql = q_lat[..., rank_block(cfg.kv_lora_rank, tp)] if lora_cut else q_lat
    lora = _row_bmm(ql.reshape(B, S_q * H, r_l), c_seq.transpose(1, 2))
    rope = _row_bmm(q_rope.reshape(B, S_q * H, -1), kr_seq.transpose(1, 2))
    part = upcast(lora) if lora_cut or tp.rank == 0 \
        else torch.zeros_like(upcast(lora))
    if loc < block:
        part = part + placed(upcast(rope), 2, attn.seq_positions(
            tables, loc, block, tp), T)
    elif tp.rank == 0:
        part = part + upcast(rope)
    scores = tp.all_reduce(part)
    scores = scores * _scale(cfg, scores.dtype)
    scores = torch.where(valid[:, :, None, :], scores.view(B, S_q, H, T),
                         NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    out_lat = _row_bmm(probs.view(B, S_q * H, T), c_seq).view(B, S_q, H, r_l)
    if lora_cut:
        out_lat = tp_reduce_parts([placed(out_lat, 3, own_range(
            r_l, tp, x.device), cfg.kv_lora_rank)], tp)[0]
    out = _per_head(out_lat[:, :, h0:h0 + H_l],
                    params["wv_b"].permute(1, 0, 2))         # [B,S',H_l,vd]
    return _out_proj(out, params["wo"])


def _row_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` one row at a time (``each_row``)."""
    return each_row(torch.bmm, a, b)
