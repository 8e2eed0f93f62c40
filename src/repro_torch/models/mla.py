"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437): the port
of the JAX package's ``models/mla.py`` (its sequence-parallel prefill is
ROADMAP Queue 1 item 11c, MLA on a serving mesh item 11b-ii).

Keys and values are compressed into a latent ``c_kv`` (rank
``kv_lora_rank``) plus one shared RoPE key per position, and the caches
hold only those: ``c_kv`` ``[B, max_len, r]`` and ``k_rope`` ``[B,
max_len, rope]`` in slot rows, ``[num_blocks, block_size, ...]`` arenas
on the paged layout.  Prefill and extend materialise per-head K/V from
the latents and attend through ``chunked_attention``; decode and verify
windows use weight absorption: the queries go into latent space and
attend over the latents themselves.  Caches are written in place.

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
* Decode and verify are capturable as CUDA graphs: masks come from
  tensor comparisons and ``torch.where``, cache writes are
  ``index_put_``, and nothing waits for the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels.ref import NEG_INF, two_rows, upcast
from . import paging
from .chunked_attention import chunked_attention
from .config import ArchConfig
from .layers import apply_rope, linear, rms_norm
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
    """Slot rows of latents (the JAX ``abstract_mla_cache``; sliding
    windows are refused by ``check_supported``)."""
    return _latents(cfg, (batch, max_len))


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
        B, T, cfg.num_heads, k_rope.shape[-1])], dim=-1)
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


def prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor,
                       cache: Dict[str, torch.Tensor], flags) -> torch.Tensor:
    """The JAX ``mla_prefill_into_cache``: attend over the prompt and
    write its latents into positions ``[0, S)`` of ``cache`` (zero
    beyond) **in place**.  Returns the block's output."""
    y, c_kv, k_rope = mla_forward(params, cfg, x, positions, flags)
    S = x.shape[1]
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    return y


def prefill_extend_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                              positions: torch.Tensor,
                              prefix_kv: Dict[str, torch.Tensor],
                              prefix_len: int, flags):
    """The JAX ``mla_prefill_extend``: the prompt suffix attends over the
    cached prefix *latents* ++ its own, re-materialised with the same
    products as a cold prefill (a position's K/V do not depend on its
    neighbours), so the suffix rows are bitwise the cold prefill's.
    Returns (the block's output, the suffix's latents)."""
    q_nope, q_rope = _project_q(params, cfg, x, positions, flags)
    c_suf, kr_suf = _project_kv_latent(params, cfg, x, positions, flags)
    c_full = torch.cat([prefix_kv["c_kv"].to(c_suf.dtype), c_suf], dim=1)
    kr_full = torch.cat([prefix_kv["k_rope"].to(kr_suf.dtype), kr_suf],
                        dim=1)
    y = _materialised(params, cfg, q_nope, q_rope, c_full, kr_full,
                      prefix_len)
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


def slot_decode(params, cfg: ArchConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                flags) -> torch.Tensor:
    """Decode (S' = 1) or verify (S' > 1) a window against slot rows
    ``[B, max_len, ...]``: the window's latents land at ``pos .. pos +
    S' - 1`` of each row **in place** and query ``s`` attends over
    ``idx <= pos + s``.  Window positions at or past ``max_len`` (an
    inactive row's stray window) are not written, as JAX drops such
    writes.  Returns the block's output."""
    B, T, _ = cache["c_kv"].shape
    pos_s, q_nope, q_rope, c_new, kr_new = _window(params, cfg, x, pos,
                                                   flags)
    rows = torch.arange(B, device=x.device)
    for s in range(x.shape[1]):
        # one write per row, so no index repeats within a write; a
        # position past the row writes back what its last slot holds
        idx = pos_s[:, s].clamp(max=T - 1)
        keep = (pos_s[:, s] < T)[:, None]
        for key, new in (("c_kv", c_new), ("k_rope", kr_new)):
            leaf = cache[key]
            leaf[rows, idx] = torch.where(keep, new[:, s].to(leaf.dtype),
                                          leaf[rows, idx])
    valid = torch.arange(T, device=x.device)[None, None, :] \
        <= pos_s[:, :, None]
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
    valid = torch.arange(T, device=x.device)[None, None, :] \
        <= pos_s[:, :, None]
    return _absorbed(params, cfg, q_nope, q_rope, c_seq, kr_seq, valid)
