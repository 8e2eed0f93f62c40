"""GQA attention with RoPE, optional qk-norm (qwen3) and sliding
windows, over a KV cache in one of two layouts: contiguous slot rows
``[B, max_len, KV, hd]`` or a paged block-pool arena ``[num_blocks,
block_size, KV, hd]`` reached through block tables (block 0 is the
trash block).  Plain functions on tensors in the JAX package's layouts:
``wq`` is [d, H, hd].

Prefill and the extend suffix run the flash-attention op (K3), decode
and verify windows the fused flash-decode op (K2, or K4 with
``fused_split_k``); the paged layout's single-query arm runs the
paged-attention op (K5, ``use_paged_kernel``).  With a kernel flag
turned off the plain version runs instead, on any device.  Caches are
written in place.

A layer with a sliding window keeps slot rows of ``min(max_len,
window)`` positions that wrap: position ``p`` lives in slot ``p %
size`` (:func:`cache_len`).  Prefill attends through K3's window mask
and keeps the prompt's last ``size`` positions so rotated; decode runs
the JAX package's gather path in plain PyTorch (:func:`window_decode`):
the new K/V land at ``pos % size`` and the query attends over every
slot below ``min(pos + 1, size)``.  The softmax over slots does not
depend on their order, so no position-ordered view is needed.  As in
JAX, windowed layers take neither the fused decode ops nor a speculative
verify window, and have no paged layout.

On a tensor-parallel rank K/V lie on the rank's kv heads, or, where the
ranks do not divide them, on its lanes of head_dim, or else on its
positions (:func:`kv_arm`, the rules' ``_kv_cache_axes``).  The query
heads and ``wo`` are the rank's where the ranks divide the heads, else
whole.  Prefill and extend compute K/V whole (``wk``/``wv`` are whole
off the kv-heads arm), attend through K3 on the rank's heads over the
whole K/V (an extend gathers its prefix whole first) and store the
rank's slice.  Decode and verify windows on the head_dim and sequence
arms run the plain attention of :func:`tp_decode`, as JAX runs its
``_decode_attention_hd_sharded``: K2/K4 fuse only on the kv-heads arm.

The full-sequence arm without a cache (``attention_forward``, the
training ``forward``'s) dispatches as the JAX ``_seq_attention`` does:
``"flash"`` through the flash-attention op (K3, no backward: it runs
under ``torch.no_grad`` only), ``"chunked"`` through the plain
``chunked_attention`` or ``"naive"`` through a masked softmax over the
whole sequence.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import (NEG_INF, flash_attention_ref,
                           fused_flash_decode_ref, gathered_attention,
                           heads_major, keys_t, two_rows, upcast, values)
from ..sharding.group import (own_range, placed, rank_block,
                              tp_reduce_parts)
from . import paging
from .chunked_attention import chunked_attention
from .config import ArchConfig
from .layers import apply_rope, each_row, linear, rms_norm
from .params import ParamSpec, Template


def attention_template(cfg: ArchConfig) -> Template:
    d, hd = cfg.d_model, cfg.head_dim
    t: Template = {
        "wq": ParamSpec((d, cfg.num_heads, hd),
                        ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.num_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.num_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.num_heads, hd, d),
                        ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = {"scale": ParamSpec((hd,), ("head_dim",),
                                         init="ones")}
        t["k_norm"] = {"scale": ParamSpec((hd,), ("head_dim",),
                                         init="ones")}
    return t


#: the JAX package's refusal of a verify window over a sliding window
WINDOW_VERIFY = ("multi-token (speculative) decode does not support "
                 "sliding-window attention")


def cache_len(cfg: ArchConfig, max_len: int) -> int:
    """The positions a slot row of an attention layer holds: the window's
    ``min(max_len, window)`` where the layer has one, else ``max_len``
    (the JAX ``init_kv_cache`` and MLA's ``_cache_size``)."""
    w = cfg.sliding_window or 0
    return min(max_len, w) if w else max_len


def kv_cache_shape(cfg: ArchConfig, batch: int,
                   max_len: int) -> Tuple[int, ...]:
    return (batch, cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)


def paged_kv_cache_shape(cfg: ArchConfig, num_blocks: int,
                         block_size: int) -> Tuple[int, ...]:
    """The paged arena (the JAX ``abstract_paged_kv_cache``): the slot
    axis is replaced by a pool of fixed-size token blocks shared by all
    sequences (block 0 = trash)."""
    return (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one product: [B,S,d] @ [d, h*k]."""
    d, h, k = w.shape
    return linear(x, w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one product."""
    h, k, d = wo.shape
    return linear(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def _qkv(params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
         rope: bool = True):
    """Project q/k/v (+ qk-norm).  ``rope=False`` returns un-rotated q/k
    for the fused decode op, which applies the same rotation itself at
    the same positions."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,hd], k/v: [B,T,KV,hd], mask: broadcastable to
    [B,KV,G,S,T].  The JAX ``_grouped_attention``: f32 scores, softmax,
    probabilities in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(hd)))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def causal_mask(seq: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    m = j <= i
    if window:
        m = m & (j > i - window)
    return m[None, None, None]      # [1,1,1,S,T]


def seq_attention(q, k, v, cfg: ArchConfig, impl: str) -> torch.Tensor:
    """Causal attention over a whole sequence by ``impl``: "flash" (the
    flash-attention op, K3), "chunked" or "naive" (the JAX
    ``_seq_attention``)."""
    if impl == "flash":
        return ops.flash_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window)
    if impl != "naive":
        raise ValueError(f"unknown attention impl {impl!r}")
    return grouped_attention(q, k, v, causal_mask(
        q.shape[1], cfg.sliding_window, q.device))


def attention_forward(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, impl: str) -> torch.Tensor:
    """The no-cache arm of the JAX ``attention_apply``: x [B, S, d] at
    ``positions`` [B, S] -> the attention block's output [B, S, d]."""
    q, k, v = _qkv(params, cfg, x, positions)
    return _out_proj(seq_attention(q, k, v, cfg, impl), params["wo"])


def window_rows(a: torch.Tensor, size: int) -> torch.Tensor:
    """A prompt's rows ``a`` [B, S, ...] as a cache row of ``size``
    positions keeps them from slot 0 on: all of them where ``S < size``
    (the rest of the row stays zero), else the last ``size`` rotated so
    that position ``p`` sits in slot ``p % size`` (the JAX prefill's
    ``jnp.roll``; the identity at ``S == size``)."""
    S = a.shape[1]
    if S < size:
        return a
    return torch.roll(a[:, S - size:], (S - size) % size, dims=1)


def prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                       flags) -> torch.Tensor:
    """Run causal attention over the prompt (with the layer's window
    mask) and write its rotated K and its V into ``cache`` ([B, size,
    KV, hd]; a rank's slice of it) **in place**: positions ``[0, S)``,
    zero beyond, or past a window's ``size`` the last ``size`` positions
    wrapped (:func:`window_rows`).  Returns the attention block's output
    (a rank's part of it, :func:`partial`)."""
    q, k, v = _qkv(params, cfg, x, positions)
    attend = ops.flash_attention if flags.use_flash else flash_attention_ref
    arm = kv_arm(cfg, flags.tp)
    h0 = rank_head0(params, cfg, flags.tp)
    kh, vh = kv_for_heads(k, v, cfg, h0, q.shape[2])
    out = attend(q, kh, vh, causal=True, window=cfg.sliding_window)
    size = cache["k"].shape[1] * (flags.tp.size if arm == "seq" else 1)
    for key, a in (("k", k), ("v", v)):
        store_rows(cache[key], window_rows(a, size), 0, arm, flags.tp)
    return tp_out_proj(out, params, cfg, arm, flags.tp, h0)


def window_slots(pos_s: torch.Tensor, size: int) -> torch.Tensor:
    """The slots [B, S'] of a windowed row of ``size`` that positions
    ``pos_s`` are written to: ``pos % size``.  A negative position (a
    stray row of a replay call, ``SlotBackend._stray_position``) maps to
    ``size``, which no write reaches: every slot of a row past its
    window holds a position the row still reads."""
    return torch.where(pos_s >= 0, pos_s % size, size)


def window_valid(pos_s: torch.Tensor, size: int) -> torch.Tensor:
    """[B, S', size] the slots a query at position ``pos_s`` [B, S']
    sees in its windowed row: those below ``min(pos + 1, size)`` (JAX's
    wraparound mask; none for a negative position)."""
    idx = torch.arange(size, device=pos_s.device)
    return idx < torch.clamp(pos_s + 1, max=size)[..., None]


def causal_valid(pos_s: torch.Tensor, total: int) -> torch.Tensor:
    """[B, S', total] the positions of a position-ordered row a query at
    ``pos_s`` [B, S'] sees: ``idx <= pos``."""
    return torch.arange(total, device=pos_s.device) <= pos_s[..., None]


def window_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                  flags) -> torch.Tensor:
    """Decode one token of a windowed layer against its slot rows [B,
    size, KV, hd], the JAX gather path in plain PyTorch on every device
    (JAX runs windowed layers outside its fused decode kernel): the
    rotated K and V land at slot ``pos % size`` **in place**
    (:func:`window_slots`), and the query attends over the slots below
    ``min(pos + 1, size)``, each row on its own (``layers.each_row``),
    so a row's bits do not depend on the batch.  Every mask and index
    is computed on the device, so the step captures as a CUDA graph.  A
    verify window is refused, as in JAX.  Returns the attention block's
    output (on a kv-heads rank its heads' part)."""
    B, S_q = x.shape[:2]
    if S_q > 1:
        raise ValueError(WINDOW_VERIFY)
    pos_s = pos.long()[:, None]
    q, k, v = _qkv(params, cfg, x, pos_s)
    size = cache["k"].shape[1]
    write_window((cache["k"], cache["v"]), (k, v), row_tables(B, x.device),
                 window_slots(pos_s, size), size)
    out = each_row(lambda q_, k_, v_, m_: sharded_attention(
        q_, k_, v_, m_, cfg.head_dim, "whole", None),
        q, cache["k"], cache["v"], window_valid(pos_s, size))
    return _out_proj(out.to(x.dtype), params["wo"])


def fused_slot_decode(params, cfg: ArchConfig, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                      tables: torch.Tensor, freqs: torch.Tensor,
                      flags) -> torch.Tensor:
    """Decode (S' = 1) or verify (S' = 1 + k) a window against the
    contiguous slot cache through the fused flash-decode op.

    The ``[B, max_len, KV, hd]`` cache is viewed (free) as a
    position-ordered arena of ``max_len // page`` blocks per row with
    ``tables`` from ``paging.slot_arena_tables``; q/k/v go in un-rotated
    and the op rotates them at ``pos .. pos + S' - 1``, writes the window
    into the cache **in place** and attends query ``s`` over
    ``idx <= pos + s``.  Returns the attention block's output."""
    q, k, v = _qkv(params, cfg, x, None, rope=False)
    B, S, KV, hd = cache["k"].shape
    page = paging.fused_page_size(S)
    k_arena = cache["k"].view(B * (S // page), page, KV, hd)
    v_arena = cache["v"].view(B * (S // page), page, KV, hd)
    out = _fused_call(cfg, flags)(q, k, v, k_arena, v_arena, tables, pos,
                                  freqs)
    return _out_proj(out, params["wo"])


def _fused_call(cfg: ArchConfig, flags):
    """The fused decode op of ``flags``: K2, K4 (``fused_split_k``), or
    their plain version when ``use_fused_decode`` is off."""
    if not paging.use_fused_decode(cfg, flags):
        return fused_flash_decode_ref
    return functools.partial(ops.fused_flash_decode,
                             split_k=flags.fused_split_k)


def paged_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                 tables: torch.Tensor, freqs: torch.Tensor,
                 flags) -> torch.Tensor:
    """Decode one (or, speculatively, S') token(s) against a paged arena
    ``[NB, bs, KV, hd]``, written **in place**; the three arms of the
    JAX ``_paged_decode``:

    * fused (``use_fused_decode``): q/k/v un-rotated into one fused
      flash-decode call (K2, or K4 with ``fused_split_k``) that rotates
      at ``pos .. pos + S' - 1``, scatters the window into each row's
      tail block(s) and attends query ``s`` over ``idx <= pos + s``;
    * paged kernel (``use_paged_kernel``, S' = 1): the rotated token is
      scattered into its tail block, then K5 reads the row through its
      table;
    * gather: scatter, then the pages gathered back into position order
      (exactly the contiguous row) and the plain attention.

    Rows whose table entry is the trash block 0 (inactive slots, window
    positions past the row's pages) write there harmlessly; their
    output is unspecified.  Returns the attention block's output."""
    S_q = x.shape[1]
    if paging.use_fused_decode(cfg, flags):
        q, k, v = _qkv(params, cfg, x, None, rope=False)
        out = _fused_call(cfg, flags)(q, k, v, cache["k"], cache["v"], tables,
                                      pos, freqs)
        return _out_proj(out, params["wo"])
    pos_s = pos.long()[:, None] + torch.arange(S_q, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos_s)
    bs = cache["k"].shape[1]
    blk, off = paging.tail_refs(tables, pos_s, bs)
    paging.scatter_token(cache["k"], blk, off, k)
    paging.scatter_token(cache["v"], blk, off, v)
    if S_q == 1 and flags.use_paged_kernel:
        out = ops.paged_attention(q[:, 0], cache["k"], cache["v"], tables,
                                  pos)[:, None]
    else:
        k_seq = paging.gather_pages(cache["k"], tables)
        v_seq = paging.gather_pages(cache["v"], tables)
        out = gathered_attention(q, upcast(k_seq), upcast(v_seq),
                                 pos_s).to(q.dtype)
    return _out_proj(out, params["wo"])


def prefill_extend_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                              positions: torch.Tensor,
                              prefix_kv: Dict[str, torch.Tensor],
                              prefix_len: int, flags):
    """Prefill only the prompt *suffix*, attending over cached prefix K/V.

    x: [B, S'] suffix hidden states at positions ``prefix_len ..
    prefix_len + S' - 1``; prefix_kv: k/v of positions ``0 ..
    prefix_len - 1`` gathered from the cache (whole, on a rank whose
    K/V are cut on head_dim or the sequence).  The suffix queries attend
    over prefix ++ suffix through the flash op at ``q_offset =
    prefix_len`` (K3), or its plain version when ``use_flash`` is off;
    both partition the keys at absolute multiples of 128, so the suffix
    rows — and the first generated token — are bitwise equal to a cold
    prefill of the whole prompt.  Returns (the attention block's output,
    the suffix's rotated K and its V, [B, S', KV, hd]: on the head_dim
    arm the rank's lanes, on the sequence arm every position)."""
    q, k, v = _qkv(params, cfg, x, positions)
    k_full = torch.cat([prefix_kv["k"].to(k.dtype), k], dim=1)
    v_full = torch.cat([prefix_kv["v"].to(v.dtype), v], dim=1)
    attend = ops.flash_attention if flags.use_flash else flash_attention_ref
    arm = kv_arm(cfg, flags.tp)
    h0 = rank_head0(params, cfg, flags.tp)
    k_full, v_full = kv_for_heads(k_full, v_full, cfg, h0, q.shape[2])
    out = attend(q, k_full, v_full, causal=True, window=cfg.sliding_window,
                 q_offset=prefix_len)
    if arm == "head_dim":
        lanes = rank_block(cfg.head_dim, flags.tp)
        k, v = k[..., lanes], v[..., lanes]
    return tp_out_proj(out, params, cfg, arm, flags.tp, h0), \
        {"k": k, "v": v}


# ---------------------------------------------------------------------------
# a tensor-parallel rank: K/V on kv heads, on head_dim or on the sequence
# ---------------------------------------------------------------------------

def kv_arm(cfg: ArchConfig, tp) -> str:
    """Where a rank's slice of K/V lies, in the order of the rules'
    ``_kv_cache_axes``: ``"heads"`` (its kv heads), ``"head_dim"`` (its
    lanes of every kv head), ``"seq"`` (its positions: a contiguous range
    of a slot row, its offsets of every block of a paged arena); off a
    mesh ``"whole"``."""
    if tp is None:
        return "whole"
    if cfg.num_kv_heads % tp.size == 0:
        return "heads"
    if cfg.head_dim % tp.size == 0:
        return "head_dim"
    return "seq"


def partial(params, cfg: ArchConfig, tp) -> bool:
    """Whether a rank's attention output is its part of a sum over the
    ranks: its heads (``wo`` cut), or, with the heads whole on the
    head_dim arm, its lanes of every head through their rows of ``wo``.
    Otherwise it is the whole output on every rank."""
    return tp is not None and (params["wo"].shape[0] < cfg.num_heads
                               or kv_arm(cfg, tp) == "head_dim")


def rank_head0(params, cfg: ArchConfig, tp) -> int:
    """The first of the query heads a rank computes (``wq``'s heads)."""
    H_l = params["wq"].shape[1]
    return 0 if tp is None or H_l == cfg.num_heads else tp.rank * H_l


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, h0: int,
                 H_l: int):
    """Whole K/V [B, T, KV, hd] narrowed to the kv heads of the ``H_l``
    query heads from ``h0``: their groups where the heads cover whole
    groups, else one kv head a query head.  Untouched where the heads
    are whole, or the K/V already the rank's kv heads."""
    KV = k.shape[2]
    if H_l == cfg.num_heads or KV < cfg.num_kv_heads:
        return k, v
    G = cfg.num_heads // KV
    if H_l % G == 0:
        sl = slice(h0 // G, (h0 + H_l) // G)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(h0, h0 + H_l, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def all_heads(x: torch.Tensor, num_heads: int, h0: int, tp) -> torch.Tensor:
    """``x`` [B, S, H_l, ...] of the rank's heads from ``h0`` as every
    head's [B, S, H, ...] (one exact all-reduce); as it is when whole."""
    if x.shape[2] == num_heads:
        return x
    idx = torch.arange(h0, h0 + x.shape[2], device=x.device)
    return tp_reduce_parts([placed(x, 2, idx, num_heads)], tp)[0]


def tp_out_proj(out: torch.Tensor, params, cfg: ArchConfig, arm: str, tp,
                h0: int) -> torch.Tensor:
    """The output projection of ``out`` [B, S, H', hd'] (the rank's heads
    or every head; every lane, or the rank's lanes on the head_dim arm)
    on the rank's ``wo``: its heads' part of the sum, or with the heads
    whole its lanes' part on the head_dim arm (:func:`partial`), or the
    whole output."""
    wo = params["wo"]
    H_l, hd = wo.shape[0], wo.shape[1]
    if arm == "head_dim" and H_l == cfg.num_heads:
        lanes = rank_block(hd, tp)
        if out.shape[-1] == hd:
            out = out[..., lanes]
        return _out_proj(out, wo[:, lanes])
    if out.shape[-1] < hd:                       # lanes: gather them whole
        out = tp_reduce_parts([placed(out, 3, own_range(
            out.shape[-1], tp, out.device), hd)], tp)[0]
    if out.shape[2] > H_l:
        out = out[:, :, h0:h0 + H_l]
    return _out_proj(out, wo)


def rank_slice(a: torch.Tensor, arm: str, tp) -> torch.Tensor:
    """A rank's slice of whole K/V [..., T, KV, hd] on ``arm``: its lanes
    (head_dim) or its contiguous range of the T positions (seq); as it
    is on the kv-heads arm (computed with the rank's ``wk``/``wv``)."""
    if arm == "head_dim":
        return a[..., rank_block(a.shape[-1], tp)]
    if arm == "seq":
        n = a.shape[-3] // tp.size
        return a.narrow(-3, tp.rank * n, n)
    return a


def store_rows(leaf: torch.Tensor, new: torch.Tensor, offset: int, arm: str,
               tp) -> None:
    """Write whole K/V rows ``new`` [B, S, KV, hd] at positions ``offset
    ..`` of slot rows ``leaf`` [B, M', KV, hd'] (a rank's slice), in
    place: the rank's lanes, or on the sequence arm the positions of its
    contiguous range ``[r M', (r + 1) M')``."""
    S = new.shape[1]
    if arm == "head_dim":
        new = new[..., rank_block(new.shape[-1], tp)]
    if arm != "seq":
        leaf[:, offset:offset + S] = new
        return
    M = leaf.shape[1]
    lo = max(offset, tp.rank * M)
    hi = min(offset + S, (tp.rank + 1) * M)
    if hi > lo:
        leaf[:, lo - tp.rank * M:hi - tp.rank * M] = new[:, lo - offset:
                                                         hi - offset]


def write_window(leaves, news, tables: torch.Tensor, pos_s: torch.Tensor,
                 block: int, seq_tp=None) -> None:
    """Write a decode or verify window's entries ``news`` ([B, S', ...]
    each) into ``leaves`` ([NB, block', ...] arenas reached through
    ``tables`` [B, P], blocks of ``block`` positions) at ``pos_s`` [B,
    S'], in place, one window position at a time (no index repeats
    within a write).  Positions at or past the table's end are not
    written.  With ``seq_tp`` the arenas hold the rank's offsets of
    every block, ``block' = block / tp``, and only the rank's positions
    are written; a position not written writes back what its place
    holds."""
    T = tables.shape[1] * block
    loc = leaves[0].shape[1]
    tables = tables.long()
    for s in range(pos_s.shape[1]):
        g = pos_s[:, s]
        gc = g.clamp(max=T - 1)
        blk = torch.gather(tables, 1, (gc // block)[:, None])[:, 0]
        off = gc % block
        own = g < T
        if seq_tp is not None:
            own = own & (off // loc == seq_tp.rank)
            off = (off - seq_tp.rank * loc).clamp(0, loc - 1)
        for leaf, new in zip(leaves, news):
            cur = leaf[blk, off]
            keep = own.view((-1,) + (1,) * (cur.dim() - 1))
            leaf[blk, off] = torch.where(keep, new[:, s].to(leaf.dtype), cur)


def _row_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for [B, n, M, K] and [B, n, K, N], one row at a time
    (``each_row``): a row's product has a batch of one's shapes, so its
    bits do not follow the batch it rides in."""
    return each_row(lambda x, y: torch.bmm(x[0], y[0])[None], a, b)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, KV, G, S, T] products of q [B, S, H, d] and k [B, T, KV, d],
    in k's dtype, before the scale."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb = heads_major(q.to(k.dtype).reshape(B, S, KV, G, d))
    s = _row_bmm(qb.view(B, KV, G * S, d), keys_t(k).view(B, KV, d, T))
    return s.view(B, KV, G, S, T)


def _weighted(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, KV, G, S, d] sums of probabilities p [B, KV, G, S, T] over
    values v [B, T, KV, d]."""
    B, KV, G, S, T = p.shape
    d = v.shape[-1]
    o = _row_bmm(p.reshape(B, KV, G * S, T), values(v).view(B, KV, T, d))
    return o.view(B, KV, G, S, d)


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, head_dim: int, arm: str, tp,
                      gpos: Optional[torch.Tensor] = None,
                      total: int = 0) -> torch.Tensor:
    """Decode attention of every query head q [B, S', H, hd] (rotated)
    over a rank's slice of the K/V [B, T', KV, .] of a row, query ``s``
    of row ``b`` over the places ``valid[b, s]`` [B, S', T] marks (the
    row's positions ``<= pos``, or a windowed row's live slots), in f32:

    * ``head_dim``: k and v are the rank's lanes, and so is q from here
      on.  The partial scores
      are summed over the ranks in f32 (one all-reduce of the small
      [B, KV, G, S', T] tensor), the softmax sees whole scores, the value
      contraction stays local: returns the rank's lanes of the output;
    * ``seq``: k and v hold the rank's places ``gpos`` [T'] of
      ``total``.  The rank's scores are gathered into the whole row (an
      exact all-reduce) for one softmax, each rank weighs its own values
      and the parts are summed (one all-reduce): returns the whole
      output;
    * ``whole`` (or ``heads``): k and v are whole (the rank's kv heads,
      with q the rank's query heads): no collective.

    The JAX ``_decode_attention_hd_sharded`` for the first; its
    arithmetic is ``ref.gathered_attention``'s with the sums split.
    Returns [B, S', H, .] unrounded."""
    if arm == "head_dim":
        q = q[..., rank_block(head_dim, tp)]
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    one = Sq * G == 1
    qf = upcast(two_rows(q, 1) if one else q)
    valid = two_rows(valid, 1) if one else valid
    kf, vf = upcast(k), upcast(v)
    scale = 1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=kf.dtype))
    s = _scores(qf, kf)
    if arm == "head_dim":
        s = tp.all_reduce(s) * scale
    elif arm == "seq":
        s = tp_reduce_parts([placed(s * scale, 4, gpos, total)], tp)[0]
    else:
        s = s * scale
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if arm == "seq":
        o = tp.all_reduce(_weighted(p.index_select(-1, gpos), vf))
    else:
        o = _weighted(p, vf)
    o = o / p.sum(dim=-1)[..., None]
    Sp = qf.shape[1]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sp, H, -1)[:, :Sq]


def row_tables(B: int, device) -> torch.Tensor:
    """Block tables [B, 1] presenting ``B`` slot rows as an arena of one
    block a row."""
    return torch.arange(B, dtype=torch.int32, device=device)[:, None]


def seq_positions(tables: torch.Tensor, loc: int, block: int,
                  tp) -> torch.Tensor:
    """The absolute positions [P * loc] of a sequence-arm rank's gathered
    pages (``paging.gather_pages`` of arenas holding the rank's ``loc``
    offsets of every block of ``block``)."""
    P = tables.shape[1]
    page = torch.arange(P, device=tables.device)[:, None] * block
    off = own_range(loc, tp, tables.device)[None, :]
    return (page + off).reshape(-1)


def tp_decode(params, cfg: ArchConfig, x: torch.Tensor,
              cache: Dict[str, torch.Tensor], pos: torch.Tensor,
              tables: Optional[torch.Tensor], flags) -> torch.Tensor:
    """Decode (S' = 1) or verify (S' > 1) a window on a rank whose K/V
    are cut on head_dim or on the sequence (:func:`kv_arm`), on slot
    rows (``tables`` None: each row one block of its ``size``) or a
    paged arena: the window's rotated K/V land in the rank's slice **in
    place** (:func:`write_window`; a windowed row at ``pos % size``),
    the rank's query heads are gathered into every head's (one
    all-reduce where they are cut), and every query attends over the
    rank's slice (:func:`sharded_attention`) under the causal mask, or a
    windowed row's slot mask (the softmax does not depend on the slots'
    order).  Returns the rank's part of the block's output, or the
    whole (:func:`partial`)."""
    tp = flags.tp
    arm = kv_arm(cfg, tp)
    B, S_q = x.shape[:2]
    if cfg.sliding_window and S_q > 1:
        raise ValueError(WINDOW_VERIFY)
    pos_s = pos.long()[:, None] + torch.arange(S_q, device=x.device)
    q, k, v = _qkv(params, cfg, x, pos_s)
    if tables is None:
        tables = row_tables(B, x.device)
    loc = cache["k"].shape[1]
    block = loc * tp.size if arm == "seq" else loc
    T = tables.shape[1] * block
    if arm == "head_dim":
        lanes = rank_block(cfg.head_dim, tp)
        k, v = k[..., lanes], v[..., lanes]
    wpos = window_slots(pos_s, T) if cfg.sliding_window else pos_s
    write_window((cache["k"], cache["v"]), (k, v), tables, wpos, block,
                 tp if arm == "seq" else None)
    k_seq = paging.gather_pages(cache["k"], tables)
    v_seq = paging.gather_pages(cache["v"], tables)
    h0 = rank_head0(params, cfg, tp)
    q = all_heads(q, cfg.num_heads, h0, tp)
    valid = window_valid(pos_s, T) if cfg.sliding_window \
        else causal_valid(pos_s, T)
    out = sharded_attention(q, k_seq, v_seq, valid, cfg.head_dim, arm, tp,
                            seq_positions(tables, loc, block, tp), T)
    return tp_out_proj(out.to(x.dtype), params, cfg, arm, tp, h0)


# ---------------------------------------------------------------------------
# a training rank (ROADMAP item 11c-i): the arms of the JAX
# ``sequence_parallel_attention`` under autograd
# ---------------------------------------------------------------------------

def mesh_attention(params, cfg: ArchConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor], flags, *,
                   causal: bool = True, window: Optional[int] = None,
                   memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention block of a training rank (``flags.train``): x [B, S,
    d], the same on every rank of the model line, in; the block's whole
    output out, the same on every rank.  The arm is the JAX
    ``sequence_parallel_attention``'s (``chunked_attention.sp_arm``):

    * ``"heads"``: the rank's heads' q/k/v (the rules cut ``wq``, ``wk``,
      ``wv`` and ``wo`` on them), their attention, and the rank's part
      of the output projection summed over the line;
    * ``"seq"``: the rank's ``S/mp`` query rows against K/V of every
      position, projected by whole weights (a weight the rules cut on its
      heads is gathered first), the rows' outputs gathered over the line;
    * ``"whole"``: everything whole on every rank (cut weights gathered).

    Inside the first two the ranks compute parts: x, a weight left whole
    and ``memory`` enter through ``line_enter`` (their gradients summed
    over the line), a gathered weight's gradient is reduce-scattered.
    ``memory`` [B, T, d] (a decoder's cross attention over the encoder's
    output) gives K/V without RoPE, and q has none either; otherwise q and
    K rotate at ``positions`` [B, S] and qk-norm applies where ``cfg``
    has it.  ``window`` defaults to the layer's sliding window."""
    from ..sharding.group import line_enter, line_gather, line_sum
    from .chunked_attention import sequence_parallel_attention, sp_arm
    line = flags.train.model
    H, KV = cfg.num_heads, cfg.num_kv_heads
    S = x.shape[1]
    arm = sp_arm(H, KV, S, line.size)
    window = cfg.sliding_window if window is None else window
    parallel = arm != "whole"

    def whole(w):
        return line_enter(w, line) if parallel else w

    def weight(w, dim, heads):
        if w.shape[dim] < heads:                    # the rank's heads
            return w if arm == "heads" else \
                line_gather(w, line, dim, summed=parallel)
        return whole(w)

    wq, wk, wv = (weight(params[n], 1, h) for n, h in
                  (("wq", H), ("wk", KV), ("wv", KV)))
    wo = weight(params["wo"], 0, H)
    xin = line_enter(x, line) if parallel else x
    src = xin if memory is None else \
        (line_enter(memory, line) if parallel else memory)
    rows = slice(None)
    if arm == "seq":
        n = S // line.size
        rows = slice(line.index * n, (line.index + 1) * n)
    q = _proj(xin[:, rows], wq)
    k, v = _proj(src, wk), _proj(src, wv)
    if memory is None:
        if cfg.qk_norm:
            q = rms_norm({"scale": whole(params["q_norm"]["scale"])}, q,
                         cfg.norm_eps)
            k = rms_norm({"scale": whole(params["k_norm"]["scale"])}, k,
                         cfg.norm_eps)
        q = apply_rope(q, positions[:, rows], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = sequence_parallel_attention(q, k, v, causal=causal, window=window,
                                      flags=flags, arm=arm)
    y = _out_proj(out, wo)
    if arm == "heads":
        return line_sum(y, line)
    if arm == "seq":
        return line_gather(y, line, 1, summed=False)
    return y
