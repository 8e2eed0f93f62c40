"""GQA attention with RoPE and optional qk-norm (qwen3), over a KV cache
in one of two layouts: contiguous slot rows ``[B, max_len, KV, hd]`` or
a paged block-pool arena ``[num_blocks, block_size, KV, hd]`` reached
through block tables (block 0 is the trash block).  Plain functions on
tensors in the JAX package's layouts: ``wq`` is [d, H, hd].

Prefill and the extend suffix run the flash-attention op (K3), decode
and verify windows the fused flash-decode op (K2, or K4 with
``fused_split_k``); the paged layout's single-query arm runs the
paged-attention op (K5, ``use_paged_kernel``).  With a kernel flag
turned off the plain version runs instead, on any device.  Caches are
written in place.

The full-sequence arm without a cache (``attention_forward``, the
training ``forward``'s) dispatches as the JAX ``_seq_attention`` does:
``"flash"`` through the flash-attention op (K3, no backward: it runs
under ``torch.no_grad`` only), ``"chunked"`` through the plain
``chunked_attention`` or ``"naive"`` through a masked softmax over the
whole sequence.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import (NEG_INF, flash_attention_ref,
                           fused_flash_decode_ref, gathered_attention, upcast)
from . import paging
from .chunked_attention import chunked_attention
from .config import ArchConfig
from .layers import apply_rope, linear, rms_norm
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


def kv_cache_shape(cfg: ArchConfig, batch: int,
                   max_len: int) -> Tuple[int, ...]:
    return (batch, max_len, cfg.num_kv_heads, cfg.head_dim)


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


def prefill_into_cache(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                       flags) -> torch.Tensor:
    """Run causal attention over the prompt and write its rotated K and
    its V into positions ``[0, S)`` of ``cache`` ([B, max_len, KV, hd],
    zero beyond) **in place**.  Returns the attention block's output."""
    q, k, v = _qkv(params, cfg, x, positions)
    attend = ops.flash_attention if flags.use_flash else flash_attention_ref
    out = attend(q, k, v, causal=True,
                 window=cfg.sliding_window)
    S = x.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return _out_proj(out, params["wo"])


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
    prefix_len - 1`` gathered from the cache.  The suffix queries attend
    over prefix ++ suffix through the flash op at ``q_offset =
    prefix_len`` (K3), or its plain version when ``use_flash`` is off;
    both partition the keys at absolute multiples of 128, so the suffix
    rows — and the first generated token — are bitwise equal to a cold
    prefill of the whole prompt.  Returns (the attention block's output,
    the suffix's rotated K and its V, [B, S', KV, hd])."""
    q, k, v = _qkv(params, cfg, x, positions)
    k_full = torch.cat([prefix_kv["k"].to(k.dtype), k], dim=1)
    v_full = torch.cat([prefix_kv["v"].to(v.dtype), v], dim=1)
    attend = ops.flash_attention if flags.use_flash else flash_attention_ref
    out = attend(q, k_full, v_full, causal=True, window=cfg.sliding_window,
                 q_offset=prefix_len)
    return _out_proj(out, params["wo"]), {"k": k, "v": v}
