"""GQA attention with RoPE and optional qk-norm (qwen3), over a contiguous
slot KV cache.  Plain functions on tensors in the JAX package's layouts:
``wq`` is [d, H, hd], caches are [B, max_len, KV, hd].

Prefill runs the flash-attention op, decode and verify windows the fused
flash-decode op; with a kernel flag turned off the op's plain version
runs instead, on any device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import flash_attention_ref, fused_flash_decode_ref
from . import paging
from .config import ArchConfig
from .layers import apply_rope, rms_norm
from .params import ParamSpec, Template


def attention_template(cfg: ArchConfig) -> Template:
    d, hd = cfg.d_model, cfg.head_dim
    t: Template = {
        "wq": ParamSpec((d, cfg.num_heads, hd)),
        "wk": ParamSpec((d, cfg.num_kv_heads, hd)),
        "wv": ParamSpec((d, cfg.num_kv_heads, hd)),
        "wo": ParamSpec((cfg.num_heads, hd, d)),
    }
    if cfg.qk_norm:
        t["q_norm"] = {"scale": ParamSpec((hd,), init="ones")}
        t["k_norm"] = {"scale": ParamSpec((hd,), init="ones")}
    return t


def kv_cache_shape(cfg: ArchConfig, batch: int,
                   max_len: int) -> Tuple[int, ...]:
    return (batch, max_len, cfg.num_kv_heads, cfg.head_dim)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul: [B,S,d] @ [d, h*k]."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matmul."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


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
    attend = ops.fused_flash_decode if paging.use_fused_decode(cfg, flags) \
        else fused_flash_decode_ref
    out = attend(q, k, v, k_arena, v_arena, tables, pos, freqs)
    return _out_proj(out, params["wo"])
