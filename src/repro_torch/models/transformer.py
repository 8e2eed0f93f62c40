"""Model composition for attention decoders with dense or MoE FFNs: the
layer, the stacked layer groups (a Python loop over the ``[R, ...]``
leaves takes the place of ``lax.scan``), the logits, and the serving
entry points ``prefill``, ``prefill_extend`` and ``decode_step``.

Caches are nested dicts with the JAX package's keys and shapes
(``{"blocks": {"l0": {"mixer": {"k": [R, B, max_len, KV, hd], ...}}}}``
for slot rows, ``[R, num_blocks, block_size, KV, hd]`` leaves for the
paged arena) and are updated **in place**: ``decode_step`` returns the
cache it was given, written at each row's window positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from . import attention as attn
from . import moe as moe_mod
from . import paging
from .config import ArchConfig
from .layers import (embed_apply, embed_template, linear, lm_head_apply,
                     lm_head_template, mlp_apply, mlp_template,
                     rms_norm, rmsnorm_template)
from .params import DTYPES, Template, stack_template, tree_map
from ..kernels.ref import rope_freqs


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """The kernel flags of the JAX package's ``RuntimeFlags``.  The first
    three are on by default: the serving path is the kernel path on
    every device (on the CPU the ops run their plain versions), and a
    flag turned off runs that op's plain version on any device.  The two
    paged-decode variants are off by default, as in JAX.  (The JAX
    sharding flags come with the sharded serving port.)  ``cuda_graphs``
    is the port's own: the counterpart of the JAX engine's ``jax.jit``
    of its steps."""
    use_flash: bool = True           # flash-attention op for prefill/extend
    fused_rmsnorm: bool = True       # fused RMSNorm op for the layer norms
    use_fused_decode: bool = True    # fused flash-decode op for decode/verify
    # paged single-query decode through the paged-attention op (K5)
    # instead of the page gather; used when use_fused_decode is off
    use_paged_kernel: bool = False
    # the fused decode op's split-K variant (K4): the row's keys split
    # across CTAs in fixed spans of absolute key positions
    fused_split_k: bool = False
    # on the card, the engine's decode and verify steps run as captured
    # CUDA graphs (``runtime/graphs.py``); off runs them eagerly, one
    # host launch per op, for an A/B comparison.  No effect on the CPU
    cuda_graphs: bool = True
    # MoE implementation: "gather" (the global sort-based dispatch,
    # ``models/moe.py``); "ep" (expert parallelism over a mesh) is refused
    # until ROADMAP Queue 1 item 11
    moe_impl: str = "gather"


DEFAULT_FLAGS = RuntimeFlags()


def check_supported(cfg: ArchConfig) -> None:
    """Raise for architectures this slice of the port does not run,
    naming the ROADMAP item that will port them.  Nothing falls back."""
    why = None
    if set(cfg.layer_kinds()) != {"attn"}:
        why = "recurrent/hybrid stacks: ROADMAP Queue 1 item 7"
    elif cfg.use_mla:
        why = "MLA: ROADMAP Queue 1 item 8"
    elif cfg.is_encoder_decoder or cfg.frontend:
        why = "encoder-decoder and modality stubs: ROADMAP Queue 1 item 9"
    elif cfg.sliding_window:
        why = "sliding-window attention: ROADMAP Queue 1 item 12"
    elif cfg.mtp_depth:
        why = "multi-token prediction: ROADMAP Queue 1 item 8"
    elif cfg.num_experts and cfg.first_k_dense:
        # the unrolled dense head of group_structure is not built
        why = "dense head layers before MoE (first_k_dense): ROADMAP " \
              "Queue 1 item 8"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: not yet ported to repro_torch ({why})")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def group_structure(cfg: ArchConfig):
    """Split layers into (unrolled head, repeating pattern, repeat count)."""
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    k = cfg.first_k_dense if cfg.num_experts else 0
    head, rest = kinds[:k], kinds[k:]
    P = len(rest)
    for p in range(1, len(rest) + 1):
        if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
            P = p
            break
    return head, rest[:P], (len(rest) // P if rest else 0)


def layer_template(cfg: ArchConfig, ffn_kind: str) -> Template:
    d = cfg.d_model
    return {"norm1": rmsnorm_template(d),
            "mixer": attn.attention_template(cfg),
            "norm2": rmsnorm_template(d),
            "ffn": moe_mod.moe_template(cfg) if ffn_kind == "moe"
            else mlp_template(d, cfg.d_ff)}


def model_template(cfg: ArchConfig) -> Template:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    t: Template = {"embed": embed_template(V, d),
                   "final_norm": rmsnorm_template(d)}
    if not cfg.tie_embeddings:
        t["lm_head"] = lm_head_template(d, V)
    _, pattern, R = group_structure(cfg)
    t["blocks"] = stack_template(
        {f"l{j}": layer_template(cfg, ffn)
         for j, (_, ffn) in enumerate(pattern)}, R)
    return t


def _cache_tree(cfg: ArchConfig, shape):
    _, pattern, R = group_structure(cfg)
    shape = (R,) + shape
    return {"blocks": {f"l{j}": {"mixer": {"k": shape, "v": shape}}
                       for j in range(len(pattern))}}


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    """Shapes of the cache ``prefill`` returns (the JAX
    ``abstract_cache``): ``[R, batch, max_len, KV, hd]`` per k/v leaf."""
    return _cache_tree(cfg, attn.kv_cache_shape(cfg, batch, max_len))


def paged_cache_shapes(cfg: ArchConfig, num_blocks: int, block_size: int):
    """Shapes of the paged arena (the JAX ``abstract_paged_cache``): the
    tree of :func:`cache_shapes` with ``[R, num_blocks, block_size, KV,
    hd]`` leaves."""
    return _cache_tree(cfg, attn.paged_kv_cache_shape(cfg, num_blocks,
                                                      block_size))


def _zeros(cfg: ArchConfig, shapes, device):
    dt = DTYPES[cfg.dtype]
    return tree_map(lambda s: torch.zeros(s, dtype=dt, device=device), shapes)


def new_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    return _zeros(cfg, cache_shapes(cfg, batch, max_len), device)


def new_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int,
                    device):
    return _zeros(cfg, paged_cache_shapes(cfg, num_blocks, block_size),
                  device)


def unstack_groups(blocks, R: int) -> List[Dict[str, Any]]:
    """Per-group views of stacked ``[R, ...]`` leaves (params or cache)."""
    return [tree_map(lambda a, r=r: a[r], blocks) for r in range(R)]


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

def layer_apply(params, cfg: ArchConfig, ffn_kind: str, x: torch.Tensor,
                flags: RuntimeFlags,
                mixer: Callable[[Any, torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """One pre-norm attention + SwiGLU or MoE block; ``mixer(mixer_params,
    h)`` is the attention of the entry point (prefill, extend, slot or
    paged decode), which writes its cache in place.  A MoE layer's
    load-balance loss is dropped: serving has no use for it."""
    h = rms_norm(params["norm1"], x, cfg.norm_eps, flags.fused_rmsnorm)
    x = x + mixer(params["mixer"], h)
    h2 = rms_norm(params["norm2"], x, cfg.norm_eps, flags.fused_rmsnorm)
    if ffn_kind == "moe":
        return x + moe_mod.moe_apply(params["ffn"], cfg, h2, flags)[0]
    return x + mlp_apply(params["ffn"], h2)


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = linear(x, params["embed"]["embedding"].t())
    else:
        logits = lm_head_apply(params["lm_head"], x)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns so softmax mass stays on the real vocab
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _run_groups(params, cfg, x, cache_blocks, flags, groups, mixer):
    """Every layer in order.  ``cache_blocks`` is a tree with ``[R, ...]``
    leaves (``cache["blocks"]``, or a dict of such trees); layer ``lj``
    of group ``r`` runs ``mixer(mixer_params, h, group_cache, "lj")``
    with ``group_cache`` the tree's ``r``-th slice."""
    _, pattern, R = group_structure(cfg)
    groups = groups if groups is not None \
        else unstack_groups(params["blocks"], R)
    cache_groups = unstack_groups(cache_blocks, R)
    for r in range(R):
        for j, (_, ffn) in enumerate(pattern):
            name = f"l{j}"
            x = layer_apply(
                groups[r][name], cfg, ffn, x, flags,
                lambda mp, h, c=cache_groups[r], n=name: mixer(mp, h, c, n))
    return x


def _last_logits(params, cfg, x, flags):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    return _logits(params, cfg, x[:, -1:])[:, 0]


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            max_cache_len: int, flags: RuntimeFlags = DEFAULT_FLAGS,
            groups=None):
    """Run the prompt [B, S]; return (last-token logits [B, V], cache).
    ``groups`` are per-group param views (``unstack_groups``), made here
    when not given."""
    x = embed_apply(params["embed"], tokens, DTYPES[cfg.dtype])
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = new_cache(cfg, B, max_cache_len, x.device)

    def mixer(mp, h, c, name):
        return attn.prefill_into_cache(mp, cfg, h, positions, c[name]["mixer"],
                                       flags)

    x = _run_groups(params, cfg, x, cache["blocks"], flags, groups, mixer)
    return _last_logits(params, cfg, x, flags), cache


def prefill_extend(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                   prefix_ref: paging.PrefixRef, prefix_len: int,
                   max_cache_len: int, flags: RuntimeFlags = DEFAULT_FLAGS,
                   groups=None):
    """Prefill a prompt *suffix* against already-cached prefix K/V.

    tokens: [B, S'] — the prompt tokens from position ``prefix_len`` on;
    ``prefix_ref`` names where the prefix lives (``paging.PagedPrefix``
    — the arena through a block table, ``prefix_len`` a multiple of its
    block size — or ``paging.SlotPrefix`` — contiguous slot rows).  One
    entry point serves prefix-shared and chunked prefill on both
    layouts.  Each layer attends over its gathered prefix K/V and emits
    the suffix's K/V as cache rows ``[R, B, max_cache_len, KV, hd]``
    (suffix at row positions ``0 .. S' - 1``, zero beyond); ``cache`` is
    only read.  Returns (last-token logits [B, V], rows).  The suffix
    rows are bitwise equal to a cold prefill of the whole prompt's."""
    x = embed_apply(params["embed"], tokens, DTYPES[cfg.dtype])
    B, S_, _ = x.shape
    positions = (prefix_len + torch.arange(S_, device=x.device)).expand(B, S_)
    rows = new_cache(cfg, B, max_cache_len, x.device)

    def mixer(mp, h, c, name):
        pkv = paging.gather_prefix_kv(c["arena"][name]["mixer"], prefix_ref,
                                      prefix_len)
        y, kv = attn.prefill_extend_into_cache(mp, cfg, h, positions, pkv,
                                               prefix_len, flags)
        out = c["rows"][name]["mixer"]
        out["k"][:, :S_] = kv["k"]
        out["v"][:, :S_] = kv["v"]
        return y

    x = _run_groups(params, cfg, x,
                    {"arena": cache["blocks"], "rows": rows["blocks"]},
                    flags, groups, mixer)
    return _last_logits(params, cfg, x, flags), rows


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                cache_pos: torch.Tensor, flags: RuntimeFlags = DEFAULT_FLAGS,
                all_logits: bool = False, groups=None,
                block_tables: Optional[torch.Tensor] = None):
    """One decode step.  tokens: [B, S'] (S' = 1 for plain decode; S' > 1
    scores a speculative verify window); ``cache_pos`` is a [B] int32
    vector of per-row offsets (window token s of row b sits at
    ``cache_pos[b] + s``).  ``block_tables`` ([B, P] int32) switches to
    the paged layout: ``cache`` holds block-pool arenas and each row's
    K/V is reached through its table.  Writes the window into ``cache``
    in place and returns (logits, cache): [B, V] at the first window
    position, or [B, S', V] with ``all_logits=True``."""
    x = embed_apply(params["embed"], tokens, DTYPES[cfg.dtype])
    B = x.shape[0]
    pos = cache_pos.to(torch.int32).contiguous()
    freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, x.device)
    if block_tables is not None:
        tables = block_tables.to(torch.int32).contiguous()

        def mixer(mp, h, c, name):
            return attn.paged_decode(mp, cfg, h, c[name]["mixer"], pos,
                                     tables, freqs, flags)
    else:
        max_len = cache["blocks"]["l0"]["mixer"]["k"].shape[2]
        tables = paging.slot_arena_tables(
            B, max_len, paging.fused_page_size(max_len), x.device)

        def mixer(mp, h, c, name):
            return attn.fused_slot_decode(mp, cfg, h, c[name]["mixer"], pos,
                                          tables, freqs, flags)

    x = _run_groups(params, cfg, x, cache["blocks"], flags, groups, mixer)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    logits = _logits(params, cfg, x)
    return (logits if all_logits else logits[:, 0]), cache
