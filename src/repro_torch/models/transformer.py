"""Model composition for dense attention decoders: the layer, the stacked
layer groups (a Python loop over the ``[R, ...]`` leaves takes the place
of ``lax.scan``), the logits, and the two serving entry points,
``prefill`` and ``decode_step``.

Caches are nested dicts with the JAX package's keys and shapes
(``{"blocks": {"l0": {"mixer": {"k": [R, B, max_len, KV, hd], ...}}}}``)
and are updated **in place**: ``decode_step`` returns the cache it was
given, written at each row's window positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from . import attention as attn
from . import paging
from .config import ArchConfig
from .layers import (embed_apply, embed_template, lm_head_apply,
                     lm_head_template, mlp_apply, mlp_template,
                     rms_norm, rmsnorm_template)
from .params import DTYPES, Template, stack_template, tree_map
from ..kernels.ref import rope_freqs


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """The kernel flags of the JAX package's ``RuntimeFlags``, on by
    default: the serving path is the kernel path on every device (on the
    CPU the ops run their plain versions).  A flag turned off runs that
    op's plain version on any device.  The JAX flags of later slices
    (paged kernel, split-K, sharding) come with their ports."""
    use_flash: bool = True           # flash-attention op for prefill
    fused_rmsnorm: bool = True       # fused RMSNorm op for the layer norms
    use_fused_decode: bool = True    # fused flash-decode op for decode/verify


DEFAULT_FLAGS = RuntimeFlags()


def check_supported(cfg: ArchConfig) -> None:
    """Raise for architectures this slice of the port does not run,
    naming the ROADMAP item that will port them.  Nothing falls back."""
    why = None
    if cfg.num_experts:
        why = "MoE FFNs: ROADMAP Queue 1 item 6"
    elif set(cfg.layer_kinds()) != {"attn"}:
        why = "recurrent/hybrid stacks: ROADMAP Queue 1 item 7"
    elif cfg.use_mla:
        why = "MLA: ROADMAP Queue 1 item 8"
    elif cfg.is_encoder_decoder or cfg.frontend:
        why = "encoder-decoder and modality stubs: ROADMAP Queue 1 item 9"
    elif cfg.sliding_window:
        why = "sliding-window attention: ROADMAP Queue 1 item 3"
    elif cfg.mtp_depth:
        why = "multi-token prediction: ROADMAP Queue 1 item 8"
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


def layer_template(cfg: ArchConfig) -> Template:
    d = cfg.d_model
    return {"norm1": rmsnorm_template(d),
            "mixer": attn.attention_template(cfg),
            "norm2": rmsnorm_template(d),
            "ffn": mlp_template(d, cfg.d_ff)}


def model_template(cfg: ArchConfig) -> Template:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    t: Template = {"embed": embed_template(V, d),
                   "final_norm": rmsnorm_template(d)}
    if not cfg.tie_embeddings:
        t["lm_head"] = lm_head_template(d, V)
    _, pattern, R = group_structure(cfg)
    t["blocks"] = stack_template(
        {f"l{j}": layer_template(cfg) for j in range(len(pattern))}, R)
    return t


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    """Shapes of the cache ``prefill`` returns (the JAX
    ``abstract_cache``): ``[R, batch, max_len, KV, hd]`` per k/v leaf."""
    _, pattern, R = group_structure(cfg)
    shape = (R,) + attn.kv_cache_shape(cfg, batch, max_len)
    return {"blocks": {f"l{j}": {"mixer": {"k": shape, "v": shape}}
                       for j in range(len(pattern))}}


def new_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    dt = DTYPES[cfg.dtype]
    return tree_map(lambda s: torch.zeros(s, dtype=dt, device=device),
                    cache_shapes(cfg, batch, max_len))


def unstack_groups(blocks, R: int) -> List[Dict[str, Any]]:
    """Per-group views of stacked ``[R, ...]`` leaves (params or cache)."""
    return [tree_map(lambda a, r=r: a[r], blocks) for r in range(R)]


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

def layer_apply(params, cfg: ArchConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor], cache, flags: RuntimeFlags,
                decode: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """One pre-norm attention + SwiGLU block.  Prefill (``decode`` None)
    writes the prompt's K/V into ``cache``; decode (``decode`` holds the
    window ``pos``, arena ``tables`` and rope ``freqs``) runs the fused
    decode op, which writes the window into ``cache``."""
    h = rms_norm(params["norm1"], x, cfg.norm_eps, flags.fused_rmsnorm)
    if decode is None:
        y = attn.prefill_into_cache(params["mixer"], cfg, h, positions,
                                    cache["mixer"], flags)
    else:
        y = attn.fused_slot_decode(params["mixer"], cfg, h, cache["mixer"],
                                   decode["pos"], decode["tables"],
                                   decode["freqs"], flags)
    x = x + y
    h2 = rms_norm(params["norm2"], x, cfg.norm_eps, flags.fused_rmsnorm)
    return x + mlp_apply(params["ffn"], h2)


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].t()
    else:
        logits = lm_head_apply(params["lm_head"], x)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns so softmax mass stays on the real vocab
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _run_groups(params, cfg, x, positions, cache, flags, groups, decode=None):
    _, pattern, R = group_structure(cfg)
    groups = groups if groups is not None \
        else unstack_groups(params["blocks"], R)
    cache_groups = unstack_groups(cache["blocks"], R)
    for r in range(R):
        for j in range(len(pattern)):
            x = layer_apply(groups[r][f"l{j}"], cfg, x, positions,
                            cache_groups[r][f"l{j}"], flags, decode)
    return x


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
    x = _run_groups(params, cfg, x, positions, cache, flags, groups)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                cache_pos: torch.Tensor, flags: RuntimeFlags = DEFAULT_FLAGS,
                all_logits: bool = False, groups=None):
    """One decode step.  tokens: [B, S'] (S' = 1 for plain decode; S' > 1
    scores a speculative verify window); ``cache_pos`` is a [B] int32
    vector of per-row offsets (window token s of row b sits at
    ``cache_pos[b] + s``).  Writes the window into ``cache`` in place and
    returns (logits, cache): [B, V] at the first window position, or
    [B, S', V] with ``all_logits=True``."""
    x = embed_apply(params["embed"], tokens, DTYPES[cfg.dtype])
    B = x.shape[0]
    max_len = cache["blocks"]["l0"]["mixer"]["k"].shape[2]
    decode = {"pos": cache_pos.to(torch.int32).contiguous(),
              "tables": paging.slot_arena_tables(
                  B, max_len, paging.fused_page_size(max_len), x.device),
              "freqs": rope_freqs(cfg.head_dim, cfg.rope_theta, x.device)}
    x = _run_groups(params, cfg, x, None, cache, flags, groups, decode)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    logits = _logits(params, cfg, x)
    return (logits if all_logits else logits[:, 0]), cache
