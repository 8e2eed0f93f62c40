"""Model composition: the layer (GQA attention, MLA, Mamba, mLSTM or
sLSTM mixer x dense or MoE FFN, and in an encoder-decoder's decoder a
cross-attention block between the two), the unrolled dense head layers,
the stacked layer groups (a Python loop over the ``[R, ...]`` leaves
takes the place of ``lax.scan``), the bidirectional encoder over stub
frame embeddings, the logits, the multi-token prediction head, the
training and evaluation entry point ``forward`` (the full sequence
without a cache, differentiable on the plain path), and the serving
entry points ``prefill`` (with stub prefix or encoder embeddings),
``prefill_extend`` and ``decode_step``.

Caches are nested dicts with the JAX package's keys and shapes
(``{"blocks": {"l0": {"mixer": {"k": [R, B, max_len, KV, hd], ...}}}}``
for slot rows, ``[R, num_blocks, block_size, KV, hd]`` leaves for the
paged arena, ``[R, B, ...]`` recurrent state slabs such as mLSTM's
``C`` ``[R, B, H, hd, hd]``; MLA layers hold latents ``c_kv`` and
``k_rope`` instead of ``k`` and ``v``; an encoder-decoder's decoder
layers add their cross-attention memory K/V under ``cross``, ``[R, B,
enc_len, KV, hd]``; the dense head layers sit under
``head_layers.layer{i}`` without the ``[R]`` axis) and are updated **in
place**: ``decode_step`` returns the cache it was given, written at each
row's window positions.  The hybrid layout pages attention layers and
keeps recurrent layers in slabs of ``num_slots`` rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import attention as attn
from . import mamba as mam
from . import mla as mla_mod
from . import moe as moe_mod
from . import paging
from . import xlstm as xl
from .chunked_attention import chunked_attention
from .config import ArchConfig
from .layers import (embed_apply, embed_template, linear, lm_head_apply,
                     lm_head_template, mesh_embed, mesh_mlp, mlp_apply,
                     mlp_template, remat, rms_norm, rmsnorm_template,
                     rows_padded)
from .params import (DTYPES, ParamSpec, Template, flatten, stack_template,
                     tree_map, unflatten)
from ..kernels.ref import rope_freqs
from ..sharding.group import (cut, line_enter, line_gather, own_range,
                              placed, tp_reduce, tp_reduce_parts)
from ..sharding.rules import WHOLE_SEQ, local_tree


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """The kernel flags of the JAX package's ``RuntimeFlags``.  The first
    three are on by default: the serving path is the kernel path on
    every device (on the CPU the ops run their plain versions), and a
    flag turned off runs that op's plain version on any device.  The two
    paged-decode variants are off by default, as in JAX.  ``cuda_graphs``
    is the port's own: the counterpart of the JAX engine's ``jax.jit``
    of its steps.  ``decode_shards`` and ``tp`` are the JAX
    ``decode_shards`` and ``decode_mesh``: the engine sets them when it
    serves on a mesh of more than one rank.  ``batch_axes``,
    ``batch_divisor``, ``model_axis`` and ``model_size`` are JAX's
    training sharding flags, and ``train`` the training rank's group:
    ``runtime.steps.make_train_step(mesh=...)`` sets it on every rank
    (ROADMAP item 11c-i)."""
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
    # ``models/moe.py``) or "ep" (expert parallelism: JAX's ``_moe_ep`` and
    # ``_moe_ep_decode`` on a training mesh, ``moe.ep_plain`` without
    # one); "ep" needs model_size > 1 or batch_axes, as JAX's needs a mesh
    moe_impl: str = "gather"
    # ``forward``'s full-sequence attention without the flash op:
    # "chunked" | "naive" ("flash" wins where use_flash is set)
    attn_impl: str = "chunked"
    # ``forward`` under autograd: "group" checkpoints each layer group
    # (and each encoder layer), as JAX's ``jax.checkpoint``; "none"
    remat: str = "group"
    # tensor-parallel serving: the mesh's model-axis size, and this
    # rank's group (``sharding/group.py``: the all-reduces of
    # ``tp_reduce``, the vocab-parallel embedding and logits); the
    # weights and caches a step is given are this rank's slices
    decode_shards: int = 1
    tp: Any = dataclasses.field(default=None, compare=False, repr=False)
    # training on a mesh: the batch dimension's mesh axes and their size,
    # the model axis and its size (JAX's flags), and the rank's group
    # (``sharding/group.py``'s ``TrainGroup``): the weights ``forward`` is
    # given are the rank's slices, the batch its rows
    batch_axes: Tuple[str, ...] = ()
    batch_divisor: int = 1
    model_axis: str = "model"
    model_size: int = 1
    train: Any = dataclasses.field(default=None, compare=False, repr=False)


DEFAULT_FLAGS = RuntimeFlags()
#: the training path: the kernels off, as the JAX package trains (its
#: Pallas kernels, like the port's CUDA kernels, have no backward)
TRAIN_FLAGS = RuntimeFlags(use_flash=False, fused_rmsnorm=False)


def check_paged_support(cfg: ArchConfig) -> None:
    """The paged KV cache pages attention K/V; recurrent mixers keep
    O(1) state, which the state and hybrid layouts hold, cross attention
    keeps its memory in slot rows, and a sliding window's rows wrap,
    which block paging cannot hold: each refused with JAX's message.
    (Every architecture is served on some layout; what JAX refuses of
    one is refused where JAX refuses it: here, in
    :func:`check_hybrid_support` and :func:`check_mixed_extend_support`,
    in the engine's ``check_spec_support`` and in the Scheduler.)"""
    if cfg.is_encoder_decoder:
        raise ValueError("paged KV cache: encoder-decoder models are "
                         "not supported")
    if cfg.sliding_window:
        raise ValueError("paged KV cache: sliding-window attention is "
                         "not supported (the window's rotating slot "
                         "layout conflicts with block paging)")
    bad = sorted({k for k in cfg.layer_kinds() if k != "attn"})
    if bad:
        raise ValueError(f"paged KV cache: recurrent layer kinds {bad} "
                         f"have O(1) state, not a growing KV cache; use "
                         f"the state or hybrid layout")


def check_hybrid_support(cfg: ArchConfig) -> None:
    """The hybrid layout pages attention K/V beside recurrent state
    slabs, so it refuses what the paged arena refuses of attention."""
    if cfg.is_encoder_decoder:
        raise ValueError("hybrid cache: encoder-decoder models are not "
                         "supported")
    if cfg.sliding_window:
        raise ValueError("hybrid cache: sliding-window attention is not "
                         "supported (the window's rotating slot layout "
                         "conflicts with block paging)")


def check_mixed_extend_support(cfg: ArchConfig) -> None:
    """Prefix-extend limits that hold on every cache layout (the paged
    arena adds :func:`check_paged_support`)."""
    if cfg.is_encoder_decoder:
        raise ValueError("prefix extend: encoder-decoder models are not "
                         "supported")
    if cfg.sliding_window and "attn" in cfg.layer_kinds():
        raise ValueError("prefix extend: sliding-window attention is not "
                         "supported (the rotating slot layout has no "
                         "stable prefix rows)")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

RECURRENT_KINDS = ("mamba", "mlstm", "slstm")

_MIXER_TEMPLATES = {"attn": lambda cfg: mla_mod.mla_template(cfg)
                    if cfg.use_mla else attn.attention_template(cfg),
                    "mamba": mam.mamba_template,
                    "mlstm": xl.mlstm_template,
                    "slstm": xl.slstm_template}

#: the window of each recurrent kind: ``(params, cfg, x, state,
#: stack=None, tp=None) -> (y, final state)``; on a tensor-parallel rank
#: (``tp``, its group) y is the rank's part of a sum over the ranks
_WINDOWS = {"mamba": mam.mamba_window,
            "mlstm": xl.mlstm_window,
            "slstm": xl.slstm_window}

_PREFILLS = {"mamba": mam.mamba_prefill_into_cache,
             "mlstm": xl.mlstm_prefill_into_cache,
             "slstm": xl.slstm_prefill_into_cache}

#: the full-sequence (training) form of each recurrent kind: ``(params,
#: cfg, x) -> (y, final state or None)``
_APPLIES = {"mamba": mam.mamba_apply,
            "mlstm": xl.mlstm_apply,
            "slstm": xl.slstm_apply}

_STATE_CACHES = {"mamba": mam.mamba_cache,
                 "mlstm": xl.mlstm_cache,
                 "slstm": xl.slstm_cache}


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


def layer_template(cfg: ArchConfig, kind: str, ffn_kind: str,
                   cross: bool = False) -> Template:
    """A layer's params; ``cross`` adds a decoder layer's cross-attention
    block (its norm and a GQA attention without qk-norm)."""
    d = cfg.d_model
    if kind not in _MIXER_TEMPLATES:
        raise ValueError(f"unknown layer kind {kind!r}")
    t: Template = {"norm1": rmsnorm_template(d),
                   "mixer": _MIXER_TEMPLATES[kind](cfg)}
    if cross:
        t["cross_norm"] = rmsnorm_template(d)
        t["cross"] = attn.attention_template(
            dataclasses.replace(cfg, qk_norm=False))
    dff = cfg.dense_d_ff if ffn_kind == "dense" else cfg.d_ff
    # xLSTM blocks carry integral up/down projections: no separate FFN
    if dff and not (kind in ("mlstm", "slstm") and cfg.d_ff == 0):
        t["norm2"] = rmsnorm_template(d)
        t["ffn"] = moe_mod.moe_template(cfg) if ffn_kind == "moe" \
            else mlp_template(d, dff)
    return t


def model_template(cfg: ArchConfig) -> Template:
    d, V = cfg.d_model, cfg.padded_vocab
    t: Template = {"embed": embed_template(V, d),
                   "final_norm": rmsnorm_template(d)}
    if not cfg.tie_embeddings:
        t["lm_head"] = lm_head_template(d, V)
    head, pattern, R = group_structure(cfg)
    if head:
        t["head_layers"] = {f"layer{i}": layer_template(cfg, kind, ffn)
                            for i, (kind, ffn) in enumerate(head)}
    if R:
        t["blocks"] = stack_template(
            {f"l{j}": layer_template(cfg, kind, ffn,
                                     cross=cfg.is_encoder_decoder)
             for j, (kind, ffn) in enumerate(pattern)}, R)
    if cfg.is_encoder_decoder:
        enc_layer = layer_template(
            dataclasses.replace(cfg, use_mla=False, num_experts=0),
            "attn", "dense")
        t["encoder"] = {
            "blocks": stack_template(enc_layer, cfg.num_encoder_layers),
            "final_norm": rmsnorm_template(d)}
    if cfg.mtp_depth:
        t["mtp"] = {"proj": ParamSpec((2 * d, d), ("embed_b", "embed")),
                    "norm": rmsnorm_template(d),
                    "block": layer_template(
                        cfg, "attn", "dense" if cfg.first_k_dense
                        else cfg.ffn_kinds()[-1])}
    return t


# ---------------------------------------------------------------------------
# caches: abstract trees of "meta" tensors (the JAX ShapeDtypeStructs),
# materialised by _zeros
# ---------------------------------------------------------------------------

def _kv(cfg: ArchConfig, shape) -> Dict[str, torch.Tensor]:
    a = torch.empty(shape, dtype=DTYPES[cfg.dtype], device="meta")
    return {"k": a, "v": a}


def _attn_slots(cfg: ArchConfig, batch: int, max_len: int):
    """An attention layer's slot rows: K/V, or MLA's latents."""
    if cfg.use_mla:
        return mla_mod.abstract_mla_cache(cfg, batch, max_len)
    return _kv(cfg, attn.kv_cache_shape(cfg, batch, max_len))


def _attn_arena(cfg: ArchConfig, num_blocks: int, block_size: int):
    """An attention layer's block-pool arena: K/V, or MLA's latents."""
    if cfg.use_mla:
        return mla_mod.abstract_paged_mla_cache(cfg, num_blocks, block_size)
    return _kv(cfg, attn.paged_kv_cache_shape(cfg, num_blocks, block_size))


def _stacked(cfg: ArchConfig, layer: Callable[[str], Dict],
             cross: Optional[Dict] = None):
    """The cache tree: each head layer's mixer cache ``layer(kind)`` as
    it is, and each layer of the pattern's (with ``cross``, the decoder
    layers' memory K/V, beside it) given a leading ``[R]`` axis."""
    head, pattern, R = group_structure(cfg)
    out = {}
    if head:
        out["head_layers"] = {f"layer{i}": {"mixer": layer(kind)}
                              for i, (kind, _) in enumerate(head)}
    if R:
        out["blocks"] = {
            f"l{j}": tree_map(lambda a: a.new_empty((R,) + a.shape),
                              {"mixer": layer(kind), "cross": cross}
                              if cross else {"mixer": layer(kind)})
            for j, (kind, _) in enumerate(pattern)}
    return out


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int,
                   enc_len: int = 0):
    """The cache ``prefill`` returns, and the slot and state layouts'
    cache: ``[R, batch, size, KV, hd]`` per attention k/v leaf (MLA:
    ``c_kv`` and ``k_rope`` rows), ``size`` being ``max_len`` or a
    sliding window's ``min(max_len, window)``, the ``[R, batch, ...]``
    state of each recurrent layer (f32, Mamba's conv tail in the model
    dtype), and an
    encoder-decoder's cross-attention memory K/V ``[R, batch, enc_len,
    KV, hd]``."""
    cross = _kv(cfg, (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)) \
        if cfg.is_encoder_decoder else None
    return _stacked(cfg, lambda kind: _attn_slots(cfg, batch, max_len)
                    if kind == "attn"
                    else _STATE_CACHES[kind](cfg, batch, "meta"), cross)


def abstract_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int):
    """The paged arena: ``[R, num_blocks, block_size, KV, hd]`` leaves."""
    check_paged_support(cfg)
    return _stacked(cfg, lambda kind: _attn_arena(cfg, num_blocks,
                                                  block_size))


def abstract_hybrid_cache(cfg: ArchConfig, num_slots: int, num_blocks: int,
                          block_size: int):
    """The hybrid layout: attention K/V in a ``[num_blocks, block_size,
    ...]`` block-pool arena per layer (reached through block tables,
    exactly the paged layout), recurrent mixers in ``[num_slots, ...]``
    state slabs (slot i of every slab belongs to the request in
    scheduler slot i)."""
    check_hybrid_support(cfg)
    return _stacked(cfg, lambda kind: _attn_arena(cfg, num_blocks,
                                                  block_size)
                    if kind == "attn"
                    else _STATE_CACHES[kind](cfg, num_slots, "meta"))


def _zeros(tree, device, mesh=None, rules=None):
    """The abstract cache ``tree`` materialised with zeros; on a mesh of
    more than one rank, each leaf cut to a rank's shape by the rules'
    ``cache_specs`` (K/V on their kv heads, else head_dim, else the
    sequence; ``rules``: ``WHOLE_SEQ`` keeps every position)."""
    if mesh is not None and mesh.shape["model"] > 1:
        tree = local_tree(tree, mesh, rules)
    return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                          device=device), tree)


def _mesh(flags: RuntimeFlags):
    """The serving mesh of a rank of more than one (None otherwise)."""
    return flags.tp.mesh if flags.tp is not None else None


def new_cache(cfg: ArchConfig, batch: int, max_len: int, device,
              enc_len: int = 0, mesh=None, rules=None):
    return _zeros(abstract_cache(cfg, batch, max_len, enc_len), device,
                  mesh, rules)


def seq_cut(cfg: ArchConfig, path: str, tp) -> bool:
    """Whether a rank holds a cut of cache leaf ``path``'s positions: MLA's
    ``k_rope``, and attention K/V on the sequence arm (kv heads and
    head_dim both undivided).  The lengths they are cut on divide the
    ranks (``LLMEngine`` checks ``max_len`` and block sizes)."""
    if tp is None:
        return False
    key = path.rsplit(".", 1)[-1]
    return key == "k_rope" or (key in ("k", "v")
                               and attn.kv_arm(cfg, tp) == "seq")


def new_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int,
                    device, mesh=None):
    return _zeros(abstract_paged_cache(cfg, num_blocks, block_size), device,
                  mesh)


def new_hybrid_cache(cfg: ArchConfig, num_slots: int, num_blocks: int,
                     block_size: int, device, mesh=None):
    return _zeros(abstract_hybrid_cache(cfg, num_slots, num_blocks,
                                        block_size), device, mesh)


def layer_kind_of_path(cfg: ArchConfig, path) -> str:
    """The layer kind of a cache leaf's path (dotted, as ``flatten``
    gives it, or split): the one dispatch point mixed-layout cache
    writers use to tell a paged attention arena from a state slab."""
    parts = path.split(".") if isinstance(path, str) else list(path)
    head, pattern, _ = group_structure(cfg)
    if parts[0] == "head_layers":
        return head[int(parts[1][len("layer"):])][0]
    if parts[0] != "blocks":
        raise KeyError(f"not a layer cache path: {path}")
    return pattern[int(parts[1][1:])][0]


def new_state_stacks(cfg: ArchConfig, cache, width: int):
    """Buffers for a verify window's state stacks, mirroring ``cache``:
    each recurrent leaf ``[R, N, ...]`` grown to ``[R, N, width, ...]``
    (the state after every window position), every other leaf a
    zero-size ``[R, 0]`` placeholder."""
    def leaf(path, a):
        if layer_kind_of_path(cfg, path) == "attn":
            return a.new_zeros((a.shape[0], 0))
        return a.new_zeros(a.shape[:2] + (width,) + a.shape[2:])

    return unflatten({path: leaf(path, a)
                      for path, a in flatten(cache).items()})


def unstack_groups(blocks, R: int) -> List[Dict[str, Any]]:
    """Per-group views of stacked ``[R, ...]`` leaves (params or cache)."""
    return [tree_map(lambda a, r=r: a[r], blocks) for r in range(R)]


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

def cross_kv(params, memory: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A decoder layer's cross-attention memory K/V: the encoder's
    output [B, T, d] projected to k, v [B, T, KV, hd] (no RoPE)."""
    return {"k": attn._proj(memory, params["wk"]),
            "v": attn._proj(memory, params["wv"])}


def _cross_attention(params, x: torch.Tensor,
                     memory_kv: Dict[str, torch.Tensor],
                     cfg: Optional[ArchConfig] = None, tp=None
                     ) -> torch.Tensor:
    """x [B, S, d] attends, with no mask and no RoPE, over the memory
    K/V; in plain PyTorch (``chunked_attention``), as the JAX package
    attends here outside any Pallas kernel.  On a tensor-parallel rank
    ``memory_kv`` is the rank's cache slice (``attention.kv_arm``): on
    the kv-heads arm the rank's heads attend as without a mesh, on the
    head_dim and sequence arms every head attends through
    ``attention.sharded_attention``, every position valid.  Returns the
    rank's part of the output, or the whole (``attention.partial``)."""
    q = attn._proj(x, params["wq"])
    arm = attn.kv_arm(cfg, tp) if cfg is not None else "whole"
    if arm in ("whole", "heads"):
        out = chunked_attention(q, memory_kv["k"], memory_kv["v"],
                                causal=False)
        return attn._out_proj(out, params["wo"])
    h0 = attn.rank_head0(params, cfg, tp)
    q = attn.all_heads(q, cfg.num_heads, h0, tp)
    k, v = memory_kv["k"], memory_kv["v"]
    T = k.shape[1] * (tp.size if arm == "seq" else 1)
    every = torch.ones(q.shape[:2] + (T,), dtype=torch.bool,
                       device=x.device)
    out = attn.sharded_attention(q, k, v, every, cfg.head_dim, arm, tp,
                                 own_range(k.shape[1], tp, x.device), T)
    return attn.tp_out_proj(out.to(x.dtype), params, cfg, arm, tp, h0)


def _mixer_partial(cfg: ArchConfig, kind: str, mp, tp) -> bool:
    """Whether a rank's mixer output is its part of a sum over the ranks
    (its output projection contracts a width the rules cut) or the
    whole output (the width left whole: summing it would count it tp
    times)."""
    if tp is None:
        return False
    if kind == "attn":
        return mla_mod.partial(mp, cfg, tp) if cfg.use_mla \
            else attn.partial(mp, cfg, tp)
    if kind == "mamba":
        return mp["out_proj"].shape[0] < cfg.d_inner
    if kind == "mlstm":
        return mp["down_proj"].shape[0] < 2 * cfg.d_model
    return mp["w_x"].shape[-1] < 4 * cfg.d_model             # sLSTM


def _ffn_partial(cfg: ArchConfig, ffn_kind: str, fp, tp) -> bool:
    """Whether a rank's FFN output is its part of a sum over the ranks."""
    if tp is None:
        return False
    if ffn_kind == "moe":
        return moe_mod.partial_sum(fp, cfg)
    return fp["w_down"].shape[0] < cfg.dense_d_ff


def _block(params, cfg: ArchConfig, ffn_kind: str, x: torch.Tensor,
           flags: RuntimeFlags,
           mixer: Callable[[Any, torch.Tensor], torch.Tensor],
           memory_kv: Optional[Dict[str, torch.Tensor]] = None,
           kind: str = "attn"):
    """One pre-norm block: the mixer, then (in a decoder layer given its
    memory K/V) the cross-attention block, then (where the layer has
    one) a SwiGLU or MoE FFN.  Returns (x, the MoE layer's load-balance
    loss, or None for any other layer).  On a tensor-parallel rank the
    mixer's output projection and the FFN's down projection contract
    this rank's heads, mixer channels, FFN columns or experts:
    ``tp_reduce`` sums them over the ranks before each residual add.  A
    block whose width the rules left whole (``kind``'s mixer, the cross
    attention, the FFN) computes it whole on every rank and is not
    summed."""
    tp = flags.tp
    h = rms_norm(params["norm1"], x, cfg.norm_eps, flags.fused_rmsnorm)
    x = x + tp_reduce(mixer(params["mixer"], h), flags,
                      _mixer_partial(cfg, kind, params["mixer"], tp))
    if "cross" in params and memory_kv is not None:
        hc = rms_norm(params["cross_norm"], x, cfg.norm_eps,
                      flags.fused_rmsnorm)
        x = x + tp_reduce(
            _cross_attention(params["cross"], hc, memory_kv, cfg, tp),
            flags, tp is not None and attn.partial(params["cross"], cfg, tp))
    if "ffn" not in params:
        return x, None
    h2 = rms_norm(params["norm2"], x, cfg.norm_eps, flags.fused_rmsnorm)
    sums = _ffn_partial(cfg, ffn_kind, params["ffn"], tp)
    if ffn_kind == "moe":
        y, aux = moe_mod.moe_apply(params["ffn"], cfg, h2, flags)
        return x + tp_reduce(y, flags, sums), aux
    return x + tp_reduce(mlp_apply(params["ffn"], h2), flags, sums), None


def layer_apply(params, cfg: ArchConfig, ffn_kind: str, x: torch.Tensor,
                flags: RuntimeFlags,
                mixer: Callable[[Any, torch.Tensor], torch.Tensor],
                memory_kv: Optional[Dict[str, torch.Tensor]] = None,
                kind: str = "attn") -> torch.Tensor:
    """The serving layer (:func:`_block`): ``mixer(mixer_params, h)`` is
    the mixer of the entry point (prefill, extend, slot, paged or hybrid
    decode), which writes its cache in place.  A MoE layer's
    load-balance loss is dropped: serving has no use for it."""
    return _block(params, cfg, ffn_kind, x, flags, mixer, memory_kv,
                  kind)[0]


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """[..., padded vocab] logits, pad columns masked.  Under a
    tensor-parallel rank group ``tp`` the head is this rank's vocab
    slice: its columns are masked where they are pad, written into a
    zero buffer of the whole padded vocab and summed over the ranks
    (exact: one non-zero term a column); a vocabulary the ranks do not
    divide is whole on every rank."""
    if cfg.tie_embeddings:
        logits = linear(x, params["embed"]["embedding"].t())
    else:
        logits = lm_head_apply(params["lm_head"], x)
    tp = cut(tp, logits.shape[-1], cfg.padded_vocab)
    off = 0 if tp is None else tp.rank * logits.shape[-1]
    pad = cfg.vocab_size - off
    if pad < logits.shape[-1]:
        # mask pad columns so softmax mass stays on the real vocab
        logits[..., max(pad, 0):] = -1e30
    if tp is None:
        return logits
    full = logits.new_zeros(logits.shape[:-1] + (cfg.padded_vocab,))
    full[..., off:off + logits.shape[-1]] = logits
    return tp.all_reduce(full)


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor,
           flags: RuntimeFlags) -> torch.Tensor:
    """The tokens' embeddings: vocab-parallel where the rules cut the
    vocabulary, else whole."""
    emb = params["embed"]["embedding"]
    return embed_apply(params["embed"], tokens, DTYPES[cfg.dtype],
                       cut(flags.tp, emb.shape[0], cfg.padded_vocab))


def _whole_prefix(cfg: ArchConfig, arena, ref: paging.PrefixRef,
                  prefix_len: int, tp) -> Dict[str, torch.Tensor]:
    """``paging.gather_prefix_kv`` of an attention layer's cache: on a
    tensor-parallel rank made whole where the rank holds a cut of it.
    Lanes cut on head_dim (or MLA's lora rank) and positions cut on the
    sequence (``seq_cut``) go into zeros at their places and are summed
    over the ranks in one exact all-reduce.  On the kv-heads arm the
    prefix is the rank's heads and stays as it is."""
    seq = [k for k in sorted(arena) if seq_cut(cfg, k, tp)]
    pkv = paging.gather_prefix_kv({k: a for k, a in arena.items()
                                   if k not in seq}, ref, prefix_len)
    if tp is None:
        return pkv
    # one order on every rank: the all-reduce adds the ranks' buffers
    # element by element
    cuts = {}
    for key in seq:
        pos, rows = paging.prefix_positions(arena[key], ref, prefix_len, tp)
        cuts[key] = placed(rows, 1, pos, prefix_len)
    for key in sorted(pkv):
        a = pkv[key]
        if (key == "c_kv" and a.shape[-1] < cfg.kv_lora_rank) or (
                key in ("k", "v") and attn.kv_arm(cfg, tp) == "head_dim"):
            n = a.shape[-1]
            cuts[key] = placed(a, a.dim() - 1, own_range(n, tp, a.device),
                               n * tp.size)
    if cuts:
        pkv.update(zip(cuts, tp_reduce_parts(list(cuts.values()), tp)))
    return pkv


def _run_groups(params, cfg, x, caches, flags, groups, mixer, memory=None):
    """Every layer in order: the dense head layers, then the stacked
    groups.  ``caches`` names whole cache trees (``{"cache": cache}``,
    or several such as a prefix arena and the rows an extend writes);
    head layer ``layer{i}`` of kind ``kind`` runs ``mixer(kind,
    mixer_params, h, c, "layer{i}")`` with ``c`` each tree's
    ``head_layers``, and layer ``lj`` of group ``r`` runs it with ``c``
    each tree's ``blocks`` sliced at ``r`` and the name ``"lj"``.  A
    group layer's cross attention attends over ``memory(layer_params,
    c, "lj")``'s K/V (none: the block is skipped)."""
    head, pattern, R = group_structure(cfg)
    for i, (kind, ffn) in enumerate(head):
        name = f"layer{i}"
        c = {k: tree["head_layers"] for k, tree in caches.items()}
        x = layer_apply(
            params["head_layers"][name], cfg, ffn, x, flags,
            lambda mp, h, c=c, n=name, k=kind: mixer(k, mp, h, c, n),
            kind=kind)
    if not R:
        return x
    groups = groups if groups is not None \
        else unstack_groups(params["blocks"], R)
    per_tree = {k: unstack_groups(tree["blocks"], R)
                for k, tree in caches.items()}
    cache_groups = [{k: g[r] for k, g in per_tree.items()}
                    for r in range(R)]
    for r in range(R):
        c = cache_groups[r]
        for j, (kind, ffn) in enumerate(pattern):
            name, lp = f"l{j}", groups[r][f"l{j}"]
            x = layer_apply(
                lp, cfg, ffn, x, flags,
                lambda mp, h, n=name, k=kind: mixer(k, mp, h, c, n),
                memory(lp, c, name) if memory is not None else None, kind)
    return x


def _last_logits(params, cfg, x, flags):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    return _logits(params, cfg, x[:, -1:], flags.tp)[:, 0]


def commit_state(dst: Dict[str, torch.Tensor],
                 src: Dict[str, torch.Tensor],
                 rows: Optional[torch.Tensor] = None) -> None:
    """Write a recurrent state into cache leaves, in place; with ``rows``
    ([B] bool) only those rows, the others keep their old state
    bitwise (the JAX ``commit_state``'s ``state_mask``)."""
    for k, a in dst.items():
        new = src[k]
        if rows is not None:
            m = rows.reshape((-1,) + (1,) * (new.ndim - 1))
            new = torch.where(m, new, a.to(new.dtype))
        a.copy_(new)


def encode(params, cfg: ArchConfig, enc_embeds: torch.Tensor,
           flags: RuntimeFlags = DEFAULT_FLAGS) -> torch.Tensor:
    """The bidirectional encoder of an encoder-decoder over stub frame
    embeddings [B, T, d], cast to the model dtype: GQA self-attention
    with RoPE at 0 .. T-1 and no mask, in plain PyTorch
    (``chunked_attention``), and a SwiGLU FFN in each layer, then the
    final norm.  Returns the memory [B, T, d].  Its norms take
    ``fused_rmsnorm`` like every other norm of the port (the JAX package
    calls them plain).  On a tensor-parallel rank each layer runs the
    rank's heads over whole K/V (its kv heads where they are cut) and
    its FFN columns, summed over the ranks as a decoder layer's are."""
    x = enc_embeds.to(DTYPES[cfg.dtype])
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    enc_cfg = dataclasses.replace(cfg, use_mla=False, num_experts=0,
                                  sliding_window=0)

    tp = flags.tp

    def bidirectional(mp, h):
        q, k, v = attn._qkv(mp, enc_cfg, h, positions)
        h0 = attn.rank_head0(mp, enc_cfg, tp)
        k, v = attn.kv_for_heads(k, v, enc_cfg, h0, q.shape[2])
        return attn.tp_out_proj(chunked_attention(q, k, v, causal=False),
                                mp, enc_cfg, attn.kv_arm(enc_cfg, tp), tp, h0)

    def layer(x, lp):
        return layer_apply(lp, enc_cfg, "dense", x, flags, bidirectional)

    enc = params["encoder"]
    for lp in unstack_groups(enc["blocks"], cfg.num_encoder_layers):
        x = remat(layer, x, lp) if flags.remat != "none" else layer(x, lp)
    return rms_norm(enc["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            flags: RuntimeFlags = DEFAULT_FLAGS):
    """The full sequence without a cache (training and evaluation, the
    JAX ``forward``): returns (logits [B, S, V], the summed MoE
    load-balance loss (f32 scalar), the final hidden states [B, S, d]).
    ``prefix_embeds`` [B, P, d] go before the tokens (S counts them);
    ``enc_embeds`` [B, T, d] are an encoder-decoder's encoder input,
    whose memory every decoder layer attends over.

    Differentiable on the plain path (``TRAIN_FLAGS``); with a kernel
    flag on, a kernel op raises under autograd (``ops.no_backward``) and
    runs under ``torch.no_grad``.  With ``remat="group"`` and grad on,
    each layer group (and each encoder layer) runs under an activation
    checkpoint, and the recurrent mixers checkpoint their chunks.

    On a training rank (``flags.train``) it is :func:`mesh_forward`."""
    if flags.train is not None:
        return mesh_forward(params, cfg, tokens, prefix_embeds, enc_embeds,
                            flags)
    dt = DTYPES[cfg.dtype]
    x = embed_apply(params["embed"], tokens, dt)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    memory = encode(params, cfg, enc_embeds, flags) \
        if enc_embeds is not None and cfg.is_encoder_decoder else None
    impl = "flash" if flags.use_flash else flags.attn_impl

    def mixer(kind):
        if kind in _APPLIES:
            return lambda mp, h: _APPLIES[kind](mp, cfg, h)[0]
        if cfg.use_mla:
            return lambda mp, h: mla_mod.mla_forward(mp, cfg, h, positions,
                                                     flags)[0]
        return lambda mp, h: attn.attention_forward(mp, cfg, h, positions,
                                                    impl)

    def layer(lp, kind, ffn, x, aux):
        mkv = cross_kv(lp["cross"], memory) \
            if memory is not None and "cross" in lp else None
        x, a = _block(lp, cfg, ffn, x, flags, mixer(kind), mkv)
        return x, aux + a if a is not None else aux

    head, pattern, R = group_structure(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, ffn) in enumerate(head):
        x, aux = layer(params["head_layers"][f"layer{i}"], kind, ffn, x,
                       aux)

    def group(x, aux, gp):
        for j, (kind, ffn) in enumerate(pattern):
            x, aux = layer(gp[f"l{j}"], kind, ffn, x, aux)
        return x, aux

    # the stacked leaves cut into their R groups once (``unbind``: the
    # backward stacks the groups' gradients in one pass)
    slices = {path: a.unbind(0) for path, a in
              flatten(params.get("blocks", {})).items()}
    for r in range(R):
        gp = unflatten({path: a[r] for path, a in slices.items()})
        x, aux = remat(group, x, aux, gp) if flags.remat != "none" \
            else group(x, aux, gp)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    return _logits(params, cfg, x), aux, x


# ---------------------------------------------------------------------------
# forward on a training mesh (ROADMAP item 11c-i)
# ---------------------------------------------------------------------------

def zero_gather(train, tree, prefix: str, stacked: bool = False):
    """The rank's leaves of ``tree`` (params under ``prefix``, a flat
    path of the template) gathered whole over the data line on each
    dimension the rules cut on ``data`` (ZeRO; a reduce-scatter of the
    gradient backward).  ``stacked``: the leaves are one group's slice
    of ``[R, ...]`` leaves, whose specs lead with the ``layers`` axis.
    Cuts on the model axis are kept."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}"
        if isinstance(v, dict):
            out[k] = zero_gather(train, v, path, stacked)
            continue
        spec = train.specs[path][1:] if stacked else train.specs[path]
        for dim, entry in enumerate(spec):
            if entry == "data":
                v = line_gather(v, train.data, dim)
        out[k] = v
    return out


def model_whole(train, tree, prefix: str, stacked: bool = False,
                parallel: bool = True):
    """The rank's leaves of ``tree`` (as :func:`zero_gather` takes them,
    gathered over data) whole on the model line: a leaf the rules cut on
    ``model`` all-gathered along that dimension (a fused axis block by
    block), every other leaf as it is.  ``parallel``: the ranks then
    compute different parts (their rows of the sequence), so a gathered
    leaf's gradient is reduce-scattered and a whole leaf's summed over
    the line (``line_enter``); else they compute alike, and a gathered
    leaf's gradient is the rank's slice."""
    line = train.model
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}"
        if isinstance(v, dict):
            out[k] = model_whole(train, v, path, stacked, parallel)
            continue
        spec = train.specs[path][1:] if stacked else train.specs[path]
        dims = [d for d, e in enumerate(spec) if e == "model"]
        for dim in dims:
            parts = train.parts[path] if dim == v.dim() - 1 else None
            v = line_gather(v, line, dim, summed=parallel, parts=parts)
        out[k] = v if dims or not parallel else line_enter(v, line)
    return out


def mesh_block(lp, cfg: ArchConfig, kind: str, ffn_kind: str,
               x: torch.Tensor, positions: torch.Tensor, flags: RuntimeFlags,
               memory: Optional[torch.Tensor] = None, path: str = "",
               stacked: bool = False):
    """One pre-norm block on a training rank, its weights gathered over
    data (``lp``; ``path`` and ``stacked`` name them in the template):
    the mixer of ``kind`` on the model line — GQA attention
    (``attention.mesh_attention``), MLA (``mla.mesh_forward``), Mamba on
    its channels (``mamba.mamba_apply(..., line=)``), the mLSTM's arm
    (``xlstm.mesh_mlstm``) or the sLSTM whole on every rank (its cut
    leaves gathered) — the cross attention over ``memory`` where the
    layer has one, and the dense FFN (``layers.mesh_mlp``) or the MoE
    FFN (``moe.mesh_moe``).  x in and out: the same on every rank of the
    model line.  Returns (x, the MoE layer's load-balance loss or
    None)."""
    eps, fused = cfg.norm_eps, flags.fused_rmsnorm
    g = flags.train
    h = rms_norm(lp["norm1"], x, eps, fused)

    def gathered(parallel):
        return model_whole(g, lp["mixer"], f"{path}.mixer", stacked,
                           parallel)
    if kind == "mamba":
        y, _ = mam.mamba_apply(lp["mixer"], cfg, h, line=g.model)
    elif kind == "mlstm":
        y = xl.mesh_mlstm(lp["mixer"], cfg, h, flags, gathered)
    elif kind == "slstm":
        y, _ = xl.slstm_apply(gathered(False), cfg, h)
    elif cfg.use_mla:
        y = mla_mod.mesh_forward(lp["mixer"], cfg, h, positions, flags)
    else:
        y = attn.mesh_attention(lp["mixer"], cfg, h, positions, flags)
    x = x + y
    if "cross" in lp and memory is not None:
        hc = rms_norm(lp["cross_norm"], x, eps, fused)
        x = x + attn.mesh_attention(
            lp["cross"], dataclasses.replace(cfg, qk_norm=False), hc, None,
            flags, causal=False, window=0, memory=memory)
    if "ffn" not in lp:
        return x, None
    h2 = rms_norm(lp["norm2"], x, eps, fused)
    if ffn_kind == "moe":
        y, aux = moe_mod.moe_apply(lp["ffn"], cfg, h2, flags)
        return x + y, aux
    return x + mesh_mlp(lp["ffn"], h2, cfg.dense_d_ff, g.model), None


def mesh_encode(params, cfg: ArchConfig, enc_embeds: torch.Tensor,
                flags: RuntimeFlags) -> torch.Tensor:
    """:func:`encode` on a training rank: each layer's weights gathered
    over data as it runs (under the layer's activation checkpoint), its
    bidirectional attention through ``mesh_attention``."""
    g = flags.train
    x = enc_embeds.to(DTYPES[cfg.dtype])
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    enc_cfg = dataclasses.replace(cfg, use_mla=False, num_experts=0,
                                  sliding_window=0)

    def layer(x, local):
        lp = zero_gather(g, local, "encoder.blocks", stacked=True)
        h = rms_norm(lp["norm1"], x, cfg.norm_eps, flags.fused_rmsnorm)
        x = x + attn.mesh_attention(lp["mixer"], enc_cfg, h, positions,
                                    flags, causal=False, window=0)
        h2 = rms_norm(lp["norm2"], x, cfg.norm_eps, flags.fused_rmsnorm)
        return x + mesh_mlp(lp["ffn"], h2, cfg.dense_d_ff, g.model)

    enc = params["encoder"]
    for lp in unstack_groups(enc["blocks"], cfg.num_encoder_layers):
        x = remat(layer, x, lp) if flags.remat != "none" else layer(x, lp)
    norm = zero_gather(g, enc["final_norm"], "encoder.final_norm")
    return rms_norm(norm, x, cfg.norm_eps, flags.fused_rmsnorm)


def mesh_forward(params, cfg: ArchConfig, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None,
                 enc_embeds: Optional[torch.Tensor] = None,
                 flags: RuntimeFlags = DEFAULT_FLAGS):
    """:func:`forward` on a training rank (``flags.train``, its group):
    ``params`` are the rank's slices of the leaves
    (``sharding.rules.train_state_specs``), the inputs its rows of the
    batch.  Each layer's weights are gathered over the data line as the
    layer runs, inside its group's activation checkpoint (so the
    backward gathers them again, and reduce-scatters their gradients),
    never all at once; the embedding, the final norm and the LM head
    are gathered once.  The attention heads or query rows, the FFN's
    ``mlp`` columns, the experts and the vocabulary run on the model
    line through the autograd collectives of ``sharding/group.py``.
    Returns (the rank's logits [B_l, S, V/mp] (its vocabulary columns,
    the pad columns masked; all of them where the rules leave the
    vocabulary whole), the summed load-balance loss of the global batch,
    the final hidden states [B_l, S, d])."""
    g = flags.train
    dt = DTYPES[cfg.dtype]
    emb = zero_gather(g, params["embed"], "embed")["embedding"]
    vocab = g.model if emb.shape[0] < cfg.padded_vocab else None
    x = mesh_embed(emb, tokens, dt, vocab)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    memory = mesh_encode(params, cfg, enc_embeds, flags) \
        if enc_embeds is not None and cfg.is_encoder_decoder else None
    head, pattern, R = group_structure(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, kind, ffn, x, aux, path, r=None):
        # the layer's name for the rank's records (``moe.mesh_moe``)
        g.layer = path if r is None else f"{path}.{r}"
        lp = zero_gather(g, lp, path, stacked=r is not None)
        x, a = mesh_block(lp, cfg, kind, ffn, x, positions, flags,
                          memory if "cross" in lp else None, path,
                          r is not None)
        return x, aux + a if a is not None else aux

    for i, (kind, ffn) in enumerate(head):
        x, aux = layer(params["head_layers"][f"layer{i}"], kind, ffn, x,
                       aux, f"head_layers.layer{i}")

    def group(x, aux, gp, r):
        for j, (kind, ffn) in enumerate(pattern):
            x, aux = layer(gp[f"l{j}"], kind, ffn, x, aux, f"blocks.l{j}",
                           r)
        return x, aux

    slices = {path: a.unbind(0) for path, a in
              flatten(params.get("blocks", {})).items()}
    for r in range(R):
        gp = unflatten({path: a[r] for path, a in slices.items()})
        fn = functools.partial(group, r=r)
        x, aux = remat(fn, x, aux, gp) if flags.remat != "none" \
            else fn(x, aux, gp)
    norm = zero_gather(g, params["final_norm"], "final_norm")
    x = rms_norm(norm, x, cfg.norm_eps, flags.fused_rmsnorm)
    w = emb.t() if cfg.tie_embeddings else \
        zero_gather(g, params["lm_head"], "lm_head")["w"]
    if cfg.mtp_depth:
        # the MTP head's embedding and logits use the same gathers
        g.vocab = (emb, w)
    return _mesh_logits(cfg, x, g, w), aux, x


def _mesh_logits(cfg: ArchConfig, x: torch.Tensor, g,
                 w: torch.Tensor) -> torch.Tensor:
    """The rank's vocabulary columns of the logits of x [B_l, S, d] (all
    of them where the rules leave the vocabulary whole), the pad columns
    masked; ``w`` the head [d, V'] gathered over data."""
    vocab = g.model if w.shape[-1] < cfg.padded_vocab else None
    logits = linear(line_enter(x, vocab), w)
    off = 0 if vocab is None else vocab.index * w.shape[-1]
    pad = cfg.vocab_size - off
    if pad < logits.shape[-1]:
        # mask pad columns so softmax mass stays on the real vocab
        logits[..., max(pad, 0):] = -1e30
    return logits


def mesh_mtp_logits(params, cfg: ArchConfig, hidden: torch.Tensor,
                    tokens: torch.Tensor, flags: RuntimeFlags
                    ) -> torch.Tensor:
    """:func:`mtp_logits` on a training rank: the embedding of token t+1
    from the vocabulary-parallel embedding, ``proj`` and the norm
    gathered over data, the block through :func:`mesh_block` (MLA and
    its FFN) under an activation checkpoint, and the rank's vocabulary
    columns of the logits (as :func:`mesh_forward`'s).  The embedding and
    the head are the ones :func:`mesh_forward` gathered for this step
    (``g.vocab``), so each is gathered, and its gradient reduce-scattered,
    once a step."""
    g = flags.train
    dt = DTYPES[cfg.dtype]
    B, S, d = hidden.shape
    emb, w = g.vocab
    nxt = mesh_embed(emb, tokens, dt,
                     g.model if emb.shape[0] < cfg.padded_vocab else None)
    nxt = torch.cat([nxt[:, 1:], nxt.new_zeros((B, 1, d))], dim=1)
    mtp = zero_gather(g, {k: params["mtp"][k] for k in ("proj", "norm")},
                      "mtp")
    h = linear(torch.cat([hidden.to(dt), nxt], dim=-1), mtp["proj"])
    h = rms_norm(mtp["norm"], h, cfg.norm_eps, flags.fused_rmsnorm)
    positions = torch.arange(S, device=h.device).expand(B, S)
    block = params["mtp"]["block"]
    ffn = "moe" if "router" in block.get("ffn", {}) else "dense"

    def run(h, block):
        g.layer = "mtp.block"
        lp = zero_gather(g, block, "mtp.block")
        return mesh_block(lp, cfg, "attn", ffn, h, positions, flags,
                          path="mtp.block")[0]
    h = remat(run, h, block) if flags.remat != "none" else run(h, block)
    return _mesh_logits(cfg, h, g, w)


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            max_cache_len: int, flags: RuntimeFlags = DEFAULT_FLAGS,
            groups=None, prefix_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None):
    """Run the prompt [B, S]; return (last-token logits [B, V], cache).
    ``groups`` are per-group param views (``unstack_groups``), made here
    when not given.  ``prefix_embeds`` [B, P, d] (a modality stub's
    patch embeddings), cast to the model dtype, go before the tokens'
    embeddings, and positions run over both: the cache holds P + S
    rows.  ``enc_embeds`` [B, T, d] (an encoder-decoder's stub frame
    embeddings) are encoded into the memory whose K/V each decoder layer
    attends over and stores under ``cross``; without them the decoder
    runs without cross attention and its cache holds no ``cross``
    leaves, as in JAX."""
    dt = DTYPES[cfg.dtype]
    x = _embed(params, cfg, tokens, flags)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    memory = None
    if enc_embeds is not None and cfg.is_encoder_decoder:
        # a rank's memory path in blocks of 32 rows: each row's memory
        # and cross K/V the same alone and in a batch
        with rows_padded("all" if flags.tp is not None else False):
            memory = encode(params, cfg, enc_embeds, flags)
    cache = new_cache(cfg, B, max_cache_len, x.device,
                      0 if memory is None else memory.shape[1],
                      _mesh(flags))
    if memory is None:
        for layer in cache.get("blocks", {}).values():
            layer.pop("cross", None)

    cross_arm = attn.kv_arm(cfg, flags.tp)

    def cross(lp, c, name):
        # the rank's slice lands in the cache, which every step then
        # attends over alike
        held = c["cache"][name]["cross"]
        with rows_padded("all" if flags.tp is not None else False):
            kv = cross_kv(lp["cross"], memory)
        for k, a in kv.items():
            held[k].copy_(attn.rank_slice(a, cross_arm, flags.tp))
        return held

    def mixer(kind, mp, h, c, name):
        live = c["cache"][name]["mixer"]
        if kind == "attn":
            into = mla_mod.prefill_into_cache if cfg.use_mla \
                else attn.prefill_into_cache
            return into(mp, cfg, h, positions, live, flags)
        # the zero state ``live`` holds (a rank's slice of it on a mesh)
        y, state = _PREFILLS[kind](mp, cfg, h, live, tp=flags.tp)
        commit_state(live, state)
        return y

    x = _run_groups(params, cfg, x, {"cache": cache}, flags, groups, mixer,
                    cross if memory is not None else None)
    return _last_logits(params, cfg, x, flags), cache


def prefill_extend(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                   prefix_ref: paging.PrefixRef, prefix_len: int,
                   max_cache_len: int, flags: RuntimeFlags = DEFAULT_FLAGS,
                   groups=None, slots: Optional[torch.Tensor] = None):
    """Prefill a prompt *suffix* against the request's cached prefix.

    tokens: [B, S'] — the prompt tokens from position ``prefix_len`` on;
    ``prefix_ref`` names where the prefix K/V lives (``paging.
    PagedPrefix`` — the arena through a block table, ``prefix_len`` a
    multiple of its block size — or ``paging.SlotPrefix`` — contiguous
    slot rows).  One entry point serves prefix-shared and chunked
    prefill on every layout.  Attention layers attend over their
    gathered prefix K/V and emit the suffix's K/V as cache rows ``[R, B,
    max_cache_len, KV, hd]`` (suffix at row positions ``0 .. S' - 1``,
    zero beyond); recurrent layers instead *continue the sequential
    state scan* from their slab rows at ``slots`` ([B] int, required for
    such stacks) and emit the state after the last suffix token as
    ``[R, B, ...]`` rows.  ``cache`` is only read.  Returns (last-token
    logits [B, V], rows).  On a tensor-parallel rank the prefix is
    gathered whole where the rank holds a cut of it (one all-reduce a
    layer) and the rows keep every position (``WHOLE_SEQ``): the
    layout's writer keeps the rank's own.  The suffix's outputs are
    bitwise those of a
    cold prefill of the whole prompt (row-independent attention,
    chunk-invariant state scans).  An encoder-decoder is refused
    (``check_mixed_extend_support``), as in JAX."""
    check_mixed_extend_support(cfg)
    x = _embed(params, cfg, tokens, flags)
    B, S_, _ = x.shape
    positions = (prefix_len + torch.arange(S_, device=x.device)).expand(B, S_)
    rows = new_cache(cfg, B, max_cache_len, x.device, mesh=_mesh(flags),
                     rules=WHOLE_SEQ)

    def mixer(kind, mp, h, c, name):
        out = c["rows"][name]["mixer"]
        if kind == "attn":
            pkv = _whole_prefix(cfg, c["arena"][name]["mixer"],
                                prefix_ref, prefix_len, flags.tp)
            extend = mla_mod.prefill_extend_into_cache if cfg.use_mla \
                else attn.prefill_extend_into_cache
            y, kv = extend(mp, cfg, h, positions, pkv, prefix_len, flags)
            for k, a in kv.items():
                out[k][:, :S_] = a
            return y
        # recurrent: resume the state scan from the slab rows
        init = {k: a[slots.long()]
                for k, a in c["arena"][name]["mixer"].items()}
        y, state = _WINDOWS[kind](mp, cfg, h, init, tp=flags.tp)
        commit_state(out, state)
        return y

    x = _run_groups(params, cfg, x, {"arena": cache, "rows": rows},
                    flags, groups, mixer)
    return _last_logits(params, cfg, x, flags), rows


def _slot_max_len(cfg: ArchConfig, cache) -> int:
    """The row length of a slot cache's GQA attention layers (0 when the
    stack has none)."""
    for path, a in flatten(cache).items():
        if path.endswith(".mixer.k"):
            return a.shape[-3]
    return 0


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                cache_pos: torch.Tensor, flags: RuntimeFlags = DEFAULT_FLAGS,
                all_logits: bool = False, groups=None,
                block_tables: Optional[torch.Tensor] = None,
                state_mask: Optional[torch.Tensor] = None,
                want_state_stacks: bool = False, stacks=None):
    """One decode step.  tokens: [B, S'] (S' = 1 for plain decode; S' > 1
    scores a speculative verify window); ``cache_pos`` is a [B] int32
    vector of per-row offsets (window token s of row b sits at
    ``cache_pos[b] + s``).  ``block_tables`` ([B, P] int32) switches the
    attention layers to the paged layout (paged or hybrid): ``cache``
    holds block-pool arenas and each row's K/V is reached through its
    table.  Writes the window into ``cache`` in place and returns
    (logits, cache): [B, V] at the first window position, or [B, S', V]
    with ``all_logits=True``.

    Recurrent layers overwrite their whole state on every step.
    ``state_mask`` ([B] bool) commits only its rows' new state; the
    others keep theirs bitwise (a batched decode tick must not touch
    the ingest-frontier state of rows mid chunked prefill).  With
    ``want_state_stacks`` no state is committed: the state after every
    window position goes to ``stacks`` (buffers of
    :func:`new_state_stacks`, written in place; made here when not
    given), and the return becomes (logits, cache, stacks) — the
    speculative verify's rewind commits the accepted prefix's entry.

    A decoder layer whose cache holds ``cross`` memory K/V attends over
    it; it is only read."""
    x = _embed(params, cfg, tokens, flags)
    B, S_q = x.shape[0], x.shape[1]
    pos = cache_pos.to(torch.int32).contiguous()
    if want_state_stacks and stacks is None:
        stacks = new_state_stacks(cfg, cache, S_q)
    if cfg.use_mla:
        # the latent path: weight absorption over c_kv / k_rope
        if block_tables is not None:
            tables = block_tables.to(torch.int32).contiguous()

            def attend(mp, h, c):
                return mla_mod.paged_decode(mp, cfg, h, c, pos, tables,
                                            flags)
        else:
            def attend(mp, h, c):
                return mla_mod.slot_decode(mp, cfg, h, c, pos, flags)
    elif attn.kv_arm(cfg, flags.tp) in ("head_dim", "seq"):
        # K/V cut on head_dim or on the sequence: the plain attention
        tables = None if block_tables is None \
            else block_tables.to(torch.int32).contiguous()

        def attend(mp, h, c):
            return attn.tp_decode(mp, cfg, h, c, pos, tables, flags)
    elif block_tables is not None:
        tables = block_tables.to(torch.int32).contiguous()
        freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, x.device)

        def attend(mp, h, c):
            return attn.paged_decode(mp, cfg, h, c, pos, tables, freqs,
                                     flags)
    elif cfg.sliding_window:
        # wrapping slot rows: the plain gather path, as in JAX
        def attend(mp, h, c):
            return attn.window_decode(mp, cfg, h, c, pos, flags)
    else:
        freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, x.device)
        max_len = _slot_max_len(cfg, cache)
        tables = paging.slot_arena_tables(
            B, max_len, paging.fused_page_size(max_len), x.device) \
            if max_len else None

        def attend(mp, h, c):
            return attn.fused_slot_decode(mp, cfg, h, c, pos, tables, freqs,
                                          flags)

    def mixer(kind, mp, h, c, name):
        live = c["cache"][name]["mixer"]
        if kind == "attn":
            return attend(mp, h, live)
        if want_state_stacks:
            return _WINDOWS[kind](mp, cfg, h, live,
                                  c["stacks"][name]["mixer"],
                                  tp=flags.tp)[0]
        y, state = _WINDOWS[kind](mp, cfg, h, live, tp=flags.tp)
        commit_state(live, state, state_mask)
        return y

    trees = {"cache": cache}
    if want_state_stacks:
        trees["stacks"] = stacks
    x = _run_groups(params, cfg, x, trees, flags, groups, mixer,
                    lambda lp, c, name: c["cache"][name].get("cross"))
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, flags.fused_rmsnorm)
    logits = _logits(params, cfg, x, flags.tp)
    logits = logits if all_logits else logits[:, 0]
    if want_state_stacks:
        return logits, cache, stacks
    return logits, cache


def mtp_logits(params, cfg: ArchConfig, hidden: torch.Tensor,
               tokens: torch.Tensor, flags: RuntimeFlags = DEFAULT_FLAGS
               ) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction head (depth 1): the final
    hidden state at position t with the embedding of token t+1 predicts
    token t+2.  hidden: [B, S, d]; tokens: [B, S]; returns [B, S, V].
    Its block runs MLA's prefill arm with no cache; its norm takes
    ``fused_rmsnorm`` like every other norm of the port (the JAX
    package calls it plain)."""
    dt = DTYPES[cfg.dtype]
    B, S, d = hidden.shape
    nxt = embed_apply(params["embed"], tokens, dt)
    nxt = torch.cat([nxt[:, 1:], nxt.new_zeros((B, 1, d))], dim=1)
    h = linear(torch.cat([hidden.to(dt), nxt], dim=-1),
               params["mtp"]["proj"])
    h = rms_norm(params["mtp"]["norm"], h, cfg.norm_eps, flags.fused_rmsnorm)
    positions = torch.arange(S, device=h.device).expand(B, S)
    block = params["mtp"]["block"]
    ffn = "moe" if "router" in block.get("ffn", {}) else "dense"
    # the one configuration with an MTP head (deepseek_v3) attends by MLA
    h = layer_apply(block, cfg, ffn, h, flags,
                    lambda mp, x: mla_mod.mla_forward(mp, cfg, x, positions,
                                                      flags)[0])
    return _logits(params, cfg, h)
