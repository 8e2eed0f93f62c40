"""Model facade: one ``nn.Module`` per architecture holding its weights,
with the full-sequence ``forward`` (training and evaluation), prefill /
prefix-extend / decode and the caches of every layout.

The weights are registered under the JAX param-tree paths, so
``state_dict()`` keys read ``blocks.l0.mixer.wq`` (and
``head_layers.layer0.mixer.wq_a``, ``mtp.proj`` where the architecture
has a dense head and a multi-token prediction head) and the stacked
``[R, ...]`` leaves keep their JAX shapes; ``params_from_jax`` output
loads as it is.

On a tensor-parallel serving mesh (``launch/mesh.py``) a ``Model`` holds
one rank's slice of each weight, cut by the rules' ``param_specs``
(``sharding/rules.py``): its heads, FFN columns, experts, mixer channels
and vocabulary rows, a fused projection block by block
(``ParamSpec.parts``), the norms whole; its caches hold the rank's kv
heads and its slice of each recurrent state.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from . import transformer as tf
from .config import ArchConfig, InputShape
from .layers import rows_padded
from .params import DTYPES, _init_leaf, flatten, unflatten
from ..sharding.rules import owned, param_parts, param_specs, shard_tensor


class _Node(nn.Module):
    """A container module: one per inner node of the param tree."""


def _rank_products(flags: tf.RuntimeFlags):
    """A tensor-parallel rank pads its products of few rows
    (``layers.rows_padded``), so that a decode tick's rows do not follow
    the batch's row count; elsewhere the products are as they are."""
    return rows_padded(flags.tp is not None)


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Without one, only an explicit
    ``device="cpu"`` runs: nothing moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None, rank: int = 0):
        """Random weights from ``seed`` (a ``torch.Generator`` on
        ``device``), or ``params``: a flat ``state_dict`` such as
        ``params_from_jax`` returns, moved to ``device``.  ``device=None``
        is the card, as for ``LLMEngine`` (:func:`resolve_device`).

        With a serving ``mesh`` the model holds rank ``rank``'s slice of
        every leaf (``param_specs``): the full tree is drawn from
        ``seed`` as without a mesh, leaf by leaf, and each leaf cut to
        the rank's slice as it is drawn, so the ranks together hold the
        unsharded model's bits; ``params`` (the full tree) is cut the
        same way."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.template = tf.model_template(cfg)
        self.mesh = mesh if mesh is not None and mesh.shape["model"] > 1 \
            else None
        specs = flatten(param_specs(self.template, self.mesh)) \
            if self.mesh is not None else None
        parts = param_parts(self.template)

        def local(path, t):
            if specs is None:
                return t
            return owned(shard_tensor(t, specs[path], self.mesh, rank,
                                      parts[path]))

        if params is None and device.type == "meta":
            # the abstract model: shapes and dtypes only, nothing drawn (a
            # generator cannot live on ``meta``)
            dt = DTYPES[cfg.dtype]
            tree = unflatten({path: local(path, torch.empty(
                spec.shape, dtype=dt, device=device))
                for path, spec in flatten(self.template).items()})
        elif params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            dt = DTYPES[cfg.dtype]
            tree = unflatten({path: local(path, _init_leaf(spec, gen, dt,
                                                           device))
                              for path, spec in
                              flatten(self.template).items()})
        else:
            want = flatten(self.template)
            if set(params) != set(want):
                raise ValueError(
                    f"params do not match the {cfg.name} template: missing "
                    f"{sorted(set(want) - set(params))}, extra "
                    f"{sorted(set(params) - set(want))}")
            for path, spec in want.items():
                if tuple(params[path].shape) != spec.shape:
                    raise ValueError(f"{path}: shape "
                                     f"{tuple(params[path].shape)} != "
                                     f"{spec.shape}")
            tree = unflatten({k: local(k, params[k].to(device))
                              for k in want})
        self._register(self, tree)
        _, _, R = tf.group_structure(cfg)
        # per-layer-group views of the stacked leaves, made once
        self.groups = tf.unstack_groups(self.params["blocks"], R) \
            if R else []

    @staticmethod
    def _register(module: nn.Module, tree) -> None:
        for name, v in tree.items():
            if isinstance(v, dict):
                child = _Node()
                module.add_module(name, child)
                Model._register(child, v)
            else:
                module.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    @property
    def params(self):
        """The weights as a nested dict of tensors (the JAX tree)."""
        return unflatten(dict(self.named_parameters()))

    def abstract(self) -> Dict[str, Any]:
        """The whole parameter tree as ``meta`` tensors of the template's
        shapes and the config's dtype (JAX's ``Model.abstract``): no
        allocation, nothing drawn, the whole model even on a mesh."""
        dt = DTYPES[self.cfg.dtype]
        return unflatten({path: torch.empty(spec.shape, dtype=dt,
                                            device="meta")
                          for path, spec in flatten(self.template).items()})

    def param_count(self) -> int:
        """The whole model's parameter count, from the template (JAX's
        ``Model.param_count``): the same on every rank of a mesh."""
        return sum(math.prod(spec.shape)
                   for spec in flatten(self.template).values())

    def input_shapes_for(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        """``meta`` tensors of JAX's ``input_shapes_for`` shapes and dtypes:
        every model input of a step under ``shape``.  The modality stubs'
        embeddings arrive precomputed: an encoder-decoder's encoder
        frames ``enc_embeds`` [B, S, d] (its decoder prefills one token),
        a ``frontend``'s ``prefix_embeds`` [B, P, d] before S - P
        tokens."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, DTYPES[cfg.dtype]

        def meta(dims, dtype):
            return torch.empty(dims, dtype=dtype, device="meta")
        specs: Dict[str, torch.Tensor] = {}
        if shape.kind == "decode":
            specs["tokens"] = meta((B, 1), i32)
            return specs
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = meta((B, S, cfg.d_model), dt)
            specs["tokens"] = meta((B, S if shape.kind == "train" else 1),
                                   i32)
        elif cfg.frontend:
            P = cfg.num_prefix_embeddings
            specs["prefix_embeds"] = meta((B, P, cfg.d_model), dt)
            specs["tokens"] = meta((B, S - P), i32)
        else:
            specs["tokens"] = meta((B, S), i32)
        if shape.kind == "train":
            specs["labels"] = meta((B, S), i32)
        return specs

    # ---- compute ------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None,
                flags: tf.RuntimeFlags = tf.DEFAULT_FLAGS, params=None):
        """The full sequence without a cache (``transformer.forward``):
        (logits [B, S, V], aux, hidden [B, S, d]) from ``params`` (a
        tree of the template's leaves, such as a ``TrainState``'s), or
        from the module's own weights.  Not under ``no_grad``: the
        stacked leaves are cut into groups anew on every call, so
        autograd reaches them (``self.groups``, the serving entry
        points' views, were cut before any weight required grad).
        Gradients need the plain path (``transformer.TRAIN_FLAGS``) and
        weights that require grad: ``make_train_step`` turns that on."""
        return tf.forward(self.params if params is None else params,
                          self.cfg, tokens, prefix_embeds, enc_embeds, flags)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_cache_len: int,
                flags: tf.RuntimeFlags = tf.DEFAULT_FLAGS,
                prefix_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None):
        """``prefix_embeds`` [B, P, d] go before the tokens;
        ``enc_embeds`` [B, T, d] are an encoder-decoder's encoder input
        (``transformer.prefill``)."""
        with _rank_products(flags):
            return tf.prefill(self.params, self.cfg, tokens, max_cache_len,
                              flags, groups=self.groups,
                              prefix_embeds=prefix_embeds,
                              enc_embeds=enc_embeds)

    @torch.no_grad()
    def prefill_extend(self, tokens: torch.Tensor, cache, prefix_ref,
                       prefix_len: int, max_cache_len: int,
                       flags: tf.RuntimeFlags = tf.DEFAULT_FLAGS,
                       slots=None):
        with _rank_products(flags):
            return tf.prefill_extend(self.params, self.cfg, tokens, cache,
                                     prefix_ref, prefix_len, max_cache_len,
                                     flags, groups=self.groups, slots=slots)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache, cache_pos,
                    flags: tf.RuntimeFlags = tf.DEFAULT_FLAGS,
                    all_logits: bool = False, block_tables=None,
                    state_mask=None, want_state_stacks: bool = False,
                    stacks=None):
        with _rank_products(flags):
            return tf.decode_step(self.params, self.cfg, tokens, cache,
                                  cache_pos, flags, all_logits=all_logits,
                                  groups=self.groups,
                                  block_tables=block_tables,
                                  state_mask=state_mask,
                                  want_state_stacks=want_state_stacks,
                                  stacks=stacks)

    @torch.no_grad()
    def mtp_logits(self, hidden: torch.Tensor, tokens: torch.Tensor,
                   flags: tf.RuntimeFlags = tf.DEFAULT_FLAGS):
        """The multi-token prediction head's logits [B, S, V] from the
        final hidden states [B, S, d] and the tokens [B, S]."""
        return tf.mtp_logits(self.params, self.cfg, hidden, tokens, flags)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def new_cache(self, batch: int, max_len: int, enc_len: int = 0):
        """Zeroed cache of the JAX ``abstract_cache`` shapes: the slot
        layout's, and the state layout's (a recurrent layer's slot cache
        already is its O(1) state slab); an encoder-decoder's holds
        ``enc_len`` memory rows of cross-attention K/V a layer."""
        return tf.new_cache(self.cfg, batch, max_len, self.device, enc_len,
                            self.mesh)

    def new_paged_cache(self, num_blocks: int, block_size: int):
        """Zeroed block-pool arena of the JAX ``abstract_paged_cache``
        shapes (block 0 is the trash block)."""
        return tf.new_paged_cache(self.cfg, num_blocks, block_size,
                                  self.device, self.mesh)

    def new_hybrid_cache(self, num_slots: int, num_blocks: int,
                         block_size: int):
        """Zeroed hybrid layout (the JAX ``abstract_hybrid_cache``):
        paged attention arenas and ``num_slots``-row state slabs."""
        return tf.new_hybrid_cache(self.cfg, num_slots, num_blocks,
                                   block_size, self.device, self.mesh)

    def new_state_stacks(self, cache, width: int):
        """Zeroed verify-window stack buffers for ``cache``."""
        return tf.new_state_stacks(self.cfg, cache, width)

    def layer_kind_of_path(self, path) -> str:
        return tf.layer_kind_of_path(self.cfg, path)
