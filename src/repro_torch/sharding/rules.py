"""Logical-axis → mesh-axis sharding rules: the JAX package's
``sharding/rules.py`` without JAX.

A spec is a tuple with one entry per dimension — a mesh-axis name, a
tuple of names, or ``None`` (replicated) — with trailing ``None``
entries trimmed, as JAX trims a ``PartitionSpec``.  Meshes are read
duck-typed: ``mesh.shape`` maps axis names to sizes and
``mesh.axis_names`` lists them (``launch/mesh.py``'s
:class:`~repro_torch.launch.mesh.ServingMesh` or
:class:`~repro_torch.launch.mesh.TrainingMesh`, or any stand-in).

``resolve_spec`` is deliberately defensive: a logical axis is only mapped
to a mesh axis if the dimension is divisible by the axis size and the
mesh axis has not been claimed by an earlier dimension of the same
tensor — otherwise that dimension is replicated.

Rule summary (single-pod mesh ("data","model"); multi-pod adds "pod"):
  params:  embed→data, heads/mlp/experts/vocab/ssm_inner→model
  decode caches: batch→(pod,data); K/V on kv_heads, else head_dim, else
  the sequence (``_kv_cache_axes``)

On top of the specs, :func:`local_shape` and :func:`shard_tensor` give a
rank's slice (of a fused projection, its slice of each block),
:func:`place` puts the ranks' slices back together, and
:func:`shard_state_dict` cuts a full ``state_dict`` into one rank's
weights.  A training mesh's state follows :func:`train_state_specs`
(a rank's shapes: :func:`local_train_state_shapes`; its slices of a
whole state: :func:`local_train_state`) and its batch
:func:`batch_specs`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.params import flatten, tree_map, unflatten
from ..optim.optimizers import _factored
from .group import mesh_coords

Spec = Tuple[Any, ...]

# logical axis -> mesh axis (or "batch" placeholder resolved per mesh)
RULES: Dict[str, Any] = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "experts_vec": "model",
    "ssm_inner": "model",
    "ssm_inner_vec": "model",
    "ssm_inner_b": None,
    "embed_b": None,
    "q_lora": None,
    "kv_lora": None,
    "qk_dim": None,
    "layers": None,
    # activation / cache axes
    "batch": "__batch__",
    "seq": "model",
    "mlstm_dk": "model",
    "embed_sharded": "model",
    "kv_lora_sharded": "model",
    "head_dim_sharded": "model",
}


#: the rules with the sequence left whole: the rows a chunked prefill
#: writes hold every position of the chunk on every rank, and each
#: layout's writer keeps the rank's own (``runtime/steps.py``)
WHOLE_SEQ: Dict[str, Any] = dict(RULES, seq=None)


def _batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh-axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _names(axes))


def resolve_spec(shape: Tuple[int, ...],
                 axes: Tuple[Optional[str], ...],
                 mesh, rules: Optional[Dict[str, Any]] = None) -> Spec:
    rules = rules or RULES
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax) if ax else None
        if mesh_ax == "__batch__":
            mesh_ax = _batch_axes(mesh)
        if mesh_ax is None:
            parts.append(None)
            continue
        tup = _names(mesh_ax)
        # drop already-claimed axes; then check divisibility of the rest
        tup = tuple(a for a in tup if a not in used)
        if not tup or dim % _axis_size(mesh, tup) != 0:
            parts.append(None)
            continue
        used.update(tup)
        parts.append(tup[0] if len(tup) == 1 else tup)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_specs(template, mesh, rules=None):
    """The spec of every leaf of a param template (a nested dict of
    :class:`ParamSpec`)."""
    return tree_map(lambda s: resolve_spec(s.shape, s.axes, mesh, rules),
                    template)


class Factors(NamedTuple):
    """The specs (or shapes, or tensors) of an Adafactor leaf's factored
    second moment: the row statistics ``[..., R]`` and the column
    statistics ``[..., C]`` of a param ``[..., R, C]``."""
    row: Any
    col: Any


def factor_specs(shape, axes, mesh, rules=None) -> Factors:
    """A factored leaf's row and column specs by the JAX rule: each the
    spec ``resolve_spec`` gives its own dimensions (the row factor the
    param's but its last, the column factor its but the second to
    last), so that a column factor may cut its last dimension where the
    param, whose second to last dimension claimed the axis first, does
    not."""
    return Factors(resolve_spec(shape[:-1], axes[:-1], mesh, rules),
                   resolve_spec(shape[:-2] + shape[-1:],
                                axes[:-2] + axes[-1:], mesh, rules))


def train_state_specs(template, mesh, optimizer: str, rules=None):
    """The specs of a ``TrainState(params, OptState(step, m, v))`` (the
    JAX ``train_state_specs``): AdamW's ``m`` and ``v`` inherit each
    param's spec (ZeRO through ``embed→data``); Adafactor has no ``m``,
    and its ``v`` is a :class:`Factors` of :func:`factor_specs` where
    the leaf is factored, else the param's spec.  ``step`` is
    replicated."""
    from ..optim.optimizers import OptState
    from ..runtime.steps import TrainState
    pspec = param_specs(template, mesh, rules)
    if optimizer != "adafactor":
        return TrainState(pspec, OptState((), pspec, pspec))

    def v_spec(s):
        if _factored(s.shape):
            return factor_specs(s.shape, s.axes, mesh, rules)
        return resolve_spec(s.shape, s.axes, mesh, rules)
    return TrainState(pspec, OptState((), None, tree_map(v_spec, template)))


def batch_specs(batch_shapes: Dict[str, Tuple[int, ...]], mesh):
    """Each batch entry's spec (the JAX ``batch_specs``): its leading
    dimension on the batch axes (``("pod", "data")`` or ``("data",)``)
    where they divide it, else whole."""
    return {name: resolve_spec(tuple(shape),
                               ("batch",) + (None,) * (len(shape) - 1), mesh)
            for name, shape in batch_shapes.items()}


def state_leaves(opt) -> Dict[str, Any]:
    """The optimizer state's ``m`` and ``v`` leaves by flat path:
    ``m.<path>`` and ``v.<path>``, an Adafactor factor as
    ``v.<path>.0`` (rows) and ``v.<path>.1`` (columns), the keys of the
    checkpoint's index; works on trees of tensors, specs or shapes."""
    out = {}
    for name, tree in (("m", opt.m), ("v", opt.v)):
        for k, v in flatten(tree if tree is not None else {}).items():
            if isinstance(v, Factors) or (
                    isinstance(v, tuple) and v
                    and isinstance(v[0], torch.Tensor)):
                out[f"{name}.{k}.0"], out[f"{name}.{k}.1"] = v
            else:
                out[f"{name}.{k}"] = v
    return out


def local_train_state_shapes(template, mesh, optimizer: str,
                             rules=None) -> Dict[str, Tuple[int, ...]]:
    """A rank's shape of every leaf of a ``TrainState`` under
    :func:`train_state_specs`, by its flat path (``params.<path>``, and
    :func:`state_leaves`' keys for the moments, ``step``): the same for
    every rank."""
    from ..optim.optimizers import OptState
    specs = train_state_specs(template, mesh, optimizer, rules)
    shapes = flatten(tree_map(lambda s: s.shape, template))
    pspec, vspec = flatten(specs.params), flatten(specs.opt.v)
    out = {"step": ()}
    out.update({f"params.{k}": local_shape(v, pspec[k], mesh)
                for k, v in shapes.items()})
    whole = OptState((), shapes if specs.opt.m is not None else None,
                     {k: Factors(v[:-1], v[:-2] + v[-1:])
                      if isinstance(vspec[k], Factors) else v
                      for k, v in shapes.items()})
    spec = state_leaves(specs.opt)
    out.update({k: local_shape(v, spec[k], mesh)
                for k, v in state_leaves(whole).items()})
    return out


def local_train_state(state, template, mesh, rank: int, rules=None):
    """Rank ``rank``'s ``TrainState`` of a whole one: every param and
    moment leaf cut by its spec (:func:`train_state_specs`; a param's
    fused projection block by block, an Adafactor factor by its own
    spec, a column factor's blocks as its param's), copies that own
    their storage; the step kept."""
    from ..optim.optimizers import OptState
    from ..runtime.steps import TrainState
    specs = flatten(param_specs(template, mesh, rules))
    parts = param_parts(template)
    optimizer = "adamw" if state.opt.m is not None else "adafactor"
    vspecs = flatten(train_state_specs(template, mesh, optimizer,
                                       rules).opt.v)

    def cut(tree, table):
        if tree is None:
            return None
        out = {}
        for k, v in flatten(tree).items():
            spec = table[k]
            if isinstance(v, tuple):
                # the column factor's last axis is the param's, fused
                # blocks and all
                out[k] = tuple(owned(shard_tensor(f, s, mesh, rank, p))
                               for f, s, p in zip(v, spec, (None, parts[k])))
            else:
                out[k] = owned(shard_tensor(v, spec, mesh, rank, parts[k]))
        return unflatten(out)
    return TrainState(cut(state.params, specs),
                      OptState(state.opt.step.clone(), cut(state.opt.m, specs),
                               cut(state.opt.v, vspecs)))


def place(parts, spec: Spec, mesh, fused: Optional[Tuple[int, ...]] = None
          ) -> torch.Tensor:
    """The whole tensor from every rank's slice (``parts[r]``, rank
    order) under ``spec``: the inverse of :func:`shard_tensor`, exact."""
    first = parts[0]
    shape = list(first.shape)
    spec = tuple(spec) + (None,) * (first.dim() - len(spec))
    for dim, entry in enumerate(spec):
        shape[dim] *= _axis_size(mesh, entry)
    out = first.new_empty(shape)
    for r, part in enumerate(parts):
        view = out
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            idx, count = _entry_slice(mesh, entry, r)
            if fused is not None and dim == first.dim() - 1:
                if any(p % count for p in fused):
                    continue
                blocks = []
                start = 0
                for p in fused:
                    blocks.append((start + idx * (p // count), p // count))
                    start += p
                chunks = part.split([n for _, n in blocks], dim)
                for (at, n), c in zip(blocks, chunks):
                    view.narrow(dim, at, n).copy_(c)
                view = None
                break
            n = view.shape[dim] // count
            view = view.narrow(dim, idx * n, n)
        if view is not None:
            view.copy_(part)
    return out


# ---------------------------------------------------------------------------
# decode-cache specs
# ---------------------------------------------------------------------------

_MIXER_CACHE_AXES = {
    # GQA / cross-attn KV — axes chosen mesh-aware in _kv_cache_axes
    ("k", 4): "__kv__",
    ("v", 4): "__kv__",
    # MLA latent: shard the lora rank rather than the sequence
    ("c_kv", 3): ("batch", None, "kv_lora_sharded"),
    ("k_rope", 3): ("batch", "seq", None),
    # mamba
    ("conv", 3): ("batch", None, "ssm_inner"),
    ("h", 3): ("batch", "ssm_inner", None),
    # mLSTM
    ("C", 4): ("batch", None, "mlstm_dk", None),
    ("n", 3): ("batch", None, "mlstm_dk"),
    ("m", 2): ("batch", "embed_sharded"),
    # sLSTM ([B, d]; mLSTM's m [B,H] falls back to replication on dim 1)
    ("c", 2): ("batch", "embed_sharded"),
    ("n", 2): ("batch", "embed_sharded"),
    ("h", 2): ("batch", "embed_sharded"),
}


def _kv_cache_axes(shape, mesh):
    """[B, S, KV, hd] preference: kv_heads -> head_dim -> sequence."""
    m = mesh.shape["model"]
    B, S, KV, hd = shape
    if KV % m == 0:
        return ("batch", None, "kv_heads", None)
    if hd % m == 0:
        return ("batch", None, None, "head_dim_sharded")
    return ("batch", "seq", None, None)


def _cache_leaf_axes(key: str, shape, scanned: bool, mesh):
    eff_shape = shape[1:] if scanned else shape
    axes = _MIXER_CACHE_AXES.get((key, len(eff_shape)))
    if axes == "__kv__":
        axes = _kv_cache_axes(eff_shape, mesh)
    if axes is None:
        axes = ("batch",) + (None,) * (len(eff_shape) - 1)
    return ((None,) + axes) if scanned else axes


def cache_specs(cache, mesh, rules=None):
    """Walk a cache tree (tensors, ``meta`` ones included) and assign
    each leaf its spec by name; leaves under ``"blocks"`` carry the
    leading ``[R]`` axis."""
    def walk(tree, scanned: bool):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, scanned or k == "blocks")
            else:
                axes = _cache_leaf_axes(k, tuple(v.shape), scanned, mesh)
                out[k] = resolve_spec(tuple(v.shape), axes, mesh, rules)
        return out

    return walk(cache, False)


# ---------------------------------------------------------------------------
# a rank's slice
# ---------------------------------------------------------------------------

def _entry_slice(mesh, entry, rank: int) -> Tuple[int, int]:
    """(index, count) of rank ``rank``'s part of a dimension whose spec
    entry is ``entry``: mixed radix over the entry's axes, the first
    axis major."""
    coords = mesh_coords(mesh, rank)
    idx, count = 0, 1
    for a in _names(entry):
        idx = idx * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return idx, count


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-rank shape of a tensor of ``shape`` sharded by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, e) for d, e in zip(shape, spec))


def shard_tensor(t: torch.Tensor, spec: Spec, mesh, rank: int,
                 parts: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` under ``spec`` (a view).

    ``parts`` names a fused last axis (``ParamSpec.parts``): the lengths
    of its consecutive blocks, such as Mamba's ``in_proj`` columns ``[x
    | z]``.  Sharded, the rank takes its slice of each block, in order
    (a copy), where a plain cut would hand it whole blocks: rank r of
    tp holds ``[x_r | z_r]``, the columns of its channels in both.  A
    fused axis with a block the ranks do not divide is left whole, as
    ``resolve_spec`` leaves a dimension it cannot divide."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, count = _entry_slice(mesh, entry, rank)
        if parts is not None and dim == t.dim() - 1:
            if any(p % count for p in parts):
                continue
            t = torch.cat([p.narrow(dim, idx * (p.shape[dim] // count),
                                    p.shape[dim] // count)
                           for p in t.split(list(parts), dim)], dim)
            continue
        n = t.shape[dim] // count
        t = t.narrow(dim, idx * n, n)
    return t


def param_parts(template) -> Dict[str, Optional[Tuple[int, ...]]]:
    """Each leaf's fused blocks (``ParamSpec.parts``), by flat path."""
    return flatten(tree_map(lambda s: s.parts, template))


def local_tree(tree, mesh, rules=None):
    """A cache tree of ``meta`` tensors cut to one rank's shapes by
    :func:`cache_specs` (the same for every rank); ``rules`` as
    :func:`resolve_spec` takes them (``WHOLE_SEQ``: every position
    kept)."""
    specs = flatten(cache_specs(tree, mesh, rules))
    flat = flatten(tree)
    out = {path: torch.empty(local_shape(tuple(a.shape), specs[path], mesh),
                             dtype=a.dtype, device=a.device)
           for path, a in flat.items()}
    return unflatten(out)


def shard_state_dict(state_dict: Dict[str, torch.Tensor], template, mesh,
                     rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s weights: each leaf of a full flat ``state_dict``
    sliced on the dimensions its spec (``param_specs`` of ``template``)
    shards, contiguous copies.  The ranks' slices together hold the
    full tensors' bits."""
    specs = flatten(param_specs(template, mesh))
    parts = param_parts(template)
    return {path: owned(shard_tensor(t, specs[path], mesh, rank,
                                     parts[path]))
            for path, t in state_dict.items()}


def owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and holding its own storage: a slice that is a
    view (a cut of the leading axis) is copied, so that the whole
    tensor it was cut from can be freed."""
    t = t.contiguous()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t
