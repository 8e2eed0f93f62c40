"""Parameter templates: shapes, logical sharding axes and init, and the
weight bridge from JAX.

A model's parameters are described once as a nested dict of
:class:`ParamSpec` leaves.  ``init_params`` materialises it with an
explicit ``torch.Generator`` (the same distributions as the JAX
package's ``_init_leaf``, not the same bits); ``logical_axes`` reads
each leaf's logical axis names, which ``repro_torch.sharding.rules``
maps onto a serving mesh; ``params_from_jax`` turns a JAX param tree
(nested dicts of numpy arrays) into the port's ``state_dict`` so both
packages can hold identical weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# float64 runs the plain versions only (the tests' exact reference); the
# CUDA kernels refuse it
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    #: one logical axis name (or None) per dimension, as in the JAX
    #: package's template; omitted, every dimension is unnamed
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"      # normal | zeros | ones | scaled | alog
    scale: float = 1.0
    #: a fused last axis: the lengths of its consecutive blocks (such as
    #: ``[x | z]``), of which a tensor-parallel rank holds its slice of
    #: each (``sharding.rules.shard_tensor``); None: the axis is one block
    parts: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        assert self.parts is None or sum(self.parts) == self.shape[-1], \
            (self.shape, self.parts)


Template = Dict[str, Any]   # nested dict with ParamSpec leaves


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (all trees share the
    first tree's keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"blocks.l0.mixer.wq": leaf}`` (insertion order)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def stack_template(template: Template, n: int,
                   axis_name: Optional[str] = "layers") -> Template:
    """Add a leading stacking dimension (one slice per layer group),
    named ``axis_name``."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes), template)


def logical_axes(template: Template) -> Dict[str, Any]:
    """The template's logical axis names, leaf by leaf."""
    return tree_map(lambda s: s.axes, template)


#: leaves of more elements are drawn in chunks of DRAW_CHUNK
DRAW_CHUNK_ABOVE = 1 << 30
DRAW_CHUNK = 1 << 28


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    """The JAX package's init rules; an init it does not know raises."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "alog":
        # Mamba's A_log: log(1 .. d_state) along the last axis, rounded
        # to f32 from f64 (so the same bits on every device)
        d_state = spec.shape[-1]
        a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float64,
                                   device=device))
        return a.expand(spec.shape).to(dtype).contiguous()
    if spec.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {spec.init!r} for a leaf of shape "
                         f"{spec.shape}")
    # the JAX rule: fan_in is the leading dim of a >=2-d leaf
    fan_in = spec.shape[0] if len(spec.shape) >= 2 \
        else max(spec.shape[-1], 1)
    std = spec.scale if spec.init == "scaled" \
        else spec.scale / math.sqrt(fan_in)
    n = math.prod(spec.shape)
    if n <= DRAW_CHUNK_ABOVE:
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)
    # a leaf of more than 2^30 elements (deepseek_v3's and jamba's
    # stacked experts) is drawn DRAW_CHUNK elements at a time, so that
    # its f32 draw is not held whole beside its cast
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, n, DRAW_CHUNK):
        m = min(DRAW_CHUNK, n - i)
        flat[i:i + m] = torch.randn(m, generator=gen, dtype=torch.float32,
                                    device=device).mul_(std)
    return out


def init_params(template: Template, gen: torch.Generator, dtype: str,
                device) -> Dict[str, Any]:
    """Materialise ``template`` on ``device`` in leaf order, drawing from
    ``gen`` (which must live on ``device``)."""
    dt = DTYPES[dtype]
    return tree_map(lambda s: _init_leaf(s, gen, dt, device), template)


def _from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy:
        # cross through the raw 16-bit pattern, which both share
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_tree: Dict[str, Any], cfg, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
    """The weight bridge: a JAX param tree (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, engine.params)``) to the
    port's ``state_dict`` — the same dotted paths, the same shapes,
    stacked ``[R, ...]`` leaves kept as they are, values bit-exact."""
    from .transformer import model_template
    want = flatten(model_template(cfg))
    got = flatten(np_tree)
    if set(want) != set(got):
        raise ValueError(f"param paths differ from the {cfg.name} template: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}")
    out = {}
    for path, spec in want.items():
        t = _from_numpy(got[path])
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != template "
                             f"{spec.shape}")
        out[path] = t.to(device)
    return out
