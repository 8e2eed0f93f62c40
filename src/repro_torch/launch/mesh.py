"""The meshes of the JAX package's ``launch/mesh.py``: serving and
training.

A :class:`ServingMesh` is a ``(1, tp)`` ``("data", "model")`` mesh over
an explicit list of torch devices, one per rank.  It is a description:
the ranks are processes that :class:`~repro_torch.serving.LLMEngine`
starts (``sharding/group.py``), rank ``r`` on ``devices[r]``.  Two ranks
may share a card (``devices=["cuda:0", "cuda:0"]``): the collectives are
gloo, which stages CUDA tensors through the host.

A :class:`TrainingMesh` has JAX's training shapes and axis names
(:func:`make_host_mesh`, :func:`make_production_mesh`): ``(n/mp, mp)``
over ``("data", "model")``, ``(16, 16)``, or ``(2, 16, 16)`` over
``("pod", "data", "model")``, rank ``r`` at the row-major coordinates
of ``r`` (as JAX lays a mesh's devices out) on ``devices[r]``.
``runtime.steps.make_train_step(..., mesh=)`` starts its ranks.

The roofline constants below are one NVIDIA H100 SXM5 80GB's, from its
data sheet: the counterpart of JAX's per-chip TPU figures, read by
``launch/analysis.py``'s ``roofline``.  The production meshes (256 or
512 cards) span nodes of 8, joined by InfiniBand, which is slower than
NVLink; the collective term keeps JAX's single-constant design and
prices every collective byte at one NVLink 4 link rate, so it is a
lower bound off the node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

#: seconds a collective waits for a rank before it fails the call
DEFAULT_TIMEOUT_S = 60.0

# H100 SXM5 80GB roofline constants (per card), NVIDIA H100 Tensor Core
# GPU data sheet
#: dense bf16 tensor-core FLOP/s (1979 TFLOP/s with sparsity, halved)
PEAK_FLOPS_BF16 = 989e12
#: f32 FLOP/s outside the tensor cores (an elementwise kernel's rate)
PEAK_FLOPS_F32 = 67e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink 4 bytes/s each way (900 GB/s bidirectional per card)
LINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    devices: Tuple[str, ...]            # rank r runs on devices[r]
    timeout_s: float = DEFAULT_TIMEOUT_S
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": 1, "model": len(self.devices)}

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        return ",".join(sorted({torch.device(d).type for d in self.devices}))


@dataclasses.dataclass(frozen=True)
class TrainingMesh:
    devices: Tuple[str, ...]            # rank r runs on devices[r]
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]              # one per axis name
    timeout_s: float = DEFAULT_TIMEOUT_S

    def __post_init__(self):
        n = 1
        for s in self.sizes:
            n *= s
        if n != len(self.devices) or len(self.sizes) != len(self.axis_names):
            raise ValueError(f"a {self.sizes} mesh over {self.axis_names} "
                             f"needs {n} devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def platform(self) -> str:
        return ",".join(sorted({torch.device(d).type for d in self.devices}))


def _devices(devices: Optional[Sequence]) -> Tuple[str, ...]:
    """``devices`` as torch device strings; ``None`` means every visible
    CUDA card, one rank each."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
    return tuple(str(torch.device(d)) for d in devices)


def make_host_mesh(model_parallel: int = 1, *,
                   devices: Optional[Sequence] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> TrainingMesh:
    """A small ``(n/mp, mp)`` ``("data", "model")`` training mesh over the
    ``n`` entries of ``devices`` (every visible card by default); ``mp``
    falls back to 1 where it does not divide ``n``, as in JAX."""
    devs = _devices(devices)
    if not devs:
        raise ValueError("make_host_mesh needs at least one device (pass "
                         "devices=[\"cpu\"] to train on the CPU)")
    n = len(devs)
    mp = model_parallel if n % model_parallel == 0 else 1
    return TrainingMesh(devs, ("data", "model"), (n // mp, mp), timeout_s)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> TrainingMesh:
    """JAX's production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")``, on the first 256 or
    512 entries of ``devices``; fewer raise ``ValueError`` with the count
    needed, as ``jax.make_mesh`` fails."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in sizes:
        need *= s
    devs = _devices(devices)
    if len(devs) < need:
        raise ValueError(f"the production mesh {sizes} over {axes} needs "
                         f"{need} devices, have {len(devs)}")
    return TrainingMesh(devs[:need], axes, sizes, timeout_s)


def make_serving_mesh(model_parallel: int = 0, *,
                      devices: Optional[Sequence] = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> ServingMesh:
    """Tensor-parallel serving mesh: a (1, tp) ("data", "model") mesh over
    the first ``model_parallel`` entries of ``devices`` (0 = all of
    them).  ``devices=None`` means every visible CUDA card, one rank
    each; sharing a card, or running on the CPU, needs an explicit list
    (``["cuda:0", "cuda:0"]``, ``["cpu"] * 4``)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [str(torch.device(d)) for d in devices]
    tp = len(devs) if not model_parallel else int(model_parallel)
    if tp < 1 or tp > len(devs):
        raise ValueError(f"model_parallel={tp} needs {tp} devices, have "
                         f"{len(devs)} (pass devices=[...] to put several "
                         f"ranks on one card or on the CPU)")
    return ServingMesh(tuple(devs[:tp]), timeout_s)


def mesh_desc(mesh) -> dict:
    """JSON-able description of a mesh for observability tags.  ``None``
    (unsharded) reports the single-device shape."""
    if mesh is None:
        return {"devices": 1, "axes": {}}
    axes = {str(k): int(v) for k, v in mesh.shape.items()}
    n = 1
    for v in axes.values():
        n *= v
    return {"devices": n, "axes": axes, "platform": mesh.platform}
