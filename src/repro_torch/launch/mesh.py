"""The serving mesh: the JAX package's ``launch/mesh.py`` serving half.

A :class:`ServingMesh` is a ``(1, tp)`` ``("data", "model")`` mesh over
an explicit list of torch devices, one per rank.  It is a description:
the ranks are processes that :class:`~repro_torch.serving.LLMEngine`
starts (``sharding/group.py``), rank ``r`` on ``devices[r]``.  Two ranks
may share a card (``devices=["cuda:0", "cuda:0"]``): the collectives are
gloo, which stages CUDA tensors through the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

#: seconds a collective waits for a rank before it fails the call
DEFAULT_TIMEOUT_S = 60.0


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
