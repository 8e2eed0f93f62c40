"""Captured CUDA graphs of the engine's fixed-shape steps: the port's
counterpart of the JAX engine's ``jax.jit`` step caches.

The JAX engine compiles each step once per shape and caches it: prefill
and decode, serve decode and insert per cache layout, verify per layout
and window width.  Run eagerly, one decode step of a 40-layer model is
some 600 host launches, and on the card the host's time to launch them
is most of the step.  :class:`StepGraphs` captures a step once per key
into a ``torch.cuda.CUDAGraph`` and replays it on every later call of
that key:

* the first call of a key runs the step eagerly, on the capture stream,
  as that call's own work (it is also the warm-up that lets cuBLAS set
  itself up outside a capture), then captures it.  A capture records
  the kernels without running them, so no cache row is written twice;
* the captured step reads its inputs from fixed buffers, which each
  call fills, and leaves its outputs in fixed tensors, which the caller
  reads before it calls that key again;
* what a capture allocates (the layers' temporaries, K4's and K5's
  partials) comes from one memory pool that every graph shares: the
  steps run one at a time on the caller's stream, so their temporaries
  may overlap;
* a capture runs the kernel wrappers, which count launches, but
  launches nothing: its launches are counted apart, and each replay
  adds the launches the capture recorded (``kernels/build.py``);
* a capture runs in ``thread_local`` mode.  A server calls the engine
  from its executor thread while its other threads may touch CUDA,
  which ``global`` mode forbids for the length of the capture; the
  capturing thread itself still raises on a call that a capture cannot
  hold, which ``relaxed`` mode would let through.

The caller keys a step by everything its graph bakes in: the step, the
layout and the shapes; :meth:`StepGraphs.run` adds the addresses of the
tensors bound to it (the cache it writes, the verify's stacks), and
:meth:`StepGraphs.drop_bound_to` forgets the steps bound to a buffer
before it is freed.  A capture that fails raises; nothing falls back to
the eager step.
"""
from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Hashable, Sequence, Tuple

import torch

from ..kernels import build


class CapturedStep:
    """One step as a CUDA graph: its input buffers, its output tensors,
    the kernel launches that one replay makes and the addresses of the
    tensors bound to it."""

    def __init__(self, graph: "torch.cuda.CUDAGraph",
                 inputs: Sequence[torch.Tensor], outputs,
                 launched: Dict[str, int], bound: FrozenSet[int]):
        self.graph = graph
        self.inputs = tuple(inputs)
        self.outputs = outputs
        self.launched = launched
        self.bound = bound

    def __call__(self, args: Sequence[torch.Tensor]):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        build.add_launches(self.launched)
        return self.outputs


class StepGraphs:
    """The captured steps of one engine, keyed by the caller, sharing
    one memory pool and one capture stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.steps: Dict[Hashable, CapturedStep] = {}

    def __len__(self) -> int:
        return len(self.steps)

    def run(self, key: Tuple, step: Callable,
            args: Sequence[torch.Tensor], bound: Sequence = ()):
        """``step(*args)`` on the card: the captured graph of ``key`` and
        the addresses of ``bound`` when there is one, else the step run
        eagerly and then captured.  ``args`` are tensors on any device,
        of the shapes ``key`` fixes; ``bound`` are the trees of tensors
        the step reads and writes in place.  ``step`` returns one
        tensor, and a replay returns the graph's own output tensor."""
        key = key + tuple(cache_key(tree) for tree in bound)
        captured = self.steps.get(key)
        if captured is not None:
            return captured(args)
        # the eager run goes on the capture stream, as torch's recipe
        # warms up: cuBLAS sets up that stream's workspace outside the
        # capture, and the graph's products then run as this call's did
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = step(*(a.to(self.device) for a in args))
        caller.wait_stream(self.stream)
        out.record_stream(caller)
        self.steps[key] = self._capture(step, args, addresses(bound))
        return out

    def drop_bound_to(self, tree) -> None:
        """Forget the captured steps bound to any tensor of ``tree``, so
        that none writes it once it is freed."""
        old = addresses(tree)
        self.steps = {k: cs for k, cs in self.steps.items()
                      if not old & cs.bound}

    def _capture(self, step: Callable, args: Sequence[torch.Tensor],
                 bound: FrozenSet[int]) -> CapturedStep:
        inputs = [torch.empty(a.shape, dtype=a.dtype, device=self.device)
                  for a in args]
        graph = torch.cuda.CUDAGraph()
        with build.counted_apart() as launched:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = step(*inputs)
        return CapturedStep(graph, inputs, outputs, launched, bound)

    def pool_bytes(self) -> int:
        """Bytes the card holds for the shared pool (its segments)."""
        pool = tuple(self.pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def cache_key(cache) -> Tuple:
    """What a captured step bakes in of a cache: each leaf's address and
    shape, in a fixed order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            out.append((node.data_ptr(), tuple(node.shape)))

    walk(cache)
    return tuple(out)


def addresses(tree) -> FrozenSet[int]:
    """The addresses of a tree's tensors (a sequence of trees, a dict or
    a tensor), leaving out those that hold no bytes."""
    if isinstance(tree, (list, tuple)):
        return frozenset().union(*map(addresses, tree))
    return frozenset(ptr for ptr, _ in cache_key(tree) if ptr)
