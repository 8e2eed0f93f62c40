"""Inference calculators — the bridge between the dataflow graph (host) and
PyTorch computation on the card (device).

The paper's object-detection node "consumes an ML model ... as input side
packets, performs ML inference on the incoming selected frames using an
inference engine".  Here the *engine* side packet is any callable
``payload -> result`` — typically a model function closed over its
weights on the card (see ``repro_torch.serving.engine``).

CUDA launches are asynchronous: ``process`` returns as soon as the
computation is *enqueued*, so a slow device does not block the scheduler
thread — the analogue of MediaPipe issuing GL commands on a dedicated
context thread (DESIGN.md §2).  Host synchronization happens only at
SyncPointCalculator sinks.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np

from ..core.calculator import Calculator, CalculatorContext
from ..core.contract import AnyType, contract
from ..core.registry import register_calculator
from .perception import Detection


@register_calculator
class InferenceCalculator(Calculator):
    """Generic model-inference node.

    Side packets:
        engine — callable(payload) -> result (a model function or Engine)
    Options:
        dedicate to a separate executor in the NodeConfig for thread
        locality on heavy models (paper §3.6).
    """

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_output("OUT")
                .add_input_side_packet("engine", AnyType))

    def open(self, ctx: CalculatorContext) -> None:
        self._engine: Callable[[Any], Any] = ctx.side("engine")

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["IN"]
        if p.is_empty():
            return
        ctx.outputs("OUT").add(self._engine(p.payload), p.timestamp)


@register_calculator
class ObjectDetectorCalculator(Calculator):
    """Tiny deterministic 'NN' detector used by the example graphs and
    benchmarks: thresholded block-pooling over the frame produces boxes.
    Stands in for the paper's TFLite detector; swappable with a heavy
    InferenceCalculator without touching the rest of the graph (§6.1)."""

    CONTRACT = (contract()
                .add_input("FRAME", AnyType)
                .add_output("DETECTIONS")
                .add_input_side_packet("labels", AnyType, optional=True))

    def open(self, ctx: CalculatorContext) -> None:
        self._grid = int(ctx.options.get("grid", 4))
        self._thresh = float(ctx.options.get("threshold", 0.6))
        self._labels: List[str] = ctx.side("labels") or ["object"]

    def process(self, ctx: CalculatorContext) -> None:
        frame = ctx.inputs["FRAME"]
        if frame.is_empty():
            return
        img = np.asarray(frame.payload, dtype=np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        h, w = img.shape
        g = self._grid
        dets: List[Detection] = []
        cell_max = float(img.max()) or 1.0
        for gy in range(g):
            for gx in range(g):
                cell = img[gy * h // g:(gy + 1) * h // g,
                           gx * w // g:(gx + 1) * w // g]
                score = float(cell.mean()) / cell_max
                if score > self._thresh:
                    dets.append(Detection(
                        box=(gx / g, gy / g, (gx + 1) / g, (gy + 1) / g),
                        label=self._labels[(gx + gy) % len(self._labels)],
                        score=score))
        ctx.outputs("DETECTIONS").add(dets, frame.timestamp)


@register_calculator
class FaceLandmarkCalculator(Calculator):
    """Toy landmark estimator: returns K intensity-weighted centroids as
    (y, x) normalized landmarks (stand-in for §6.2's face-landmark node)."""

    CONTRACT = (contract()
                .add_input("FRAME", AnyType)
                .add_output("LANDMARKS"))

    def open(self, ctx: CalculatorContext) -> None:
        self._k = int(ctx.options.get("num_landmarks", 5))

    def process(self, ctx: CalculatorContext) -> None:
        frame = ctx.inputs["FRAME"]
        if frame.is_empty():
            return
        img = np.asarray(frame.payload, dtype=np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        h, w = img.shape
        ys = np.linspace(0.2, 0.8, self._k)
        cx = (img.mean(0) * np.arange(w)).sum() / max(img.sum() / h, 1e-9) / w
        lms = np.stack([ys, np.clip(np.full(self._k, cx / h), 0, 1)], -1)
        ctx.outputs("LANDMARKS").add(lms, frame.timestamp)


@register_calculator
class SegmentationCalculator(Calculator):
    """Toy portrait segmentation: threshold at the frame's mean intensity."""

    CONTRACT = (contract()
                .add_input("FRAME", AnyType)
                .add_output("MASK"))

    def process(self, ctx: CalculatorContext) -> None:
        frame = ctx.inputs["FRAME"]
        if frame.is_empty():
            return
        img = np.asarray(frame.payload, dtype=np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        mask = (img > img.mean()).astype(np.float32)
        ctx.outputs("MASK").add(mask, frame.timestamp)
