"""Perception calculators for the paper's §6 example pipelines: detection
merging, lightweight tracking, annotation overlay, temporal interpolation.

Detections are represented as ``Detection`` dataclasses; frames as numpy
arrays (H, W, C) or tensors.  The tracker is the paper's "lightweight
tracker": it propagates existing boxes to the current frame via a cheap
motion estimate so the expensive detector can run on a subsampled stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.calculator import Calculator, CalculatorContext
from ..core.contract import AnyType, contract
from ..core.registry import register_calculator


@dataclasses.dataclass(frozen=True)
class Detection:
    box: Tuple[float, float, float, float]   # (x0, y0, x1, y1), normalized
    label: str
    score: float
    track_id: int = -1

    def iou(self, other: "Detection") -> float:
        ax0, ay0, ax1, ay1 = self.box
        bx0, by0, bx1, by1 = other.box
        ix0, iy0 = max(ax0, bx0), max(ay0, by0)
        ix1, iy1 = min(ax1, bx1), min(ay1, by1)
        iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
        inter = iw * ih
        a = (ax1 - ax0) * (ay1 - ay0)
        b = (bx1 - bx0) * (by1 - by0)
        return inter / max(a + b - inter, 1e-9)

    def shifted(self, dx: float, dy: float) -> "Detection":
        x0, y0, x1, y1 = self.box
        return dataclasses.replace(
            self, box=(x0 + dx, y0 + dy, x1 + dx, y1 + dy))


@register_calculator
class TrackerCalculator(Calculator):
    """Fast branch (paper §6.1): advances known boxes to each new frame.

    Inputs: FRAME (every frame), RESET (merged detections loopback,
    immediate) — the merge node re-initializes the tracker's targets.
    Output: TRACKED detections per frame.

    The motion model estimates global translation from frame means — a
    stand-in for the paper's lightweight tracker, deliberately cheap.
    """

    CONTRACT = (contract()
                .add_input("FRAME", AnyType)
                .add_input("RESET", AnyType, optional=True)
                .add_output("TRACKED")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self._targets: List[Detection] = []
        self._next_id = 0
        self._prev_mean: Optional[float] = None

    def process(self, ctx: CalculatorContext) -> None:
        reset = ctx.inputs["RESET"]
        if not reset.is_empty():
            dets: List[Detection] = list(reset.payload)
            assigned = []
            for d in dets:
                if d.track_id < 0:
                    d = dataclasses.replace(d, track_id=self._next_id)
                    self._next_id += 1
                assigned.append(d)
            self._targets = assigned
        frame = ctx.inputs["FRAME"]
        if frame.is_empty():
            return
        arr = np.asarray(frame.payload)
        mean = float(arr.mean())
        # toy global-motion estimate: drift proportional to mean delta
        dx = 0.0 if self._prev_mean is None else \
            np.clip((mean - self._prev_mean) * 1e-3, -0.05, 0.05)
        self._prev_mean = mean
        self._targets = [t.shifted(dx, 0.0) for t in self._targets]
        ctx.outputs("TRACKED").add(list(self._targets), frame.timestamp)


@register_calculator
class DetectionMergeCalculator(Calculator):
    """Merges fresh detections with tracked boxes *at the same timestamp*
    (the default input policy aligns them automatically, §6.1), dropping
    duplicates by IoU/class proximity, and loops merged detections back to
    the tracker to initialize new targets."""

    CONTRACT = (contract()
                .add_input("DETECTIONS", AnyType)
                .add_input("TRACKED", AnyType, optional=True)
                .add_output("MERGED")
                .add_output("RESET"))

    def open(self, ctx: CalculatorContext) -> None:
        self._iou_thresh = float(ctx.options.get("iou_threshold", 0.5))
        self._next_id = 0

    def process(self, ctx: CalculatorContext) -> None:
        dets: List[Detection] = list(ctx.inputs.value("DETECTIONS", []) or [])
        tracked: List[Detection] = list(ctx.inputs.value("TRACKED", []) or [])
        merged: List[Detection] = []
        for t in tracked:
            merged.append(t)
        for d in dets:
            dup = next((m for m in merged
                        if m.label == d.label and
                        m.iou(d) >= self._iou_thresh), None)
            if dup is not None:
                # fresh detection supersedes the propagated box, keeps id
                merged[merged.index(dup)] = dataclasses.replace(
                    d, track_id=dup.track_id)
            else:
                merged.append(dataclasses.replace(
                    d, track_id=self._next_id))
                self._next_id += 1
        t0 = ctx.input_timestamp
        ctx.outputs("MERGED").add(merged, t0)
        ctx.outputs("RESET").add(merged, t0)


@register_calculator
class AnnotationOverlayCalculator(Calculator):
    """Draws detections/landmarks/masks onto the frame.  The default input
    policy synchronizes the annotation stream(s) with the originating frame
    — the paper's 'slightly delayed viewfinder perfectly aligned with the
    computed detections'."""

    CONTRACT = (contract()
                .add_input("FRAME", AnyType)
                .add_input("DETECTIONS", AnyType, optional=True)
                .add_input("LANDMARKS", AnyType, optional=True)
                .add_input("MASK", AnyType, optional=True)
                .add_output("ANNOTATED_FRAME"))

    def process(self, ctx: CalculatorContext) -> None:
        frame = ctx.inputs["FRAME"]
        if frame.is_empty():
            return
        img = np.array(frame.payload, copy=True)
        h, w = img.shape[:2]
        dets = ctx.inputs.value("DETECTIONS")
        for d in (dets if dets is not None else []):
            x0, y0, x1, y1 = d.box
            xi0, yi0 = int(np.clip(x0 * w, 0, w - 1)), int(np.clip(y0 * h, 0, h - 1))
            xi1, yi1 = int(np.clip(x1 * w, 0, w - 1)), int(np.clip(y1 * h, 0, h - 1))
            img[yi0, xi0:xi1] = 255
            img[yi1, xi0:xi1] = 255
            img[yi0:yi1, xi0] = 255
            img[yi0:yi1, xi1] = 255
        lms = ctx.inputs.value("LANDMARKS")
        for (ly, lx) in (lms if lms is not None else []):
            yi = int(np.clip(ly * h, 0, h - 1))
            xi = int(np.clip(lx * w, 0, w - 1))
            img[yi, xi] = 255
        mask = ctx.inputs.value("MASK")
        if mask is not None:
            m = np.asarray(mask)
            if m.shape[:2] == img.shape[:2]:
                img = np.where(m[..., None] > 0.5, img, img // 2) \
                    if img.ndim == 3 else np.where(m > 0.5, img, img // 2)
        ctx.outputs("ANNOTATED_FRAME").add(img, frame.timestamp)


@register_calculator
class TemporalInterpolationCalculator(Calculator):
    """Interpolates sparse annotations (landmarks / masks computed on a
    subsampled stream) onto every frame timestamp (paper §6.2).  TICK
    carries every frame; VALUE carries the sparse results.  Linear
    interpolation between the two nearest VALUEs; before the first VALUE
    arrives, ticks advance the output bound."""

    CONTRACT = (contract()
                .add_input("VALUE", AnyType)
                .add_input("TICK", AnyType)
                .add_output("OUT")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self._prev: Optional[Tuple[int, np.ndarray]] = None
        self._cur: Optional[Tuple[int, np.ndarray]] = None
        self._pending: List = []  # tick packets awaiting a later VALUE

    def _emit(self, ctx: CalculatorContext, t_val: int, ts_obj) -> None:
        if self._cur is None:
            return
        if self._prev is None or t_val >= self._cur[0]:
            out = self._cur[1]
        else:
            t0, v0 = self._prev
            t1, v1 = self._cur
            a = (t_val - t0) / max(t1 - t0, 1)
            out = (1 - a) * v0 + a * v1
        ctx.outputs("OUT").add(out, ts_obj)

    def process(self, ctx: CalculatorContext) -> None:
        v = ctx.inputs["VALUE"]
        if not v.is_empty():
            self._prev, self._cur = self._cur, \
                (v.timestamp.value, np.asarray(v.payload))
            still = []
            for tick in self._pending:
                if tick.timestamp.value <= self._cur[0]:
                    self._emit(ctx, tick.timestamp.value, tick.timestamp)
                else:
                    still.append(tick)
            self._pending = still
        tick = ctx.inputs["TICK"]
        if not tick.is_empty():
            if self._cur is not None and \
                    tick.timestamp.value <= self._cur[0]:
                self._emit(ctx, tick.timestamp.value, tick.timestamp)
            else:
                # hold until a bracketing VALUE arrives (true interpolation;
                # close() flushes remaining ticks with the latest value)
                self._pending.append(tick)

    def close(self, ctx: CalculatorContext) -> None:
        for tick in self._pending:
            if self._cur is not None:
                self._emit(ctx, tick.timestamp.value, tick.timestamp)
