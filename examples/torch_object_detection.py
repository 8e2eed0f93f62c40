#!/usr/bin/env python
"""The paper's Figure-1 pipeline: real-time object detection with a slow
detection branch + fast tracking branch, merged deterministically, on
the PyTorch port: ``examples/object_detection.py`` line for line,
through ``repro_torch``.

  frame ──┬─> FrameSelect ─> Detector ──┐
          │                              v
          ├─> Tracker ──────────> DetectionMerge ──> AnnotationOverlay ─> out
          │        ^                     │
          │        └──── RESET loopback ─┘
          └──────────────────────────────────────────^ (frame)

The detector runs on every 4th frame; the tracker advances boxes on every
frame; the merge node's DEFAULT INPUT POLICY aligns detections with the
exact frame they came from (paper §6.1 'effectively hiding model latency').
The RESET loopback is a ``b.loopback()`` handle: consumed by the tracker
before its producer exists, tied to the merge output afterwards — the back
edge is declared automatically.

    PYTHONPATH=src python examples/torch_object_detection.py
"""
import time

import numpy as np

import repro_torch.calculators  # noqa: F401
from repro_torch.core import Graph, GraphBuilder, visualizer

b = GraphBuilder(num_threads=4, enable_tracer=True)
frame = b.input("frame")
b.executor("detector_executor", 1)

select = b.add_node("FrameSelectCalculator", name="select",
                    inputs={"IN": frame}, options={"every": 4})
detect = b.add_node("ObjectDetectorCalculator", name="detect",
                    inputs={"FRAME": select.out("OUT", name="selected")},
                    options={"threshold": 0.55},
                    executor="detector_executor")  # paper §3.6 thread locality
reset = b.loopback()
track = b.add_node("TrackerCalculator", name="track",
                   inputs={"FRAME": frame, "RESET": reset})
merge = b.add_node("DetectionMergeCalculator", name="merge",
                   inputs={"DETECTIONS": detect.out("DETECTIONS",
                                                    name="detections"),
                           "TRACKED": track.out("TRACKED", name="tracked")})
merged = merge.out("MERGED", name="merged")
reset.tie(merge.out("RESET", name="reset"))
annotate = b.add_node("AnnotationOverlayCalculator", name="annotate",
                      inputs={"FRAME": frame, "DETECTIONS": merged})
b.output(annotate.out("ANNOTATED_FRAME", name="annotated"))
b.output(merged)
cfg = b.build()

print(visualizer.topology_ascii(cfg))

g = Graph(cfg)
annotated, merged_out = [], []
g.observe_output_stream("annotated", lambda p: annotated.append(p))
g.observe_output_stream("merged", lambda p: merged_out.append(
    (p.timestamp.value, len(p.payload))))
g.start_run()

rng = np.random.RandomState(1)
N = 24
base = rng.rand(64, 64).astype(np.float32) * 120
for t in range(N):
    # a bright moving square = the "object"
    frame = base.copy()
    x = 8 + 2 * t
    frame[20:36, x:x + 16] += 120
    g.add_packet_to_input_stream("frame", frame, t)
    time.sleep(0.002)
g.close_all_input_streams()
g.wait_until_done()

# every frame got an annotated output, perfectly aligned
stamps = [p.timestamp.value for p in annotated]
assert stamps == list(range(N)), stamps
det_counts = dict(merged_out)
print(f"\n{N} frames annotated; detections per frame: "
      f"{[det_counts.get(t, 0) for t in range(N)]}")
assert any(c > 0 for c in det_counts.values()), "object never detected"

print()
print(visualizer.timeline_ascii(g.tracer, g.node_names(), width=64))
print("\nobject_detection OK")
