#!/usr/bin/env python
"""Quickstart: build a three-node perception pipeline, run it, inspect the
trace — the 60-second tour of the framework (paper §3), on the PyTorch
port: ``examples/quickstart.py`` line for line, through ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import numpy as np

import repro_torch.calculators  # noqa: F401 — registers the calculator library
from repro_torch.core import Graph, GraphBuilder, visualizer

# 1. Declare the pipeline: frames -> detector -> annotator -> out.
#    The builder checks every port against the calculator contracts as the
#    graph is written — a typo like detect["FRMAE"] fails on that line.
b = GraphBuilder(enable_tracer=True)
frame = b.input("frame")
labels = b.side_input("labels")

detect = b.add_node("ObjectDetectorCalculator", name="detect",
                    options={"threshold": 0.4},
                    side_inputs={"labels": labels})
detect["FRAME"] = frame
detections = detect.out("DETECTIONS", name="detections")

annotate = b.add_node("AnnotationOverlayCalculator", name="annotate",
                      inputs={"FRAME": frame, "DETECTIONS": detections})
b.output(annotate.out("ANNOTATED_FRAME", name="annotated"))

cfg = b.build()      # a plain GraphConfig — runtime/text format unchanged

print(visualizer.topology_ascii(cfg))
print()

# 2. Run it over a synthetic camera feed.
g = Graph(cfg, side_packets={"labels": ["cat", "dog"]})
frames_out = []
g.observe_output_stream("annotated", lambda p: frames_out.append(p))
g.start_run()
rng = np.random.RandomState(0)
for t in range(10):
    frame = (rng.rand(64, 64) * 255).astype(np.float32)
    g.add_packet_to_input_stream("frame", frame, t)
g.close_all_input_streams()
g.wait_until_done()

# 3. The default input policy aligned every annotation with its frame.
print(f"got {len(frames_out)} annotated frames, timestamps "
      f"{[p.timestamp.value for p in frames_out]}")
assert [p.timestamp.value for p in frames_out] == list(range(10))

# 4. Inspect the trace (paper §5).
print()
print(visualizer.timeline_ascii(g.tracer, g.node_names(), width=60))
for name, h in g.tracer.node_histograms(g.node_names()).items():
    print(f"  {name:10s} runs={h['count']:3.0f} mean={h['mean_us']:.0f}us")
print("\nquickstart OK")
