#!/usr/bin/env python
"""The paper's Figure-5 pipeline: face-landmark detection + portrait
segmentation on DISJOINT frame subsets (demux), temporally interpolated
back onto every frame, overlaid in sync (paper §6.2), on the PyTorch
port: ``examples/face_landmark.py`` line for line, through
``repro_torch``.

  frame ─> Demux ─┬─ OUT0 ─> FaceLandmark ──> Interp(landmarks) ─┐
                  └─ OUT1 ─> Segmentation ──> Interp(mask) ──────┤
  frame ─────────────────────────────────────────────────────────┴─> Overlay

    PYTHONPATH=src python examples/torch_face_landmark.py
"""
import numpy as np

import repro_torch.calculators  # noqa: F401
from repro_torch.core import Graph, GraphBuilder, visualizer

b = GraphBuilder(num_threads=4, enable_tracer=True)
frame = b.input("frame")


def interpolated(name, value, tick, out_name):
    """A 'subgraph' in the builder API is just a Python function taking and
    returning stream handles (paper §3.6 composition, no expansion pass)."""
    node = b.add_node("TemporalInterpolationCalculator", name=name,
                      inputs={"VALUE": value, "TICK": tick})
    return node.out("OUT", name=out_name)


demux = b.add_node("DemuxCalculator", name="demux", inputs={"IN": frame})
frames_lm = demux.out("OUT0", name="frames_lm")
frames_seg = demux.out("OUT1", name="frames_seg")

landmarks = b.add_node("FaceLandmarkCalculator", name="landmarks",
                       inputs={"FRAME": frames_lm},
                       options={"num_landmarks": 5})
segment = b.add_node("SegmentationCalculator", name="segment",
                     inputs={"FRAME": frames_seg})

lm_dense = interpolated("lm_interp",
                        landmarks.out("LANDMARKS", name="lm_sparse"),
                        frame, "lm_dense")
mask_dense = interpolated("mask_interp",
                          segment.out("MASK", name="mask_sparse"),
                          frame, "mask_dense")

overlay = b.add_node("AnnotationOverlayCalculator", name="overlay",
                     inputs={"FRAME": frame, "LANDMARKS": lm_dense,
                             "MASK": mask_dense})
b.output(overlay.out("ANNOTATED_FRAME", name="ANNOTATED_FRAME"))
cfg = b.build()

print(visualizer.topology_ascii(cfg))

g = Graph(cfg)
out = []
g.observe_output_stream("ANNOTATED_FRAME", lambda p: out.append(p))
g.start_run()
rng = np.random.RandomState(2)
N = 16
for t in range(N):
    frame = (rng.rand(48, 48) * 200).astype(np.float32)
    frame[12:36, 16:32] += 55.0      # the "face"
    g.add_packet_to_input_stream("frame", frame, t)
g.close_all_input_streams()
g.wait_until_done()

stamps = [p.timestamp.value for p in out]
print(f"\n{len(out)} frames annotated, timestamps {stamps}")
assert stamps == list(range(N))
assert out[0].payload.shape == (48, 48)

print()
print(visualizer.timeline_ascii(g.tracer, g.node_names(), width=64))
print("\nface_landmark OK")
