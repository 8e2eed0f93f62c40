"""Reusable calculator library (paper part (c)).

Importing this package registers the standard calculators with the
framework registry, mirroring MediaPipe's "collection of re-usable
inference and processing components".
"""
from . import basic            # noqa: F401
from . import perception       # noqa: F401
from . import inference        # noqa: F401

from .basic import (PassThroughCalculator, CallbackSourceCalculator,
                    IteratorSourceCalculator, SinkCalculator,
                    DemuxCalculator, MuxCalculator, GateCalculator,
                    FrameSelectCalculator, PacketClonerCalculator,
                    SidePacketToStreamCalculator, SyncPointCalculator)
from .perception import (DetectionMergeCalculator, TrackerCalculator,
                         AnnotationOverlayCalculator,
                         TemporalInterpolationCalculator)
from .inference import InferenceCalculator

__all__ = [
    "PassThroughCalculator", "CallbackSourceCalculator",
    "IteratorSourceCalculator", "SinkCalculator", "DemuxCalculator",
    "MuxCalculator", "GateCalculator", "FrameSelectCalculator",
    "PacketClonerCalculator", "SidePacketToStreamCalculator",
    "SyncPointCalculator",
    "DetectionMergeCalculator", "TrackerCalculator",
    "AnnotationOverlayCalculator", "TemporalInterpolationCalculator",
    "InferenceCalculator",
]
