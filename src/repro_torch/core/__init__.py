"""repro_torch.core — the MediaPipe dataflow framework, the port's copy.

The same graph runtime as the JAX package's ``core``, module for module:
it is pure Python, so the copies differ from their reference only in
import lines and in docstrings that named JAX.

Public API surface:
    Timestamp, Packet, make_packet
    Calculator, SourceCalculator, CalculatorContract, contract
    register_calculator, register_subgraph
    GraphBuilder, Stream, SidePacket (typed fluent authoring)
    GraphConfig, NodeConfig, ExecutorConfig (low-level / serialization)
    Graph, OutputStreamPoller
    Tracer / visualizer helpers
"""
from .timestamp import Timestamp, ts
from .packet import Packet, make_packet, empty_packet
from .contract import AnyType, CalculatorContract, PortSpec, contract
from .calculator import (Calculator, CalculatorContext, InputSet,
                         SourceCalculator)
from .registry import (register_calculator, get_calculator, is_registered,
                       registered_calculators)
from .graph_config import (ExecutorConfig, GraphConfig, NodeConfig,
                           expand_subgraphs, register_subgraph)
from .builder import (BuilderError, GraphBuilder, LoopbackStream, NodeHandle,
                      SidePacket, Stream)
from .input_policy import (DefaultInputPolicy, ImmediateInputPolicy,
                           SyncSetInputPolicy, make_input_policy)
from .validation import GraphValidationError, validate
from .graph import Graph, GraphError, OutputStreamPoller
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NullRegistry)
from .tracer import Tracer, NullTracer, TraceEvent
from . import flow_control  # registers FlowLimiterCalculator
from . import visualizer
from .text_format import (load_graph_config, parse_graph_config,
                          serialize_graph_config, TextFormatError)

__all__ = [
    "Timestamp", "ts", "Packet", "make_packet", "empty_packet",
    "AnyType", "CalculatorContract", "PortSpec", "contract",
    "Calculator", "CalculatorContext", "InputSet", "SourceCalculator",
    "register_calculator", "get_calculator", "is_registered",
    "registered_calculators",
    "ExecutorConfig", "GraphConfig", "NodeConfig", "expand_subgraphs",
    "register_subgraph",
    "BuilderError", "GraphBuilder", "LoopbackStream", "NodeHandle",
    "SidePacket", "Stream",
    "DefaultInputPolicy", "ImmediateInputPolicy", "SyncSetInputPolicy",
    "make_input_policy",
    "GraphValidationError", "validate",
    "Graph", "GraphError", "OutputStreamPoller",
    "Tracer", "NullTracer", "TraceEvent", "visualizer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "load_graph_config", "parse_graph_config", "serialize_graph_config", "TextFormatError",
]
