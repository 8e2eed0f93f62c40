"""The port's graph runtime (``repro_torch.core``) and calculator library
(``repro_torch.calculators``) on the CPU.

Three kinds of test:

* the cases of ``tests/test_graph.py`` run against the port's copy —
  chains, pollers, side packets, errors and cancellation, validation,
  subgraphs, executors — plus builder and text-format round trips and
  the CPU side of the port's ``SyncPointCalculator``;
* the copy check: every module the port copies from the JAX package
  equals its reference apart from import lines, docstrings and the named
  changes (the CUDA ``SyncPointCalculator``), read as text;
* the import check: no module of ``src/repro_torch`` imports ``jax`` or
  the JAX package ``repro``, statically or through ``importlib``.

The file also carries the leak check of the port's ``GraphServer``
(``graphserver_leak_check``), which ``test_torch_frontend.py`` imports.
"""
import ast
import difflib
import pathlib
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.calculators  # noqa: E402,F401 - registers the library
from repro_torch.core import (AnyType, Calculator, ExecutorConfig,  # noqa: E402
                              Graph, GraphBuilder, GraphConfig, GraphError,
                              GraphValidationError, TextFormatError,
                              contract, parse_graph_config,
                              register_calculator, register_subgraph,
                              serialize_graph_config, validate, visualizer)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"


# ---------------------------------------------------------------------------
# the port's GraphServer leak check (tests/conftest.py wraps only the JAX
# package's server)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def graphserver_leak_check(monkeypatch):
    """After every close of a port ``GraphServer``: every slot free, no
    block in use or reserved, pool invariants intact, no prefix chain
    left registered, no state slab held, and on a tensor-parallel engine
    every worker rank holding exactly rank 0's live cache ids."""
    from repro_torch.serving.server import GraphServer

    real_close = GraphServer.close
    leaks = []

    def checked_close(self, timeout=300.0):
        first_close = not self._closed
        stats = real_close(self, timeout=timeout)
        if not first_close:
            return stats
        for node in self.graph.nodes:
            sched = getattr(node.calculator, "sched", None)
            if node.name != "engine" or sched is None:
                continue
            if sorted(sched.free) != list(range(sched.num_slots)):
                leaks.append(f"slots leaked: free={sorted(sched.free)} "
                             f"of {sched.num_slots}")
            pool = sched.pool
            if pool is not None:
                try:
                    pool.check_invariants()
                except Exception as e:          # noqa: BLE001
                    leaks.append(f"pool invariants broken: {e}")
                if pool.blocks_in_use or pool.reserved_blocks:
                    leaks.append(f"{pool.blocks_in_use} blocks in use, "
                                 f"{pool.reserved_blocks} reserved after "
                                 f"close")
            if sched.prefix is not None and len(sched.prefix) != 0:
                leaks.append(f"prefix index still holds "
                             f"{len(sched.prefix)} chains after close")
            slabs = getattr(sched.backend, "slabs_in_use", 0)
            if slabs:
                leaks.append(f"{slabs} state slabs still held after close")
            if getattr(sched.engine, "tp", 1) > 1:
                ids = sched.engine.rank_cache_ids()
                if any(r != ids[0] for r in ids):
                    leaks.append(f"worker ranks hold other caches than "
                                 f"rank 0: {ids}")
        return stats

    monkeypatch.setattr(GraphServer, "close", checked_close)
    yield
    assert not leaks, "GraphServer leak check failed:\n  " + \
        "\n  ".join(leaks)


# ---------------------------------------------------------------------------
# calculators of tests/test_graph.py, registered in the port's registry
# ---------------------------------------------------------------------------

@register_calculator
class AddOneCalculator(Calculator):
    CONTRACT = contract().add_input("IN", int).add_output("OUT", int)

    def process(self, ctx):
        p = ctx.inputs["IN"]
        if not p.is_empty():
            ctx.outputs("OUT").add(p.payload + 1, p.timestamp)


@register_calculator
class FailingCalculator(Calculator):
    CONTRACT = contract().add_input("IN", AnyType).add_output("OUT")

    def process(self, ctx):
        raise RuntimeError("boom")


@register_calculator
class SideProducerCalculator(Calculator):
    CONTRACT = (contract().add_input("IN", AnyType)
                .add_output_side_packet("total"))

    def open(self, ctx):
        self.total = 0

    def process(self, ctx):
        if not ctx.inputs["IN"].is_empty():
            self.total += ctx.inputs["IN"].payload

    def close(self, ctx):
        ctx.output_side_packet("total", self.total)


def run_chain(values, n_nodes=3):
    cfg = GraphConfig(input_streams=["s0"], output_streams=[f"s{n_nodes}"])
    for i in range(n_nodes):
        cfg.add_node("AddOneCalculator", name=f"n{i}",
                     inputs={"IN": f"s{i}"}, outputs={"OUT": f"s{i+1}"})
    g = Graph(cfg)
    out = []
    g.observe_output_stream(f"s{n_nodes}", lambda p: out.append(
        (p.timestamp.value, p.payload)))
    g.start_run()
    for t, v in enumerate(values):
        g.add_packet_to_input_stream("s0", v, t)
    g.close_all_input_streams()
    g.wait_until_done(timeout=30)
    return out


class TestGraphBasics:
    def test_chain(self):
        assert run_chain([10, 20, 30]) == [(0, 13), (1, 23), (2, 33)]

    def test_poller(self):
        cfg = GraphConfig(input_streams=["a"], output_streams=["b"])
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "b"})
        g = Graph(cfg)
        poller = g.add_output_stream_poller("b")
        g.start_run()
        g.add_packet_to_input_stream("a", 1, 0)
        g.add_packet_to_input_stream("a", 2, 1)
        g.close_all_input_streams()
        assert poller.next().payload == 2
        assert poller.next().payload == 3
        g.wait_until_done(timeout=30)
        assert poller.next() is None    # closed and drained

    def test_output_side_packet(self):
        cfg = GraphConfig(input_streams=["a"],
                          output_side_packets=["total"])
        cfg.add_node("SideProducerCalculator", inputs={"IN": "a"},
                     output_side_packets={"total": "total"})
        g = Graph(cfg)
        g.start_run()
        for t, v in enumerate([1, 2, 3, 4]):
            g.add_packet_to_input_stream("a", v, t)
        g.close_all_input_streams()
        g.wait_until_done(timeout=30)
        assert g.output_side_packet("total") == 10

    def test_side_packet_gates_open(self):
        """A node whose side packet is produced by another node opens late
        but still correctly."""
        @register_calculator(name="SinkWithSide")
        class _SinkWithSide(Calculator):
            CONTRACT = (contract().add_input("IN", AnyType)
                        .add_output("OUT")
                        .add_input_side_packet("bias", AnyType))

            def open(self, ctx):
                self.bias = ctx.side("bias")

            def process(self, ctx):
                p = ctx.inputs["IN"]
                if not p.is_empty():
                    ctx.outputs("OUT").add(p.payload + self.bias,
                                           p.timestamp)

        cfg = GraphConfig(input_streams=["a", "b"], output_streams=["out"])
        cfg.add_node("SideProducerCalculator", name="producer",
                     inputs={"IN": "a"},
                     output_side_packets={"total": "bias"})
        cfg.add_node("SinkWithSide", name="consumer",
                     inputs={"IN": "b"}, outputs={"OUT": "out"},
                     input_side_packets={"bias": "bias"})
        g = Graph(cfg)
        out = []
        g.observe_output_stream("out", lambda p: out.append(p.payload))
        g.start_run()
        g.add_packet_to_input_stream("a", 5, 0)
        g.add_packet_to_input_stream("b", 100, 0)
        g.close_input_stream("a")   # producer closes -> side packet lands
        time.sleep(0.1)
        g.add_packet_to_input_stream("b", 200, 1)
        g.close_all_input_streams()
        g.wait_until_done(timeout=30)
        assert out == [105, 205]

    def test_error_terminates_run(self):
        cfg = GraphConfig(input_streams=["a"], output_streams=["b"])
        cfg.add_node("FailingCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "b"})
        g = Graph(cfg)
        g.start_run()
        g.add_packet_to_input_stream("a", 1, 0)
        g.close_all_input_streams()
        with pytest.raises(GraphError, match="boom"):
            g.wait_until_done(timeout=30)

    def test_cancel(self):
        cfg = GraphConfig(input_streams=["a"], output_streams=["b"])
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "b"})
        g = Graph(cfg)
        g.start_run()
        g.cancel()
        with pytest.raises(GraphError, match="cancel"):
            g.wait_until_done(timeout=10)

    def test_runner_error_surfaces_instead_of_hanging(self):
        """An exception escaping the task runner itself (not calculator
        code) surfaces as the run's recorded error."""
        cfg = GraphConfig(input_streams=["a"], output_streams=["b"])
        cfg.add_node("AddOneCalculator", name="n0", inputs={"IN": "a"},
                     outputs={"OUT": "b"})
        g = Graph(cfg)
        g.start_run()

        class BrokenPolicy:
            def ready_timestamp(self, queues):
                return g.nodes[0].input_queues["IN"].bound  # pretend ready

            def pop_input_set(self, queues, t):
                raise RuntimeError("scheduler state corrupted")

        deadline = time.monotonic() + 10
        while g.nodes[0].state != g.nodes[0].OPENED:
            if time.monotonic() > deadline:  # pragma: no cover
                pytest.fail("node never opened")
            time.sleep(0.01)
        g.nodes[0].policy = BrokenPolicy()
        g.add_packet_to_input_stream("a", 1, 0)
        g.close_all_input_streams()
        with pytest.raises(GraphError, match="scheduler state corrupted"):
            g.wait_until_done(timeout=30)

    def test_executor_on_error_callback(self):
        from repro_torch.core.executor import Executor
        seen = []
        done = threading.Event()

        def boom(task):
            raise ValueError(f"task {task}")

        def on_error(e):
            seen.append(e)
            done.set()

        ex = Executor("t", 1, boom, on_error=on_error)
        ex.start()
        ex.submit(0, "x")
        assert done.wait(timeout=10)
        ex.stop()
        assert isinstance(seen[0], ValueError)


class TestValidation:
    def test_unknown_calculator(self):
        cfg = GraphConfig()
        cfg.add_node("NoSuchCalculator")
        with pytest.raises((GraphValidationError, KeyError)):
            Graph(cfg)

    def test_missing_producer(self):
        cfg = GraphConfig(output_streams=["out"])
        cfg.add_node("AddOneCalculator", inputs={"IN": "nowhere"},
                     outputs={"OUT": "out"})
        with pytest.raises(GraphValidationError, match="no producer"):
            Graph(cfg)

    def test_double_producer(self):
        cfg = GraphConfig(input_streams=["a"])
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "dup"})
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "dup"})
        with pytest.raises(GraphValidationError, match="produced by both"):
            Graph(cfg)

    def test_type_mismatch(self):
        @register_calculator
        class StrSource(Calculator):
            CONTRACT = contract().add_output("OUT", str)

            def process(self, ctx):
                return False

        cfg = GraphConfig()
        cfg.add_node("StrSource", outputs={"OUT": "s"})
        cfg.add_node("AddOneCalculator", inputs={"IN": "s"},
                     outputs={"OUT": "t"})
        with pytest.raises(GraphValidationError, match="type mismatch"):
            Graph(cfg)

    def test_unconnected_required_input(self):
        cfg = GraphConfig()
        cfg.add_node("AddOneCalculator", outputs={"OUT": "x"})
        with pytest.raises(GraphValidationError, match="required input"):
            Graph(cfg)

    def test_undeclared_cycle_rejected(self):
        @register_calculator(name="TwoInAdd")
        class _TwoInAdd(Calculator):
            CONTRACT = (contract().add_input("IN", AnyType)
                        .add_input("LOOP", AnyType, optional=True)
                        .add_output("OUT"))

            def process(self, ctx):
                pass

        cfg = GraphConfig(input_streams=["a"])
        cfg.add_node("TwoInAdd", name="x",
                     inputs={"IN": "a", "LOOP": "y_out"},
                     outputs={"OUT": "x_out"})
        cfg.add_node("AddOneCalculator", name="y",
                     inputs={"IN": "x_out"}, outputs={"OUT": "y_out"})
        with pytest.raises(GraphValidationError, match="cycle"):
            Graph(cfg)


class TestSubgraphs:
    def test_expansion_semantics(self):
        sub = GraphConfig(input_streams=["in"], output_streams=["out"])
        sub.add_node("AddOneCalculator", name="inner1",
                     inputs={"IN": "in"}, outputs={"OUT": "mid"})
        sub.add_node("AddOneCalculator", name="inner2",
                     inputs={"IN": "mid"}, outputs={"OUT": "out"})
        register_subgraph("AddTwoSubgraph", sub)

        cfg = GraphConfig(input_streams=["x"], output_streams=["y"])
        cfg.add_node("AddTwoSubgraph", name="plus2",
                     inputs={"in": "x"}, outputs={"out": "mid"})
        cfg.add_node("AddOneCalculator", inputs={"IN": "mid"},
                     outputs={"OUT": "y"})
        g = Graph(cfg)
        out = []
        g.observe_output_stream("y", lambda p: out.append(p.payload))
        g.start_run()
        g.add_packet_to_input_stream("x", 0, 0)
        g.close_all_input_streams()
        g.wait_until_done(timeout=30)
        assert out == [3]
        assert any("plus2/" in n.name for n in g.nodes)


class TestExecutors:
    def test_dedicated_executor_runs(self):
        cfg = GraphConfig(input_streams=["a"], output_streams=["b"],
                          executors=[ExecutorConfig("heavy", 2)])
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "b"}, executor="heavy")
        g = Graph(cfg)
        out = []
        g.observe_output_stream("b", lambda p: out.append(p.payload))
        g.start_run()
        for t in range(20):
            g.add_packet_to_input_stream("a", t, t)
        g.close_all_input_streams()
        g.wait_until_done(timeout=30)
        assert out == [t + 1 for t in range(20)]

    def test_unknown_executor_rejected(self):
        cfg = GraphConfig(input_streams=["a"])
        cfg.add_node("AddOneCalculator", inputs={"IN": "a"},
                     outputs={"OUT": "b"}, executor="ghost")
        with pytest.raises(GraphError, match="unknown executor"):
            Graph(cfg)


# ---------------------------------------------------------------------------
# builder and text format
# ---------------------------------------------------------------------------

def _fig1_builder():
    """The paper's Fig.-1 skeleton, authored with the typed builder."""
    b = GraphBuilder(num_threads=4, enable_tracer=True)
    frame = b.input("frame")
    b.executor("inference", 1)
    select = b.add_node("FrameSelectCalculator", name="select",
                        inputs={"IN": frame}, options={"every": 3})
    detect = b.add_node("ObjectDetectorCalculator", name="detect",
                        inputs={"FRAME": select.out("OUT", name="selected")},
                        executor="inference", options={"threshold": 0.3})
    overlay = b.add_node(
        "AnnotationOverlayCalculator", name="annotate",
        inputs={"FRAME": frame,
                "DETECTIONS": detect.out("DETECTIONS", name="detections")})
    b.output(overlay.out("ANNOTATED_FRAME", name="annotated"))
    return b.build()


def _run_fig1(cfg, frames):
    g = Graph(cfg)
    out = []
    g.observe_output_stream("annotated", out.append)
    g.start_run()
    for t, f in enumerate(frames):
        g.add_packet_to_input_stream("frame", f, t)
    g.close_all_input_streams()
    g.wait_until_done(timeout=30)
    return out


def test_builder_text_format_round_trip_runs_identically():
    cfg = _fig1_builder()
    validate(cfg)
    text = serialize_graph_config(cfg)
    back = parse_graph_config(text)
    assert back == cfg
    assert serialize_graph_config(back) == text
    rng = np.random.RandomState(0)
    frames = [(rng.rand(16, 16) * 255).astype(np.float32) for _ in range(6)]
    a, b = _run_fig1(cfg, frames), _run_fig1(back, frames)
    assert [p.timestamp.value for p in a] == list(range(6))
    assert [p.timestamp.value for p in b] == list(range(6))
    for x, y in zip(a, b):
        assert np.array_equal(x.payload, y.payload)
    assert "detect" in visualizer.topology_ascii(cfg)
    assert "digraph" in visualizer.topology_dot(cfg)


def test_loopback_builder_and_bad_text_rejected():
    b = GraphBuilder()
    finished = b.loopback()
    limiter = b.add_node("FlowLimiterCalculator", name="limiter",
                         inputs={"IN": b.input("in"), "FINISHED": finished},
                         options={"max_in_flight": 2})
    loop = b.add_node("PassThroughCalculator", name="loop",
                      inputs={"out": limiter.out("OUT", name="out")})
    finished.tie(loop.out("out", name="loop_out"))
    cfg = b.build()
    assert cfg.nodes[0].back_edge_inputs == ["FINISHED"]
    assert parse_graph_config(serialize_graph_config(cfg)) == cfg
    Graph(cfg)                       # the declared cycle validates
    for bad in ("node { }", "bogus_field: 3",
                'node { calculator: "X" weird: 1 }'):
        with pytest.raises(TextFormatError):
            parse_graph_config(bad)


def test_serving_graphs_equal_the_reference_text():
    """The port's two serving graphs serialize to the JAX package's
    text, option for option."""
    from repro.core import serialize_graph_config as ref_serialize
    from repro.serving import pipeline as ref_pipeline
    from repro_torch.serving import pipeline
    for kw in ({}, {"num_slots": 2, "eos_id": 5, "drop_on_overload": True},
               {"paged": True, "num_blocks": 33, "chunk_size": 8,
                "speculate_k": 3}):
        port = pipeline.build_continuous_serving_graph(**kw)
        validate(port)
        assert serialize_graph_config(port) == ref_serialize(
            ref_pipeline.build_continuous_serving_graph(**kw))
    assert serialize_graph_config(pipeline.build_serving_graph()) == \
        ref_serialize(ref_pipeline.build_serving_graph())


# ---------------------------------------------------------------------------
# the sync point on the CPU
# ---------------------------------------------------------------------------

def _sync_graph(engine):
    b = GraphBuilder()
    infer = b.add_node("InferenceCalculator", name="infer",
                       inputs={"IN": b.input("in")},
                       side_inputs={"engine": b.side_input("engine")})
    sync = b.add_node("SyncPointCalculator", name="sync",
                      inputs={"IN": infer.out("OUT", name="results")})
    b.output(sync.out("OUT", name="synced"))
    g = Graph(b.build(), side_packets={"engine": engine})
    return g, g.add_output_stream_poller("synced")


def test_sync_point_passes_cpu_payloads_through():
    """CPU tensors (bare or nested) and other payloads leave the sync
    point as the same objects, without touching CUDA."""
    x = torch.arange(6.0).view(2, 3)
    payloads = [x, (x, 1), [x, "a"], {"t": x, "n": None}, "text",
                np.arange(3)]
    g, poller = _sync_graph(lambda i: payloads[i])
    g.start_run()
    for i in range(len(payloads)):
        g.add_packet_to_input_stream("in", i, i)
    g.close_all_input_streams()
    got = [poller.next() for _ in payloads]
    g.wait_until_done(timeout=30)
    assert [p.timestamp.value for p in got] == list(range(len(payloads)))
    for p, want in zip(got, payloads):
        assert p.payload is want


def test_sync_point_lets_a_device_error_fail_the_run(monkeypatch):
    """The sync point catches nothing: an error raised by the wait on a
    CUDA payload fails the graph run (the card itself is exercised by
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.calculators import basic

    class FailingEvent:
        def record(self, stream):
            pass

        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(basic, "_cuda_devices",
                        lambda payload: {torch.device("cuda", 0)})
    monkeypatch.setattr(basic.torch.cuda, "Event", FailingEvent)
    monkeypatch.setattr(basic.torch.cuda, "current_stream",
                        lambda device: None)
    g, _ = _sync_graph(lambda i: i)
    g.start_run()
    g.add_packet_to_input_stream("in", 0, 0)
    g.close_all_input_streams()
    with pytest.raises(GraphError, match="illegal memory access"):
        g.wait_until_done(timeout=30)


# ---------------------------------------------------------------------------
# the copies: imports and named changes only
# ---------------------------------------------------------------------------

CORE = ("timestamp", "packet", "contract", "calculator", "registry",
        "stream", "graph_config", "input_policy", "validation", "executor",
        "graph", "flow_control", "builder", "text_format", "visualizer",
        "__init__", "metrics", "tracer")
COPIES = ([f"core/{m}.py" for m in CORE]
          + [f"calculators/{m}.py" for m in ("__init__", "basic",
                                             "perception", "inference")]
          + [f"serving/{m}.py" for m in ("observe", "calculators",
                                         "pipeline", "server", "frontend",
                                         "batching", "speculative")]
          + ["serving/kvcache/allocator.py", "serving/kvcache/prefix.py",
             "serving/kvcache/state.py", "launch/serve.py",
             "data/__init__.py", "data/pipeline.py"])
#: the definitions a copy may change or add, by file: top-level ones by
#: name, methods as ``Class.method``
NAMED = {"calculators/basic.py": {"SyncPointCalculator", "_cuda_devices"},
         "serving/server.py": {"GraphServer._pump"},
         # --reduced can be turned off, and --device picks the engine's
         "launch/serve.py": {"main"},
         # the state backend keeps the base's stats (``replay_steps``)
         "serving/kvcache/state.py": {"StateBackend._stat_seed"}}


def _named_nodes(tree, named):
    """The definitions of ``tree`` that ``named`` names, with the names:
    top-level ones, and the methods of top-level classes."""
    for node in tree.body:
        name = getattr(node, "name", None)
        if name in named:
            yield name, node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                qual = f"{name}.{getattr(sub, 'name', None)}"
                if qual in named:
                    yield qual, sub


def _free_lines(tree, named):
    """Line numbers a copy may change: docstrings, import statements and
    the named definitions (decorators included)."""
    free = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            free.update(range(node.lineno, node.end_lineno + 1))
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            doc = node.body[0]
            if isinstance(doc, ast.Expr) and \
                    isinstance(doc.value, ast.Constant) and \
                    isinstance(doc.value.value, str):
                free.update(range(doc.lineno, doc.end_lineno + 1))
    for _, node in _named_nodes(tree, named):
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        free.update(range(first, node.end_lineno + 1))
    return free


def _code(text, named):
    """The module's code without docstrings, imports and the named
    definitions, as an ``ast.dump``."""
    class Strip(ast.NodeTransformer):
        def generic_visit(self, node):
            super().generic_visit(node)
            body = getattr(node, "body", None)
            if isinstance(body, list):
                body = [n for n in body if not isinstance(
                    n, (ast.Import, ast.ImportFrom))]
                if body and isinstance(body[0], ast.Expr) and \
                        isinstance(body[0].value, ast.Constant) and \
                        isinstance(body[0].value.value, str):
                    body = body[1:]
                node.body = body or [ast.Pass()]
            return node

    tree = Strip().visit(ast.parse(text))
    drop = {id(node) for _, node in _named_nodes(tree, named)}
    tree.body = [n for n in tree.body if id(n) not in drop]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            cls.body = [n for n in cls.body if id(n) not in drop] \
                or [ast.Pass()]
    return ast.dump(tree)


def _copy_faults(rel, ref_text, port_text, named):
    """Where ``port_text`` differs from ``ref_text`` outside imports,
    docstrings and the ``named`` definitions, or lacks one of those."""
    ref_tree = ast.parse(ref_text)
    port_tree = ast.parse(port_text)
    ref_free = _free_lines(ref_tree, named)
    port_free = _free_lines(port_tree, named)
    faults = []
    if _code(port_text, named) != _code(ref_text, named):
        faults.append(f"{rel}: code differs from src/repro/{rel}")
    ref_lines, port_lines = ref_text.splitlines(), port_text.splitlines()
    matcher = difflib.SequenceMatcher(None, ref_lines, port_lines,
                                      autojunk=False)
    for op, i1, i2, j1, j2 in matcher.get_opcodes():
        if op == "equal":
            continue
        faults += [f"{rel}: reference line {i + 1} changed: "
                   f"{ref_lines[i]!r}" for i in range(i1, i2)
                   if i + 1 not in ref_free and ref_lines[i].strip()]
        faults += [f"{rel}: line {j + 1} changed: {port_lines[j]!r}"
                   for j in range(j1, j2)
                   if j + 1 not in port_free and port_lines[j].strip()]
    found = {name for name, _ in _named_nodes(port_tree, named)}
    faults += [f"{rel}: {name} missing" for name in sorted(named - found)]
    return faults


def _texts(rel):
    """(the reference's text with ``repro.`` read as ``repro_torch.``,
    the port's text) of copied module ``rel``."""
    return (re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text()),
            (PORT / rel).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_imports_and_named_changes(rel):
    faults = _copy_faults(rel, *_texts(rel), NAMED.get(rel, set()))
    assert not faults, "\n".join(faults)


def test_copy_check_frees_a_named_method_only():
    """``GraphServer._pump`` is a named change of the server's copy: a
    change inside it passes, a change to any other method of the class
    or to a named method that is gone is still caught."""
    rel = "serving/server.py"
    named = NAMED[rel]
    ref_text, port_text = _texts(rel)
    inside = port_text.replace(
        "                dispatch(pkt.payload)",
        "                dispatch(pkt.payload)\n                pass")
    assert inside != port_text
    assert not _copy_faults(rel, ref_text, inside, named)
    for old, new in (
            ('self._handles.pop(payload["id"], None)',
             'self._handles.pop(payload["id"])'),      # _dispatch_token
            ("h._on_error(err)", "h._on_error(err) or None"),
            ("self._pump(self._token_poller, self._dispatch_token)",
             "return self._pump(self._token_poller, "
             "self._dispatch_token)")):
        changed = port_text.replace(old, new)
        assert changed != port_text, old
        assert _copy_faults(rel, ref_text, changed, named), old
    gone = port_text.replace("def _pump(self", "def _pump_renamed(self")
    assert any("_pump missing" in f
               for f in _copy_faults(rel, ref_text, gone, named))


def test_sync_point_imports_no_jax_and_catches_nothing():
    tree = ast.parse((PORT / "calculators/basic.py").read_text())
    cls = next(n for n in tree.body
               if getattr(n, "name", None) == "SyncPointCalculator")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(cls))
    assert "jax" not in ast.dump(cls)


# ---------------------------------------------------------------------------
# no jax and no repro anywhere in the port
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_names(path):
    """(line, module) for every import in ``path``: import statements,
    absolute and relative (resolved against the package), and
    ``importlib.import_module`` / ``__import__`` calls with a literal."""
    rel = path.relative_to(ROOT / "src")
    package = list(rel.parent.parts)
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module or ""
            else:
                up = node.level - 1
                assert up < len(package), \
                    f"{rel}:{node.lineno} imports above the package"
                base = package[:len(package) - up]
                yield node.lineno, ".".join(
                    base + ([node.module] if node.module else []))
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_has_no_jax_or_repro_import():
    """Every module of ``src/repro_torch`` is walked with ``ast``: no
    import of ``jax`` or of the JAX package, relative imports resolved
    (``test_torch_engine.py`` checks the absolute ones file by file,
    ``chip_smoke.py`` too)."""
    offenders = []
    paths = sorted(PORT.rglob("*.py"))
    assert len(paths) > 40
    for path in paths:
        for line, name in _imported_names(path):
            if name.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(ROOT)}:{line} {name}")
    assert not offenders, "\n".join(offenders)
