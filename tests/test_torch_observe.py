"""The port's observability surface against the JAX package's catalogue
(docs/OBSERVABILITY.md): the counterparts of
``tests/test_observability.py``'s ``test_metrics_snapshot_names``,
``test_engine_jit_labels`` and ``test_artifact_set_validates``, driven
through the port's ``GraphServer`` on reduced minicpm_2b on the CPU
(chunked prefill and speculation, so every step kind runs).

The port's engine records each step's first call under the JAX
engine's names and labels, once per label set: ``engine.jit_compiles``
(a counter labelled ``step`` / ``layout`` / ``width``) and
``engine.jit_compile_ms`` (a histogram of the first call's wall time;
on the card the kernels' build, the eager run and the graph capture).
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (GraphServer, LLMEngine,  # noqa: E402
                                 PagedBackend, Scheduler)
from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401

_SPEC = importlib.util.spec_from_file_location(
    "validate_observability",
    Path(__file__).resolve().parent.parent / "tools"
    / "validate_observability.py")
vo = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(vo)


def ctotal(snap_entry):
    """Sum of a snapshotted counter's values across label sets."""
    return sum(v["value"] for v in snap_entry["values"])


def hcount(snap_entry):
    """Total observation count of a snapshotted histogram."""
    return sum(v["count"] for v in snap_entry["values"])


def small_cfg():
    cfg = get_config("minicpm_2b").reduced()
    return dataclasses.replace(cfg, num_layers=2, d_model=128,
                               vocab_size=512)


@pytest.fixture(scope="module")
def engine():
    return LLMEngine(small_cfg(), max_len=64, seed=7, device="cpu")


@pytest.fixture(scope="module")
def traced_run(engine, tmp_path_factory):
    """One traced serve with chunked prefill and speculation; the
    artifact set is reused by every assertion below."""
    out = tmp_path_factory.mktemp("obs")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, size=L).astype(np.int32)
               for L in (11, 11, 7)]
    with GraphServer(engine, num_slots=2, max_new_tokens=5,
                     chunk_size=8, speculate_k=3,
                     observe_dir=str(out)) as srv:
        handles = [srv.submit(p, request_id=f"req-{i}")
                   for i, p in enumerate(prompts)]
        results = [h.result(timeout=600) for h in handles]
        arts = srv.dump_observability()
        snap = srv.metrics()
        text = srv.metrics_text()
    return types.SimpleNamespace(out=out, arts=arts, snap=snap, text=text,
                                 results=results, prompts=prompts)


def test_artifact_set_validates(traced_run):
    assert set(traced_run.arts) == {
        "trace.json", "requests.perfetto.json", "timelines.json",
        "metrics.json", "metrics.prom", "provenance.json"}
    assert vo.validate_dir(traced_run.out) == []


def test_metrics_snapshot_names(traced_run):
    names = set(traced_run.snap)
    assert {"serve.ttft_ms", "serve.itl_ms", "serve.queue_wait_ms",
            "serve.decode_step_ms", "serve.batch_occupancy",
            "serve.requests_submitted", "serve.requests_finished",
            "serve.tokens_emitted", "engine.jit_compiles",
            "engine.jit_compile_ms"} <= names
    assert ctotal(traced_run.snap["serve.requests_finished"]) == 3
    assert ctotal(traced_run.snap["serve.tokens_emitted"]) == 15
    assert hcount(traced_run.snap["serve.ttft_ms"]) == 3
    assert "engine_jit_compiles" in traced_run.text


def test_engine_jit_labels(engine, traced_run):
    reg = engine.metrics
    c = reg.get("engine.jit_compiles")
    assert c.total() >= 2                       # prefill + decode
    assert c.value(step="serve_decode", layout="slot/0", width="") >= 1
    hist = reg.get("engine.jit_compile_ms")
    assert hist.quantile(0.5) is not None
    # chunked prefill: the extend and insert steps, and any verify, are
    # labelled as the JAX engine labels them
    values = _values(reg, "engine.jit_compiles")
    steps = {labels["step"] for labels, _ in values}
    assert {"prefill", "serve_decode", "insert", "extend"} <= steps
    for labels, _ in values:
        if labels["step"] == "verify":
            assert labels["layout"] == "slot/0" and int(labels["width"]) > 1
        if labels["step"] == "extend":
            assert int(labels["width"]) % 8 == 0     # the prefix length


def _values(registry, name):
    return [(v["labels"], v["value"])
            for v in registry.snapshot()[name]["values"]]


def test_first_call_recorded_once_per_key():
    """A step's first call is recorded, its later calls are not:
    ``generate`` twice at one batch width records one prefill and one
    lockstep decode (labelled as the JAX engine's ``decode`` on the
    ``batch`` layout); a paged Scheduler run records its layout's
    steps once each, every observation a first call."""
    eng = LLMEngine(small_cfg(), max_len=64, seed=7, device="cpu")
    toks = np.random.RandomState(0).randint(0, 512, (2, 6)).astype(np.int32)
    eng.generate(toks, 4)
    eng.generate(toks, 4)
    c = eng.metrics.get("engine.jit_compiles")
    assert c.value(step="prefill", layout="batch", width="") == 1
    assert c.value(step="decode", layout="batch", width="") == 1
    assert c.total() == 2
    sched = Scheduler(PagedBackend(eng, 2, num_blocks=17, block_size=8),
                      max_new_tokens=4, chunk_size=8)
    for i, n in enumerate((5, 12, 7)):
        sched.submit({"tokens": toks[0, :1].repeat(n), "id": i})
    while sched.has_work():
        sched.admit()
        sched.step()
    assert c.value(step="serve_decode", layout="paged/8", width="") == 1
    assert c.value(step="insert", layout="paged/8", width="") == 1
    assert hcount(eng.metrics.snapshot()["engine.jit_compile_ms"]) \
        == c.total()
