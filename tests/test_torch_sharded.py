"""The port's tensor-parallel serving (ROADMAP item 11a) on the CPU.

The equivalence runs in ONE subprocess (``tests/_torch_sharded_battery.py``),
as the JAX package's battery does: it serves reduced minicpm_2b and
reduced qwen3_32b through the port's ``GraphServer`` on meshes of 1, 2
and 4 gloo CPU ranks and holds every run's tokens to the JAX unsharded
engine's greedy tokens and to the port's run without a mesh, and its
first-step logits to JAX's within 1e-4.  The tests here are thin,
parametrised assertions over its JSON verdicts, one per (scenario,
layout, mesh size), with the ids of ``tests/test_sharded_serving.py``'s
slot and paged cases.

In this process: the configurations items 11a and 11b-i refused and
item 11b-ii serves (each builds at tp 4 and its first greedy token is
the unsharded port's), the CUDA graph refusal on a gloo CUDA mesh (a
constructor check, no card needed), and the rank processes' hygiene —
every worker holds exactly rank 0's live caches after a drained
``GraphServer`` closes (``graphserver_leak_check``), a killed worker
fails rank 0's next call within the group timeout, and ``close`` stops
the workers.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh, mesh_desc  # noqa: E402
from repro_torch.serving import GraphServer, LLMEngine  # noqa: E402
from repro_torch.serving.engine import check_tp_support  # noqa: E402

from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401

_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_sharded_battery.py")
ATTN = dataclasses.replace(
    get_config("minicpm_2b").reduced(), num_layers=1, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256)
QWEN4 = dataclasses.replace(
    get_config("qwen3_32b").reduced(), num_layers=1, d_model=64,
    num_heads=8, num_kv_heads=4, head_dim=16, vocab_size=256)


@pytest.fixture(scope="module")
def battery():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, _BATTERY], capture_output=True,
                          text=True, env=env, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("BATTERY ")]
    assert lines, (f"battery produced no verdict (rc={proc.returncode}):\n"
                   f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BATTERY "):])


def _check(battery, key):
    assert key in battery, f"battery never ran {key}: {sorted(battery)}"
    verdict = battery[key]
    assert verdict["ok"], f"{key}: {verdict['detail']}"


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_decode_bit_identical(battery, backend, tp):
    """Greedy decode on an N-rank mesh streams the JAX engine's tokens
    and the port's unsharded run's."""
    _check(battery, f"decode/{backend}/unfused/tp{tp}")


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_decode_bit_identical_fused(battery, backend, tp):
    """The fused decode op on each rank's head slice (K2 on the card)."""
    _check(battery, f"decode/{backend}/fused/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend,tag", [("slot", "unfused"),
                                         ("paged", "unfused"),
                                         ("paged", "fused")])
def test_verify_window_bit_identical(battery, backend, tag, tp):
    """Speculative verify windows accept and emit the same tokens."""
    _check(battery, f"verify/{backend}/{tag}/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_chunked_extend_bit_identical(battery, backend, tp):
    """Chunked prefill lands the same K/V and tokens on a mesh."""
    _check(battery, f"extend/{backend}/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
def test_preemption_replay_bit_identical(battery, tp):
    """Under block pressure the victims replay their tokens exactly."""
    _check(battery, f"preempt/paged/tp{tp}")


def test_default_arena_scales_with_mesh(battery):
    """GraphServer's default paged arena grows by cache_shards()."""
    _check(battery, "capacity/paged")


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("layout", ["slot/unfused", "slot/fused",
                                    "paged/unfused", "paged/fused"])
def test_qwen3_decode_bit_identical(battery, layout, tp):
    """Reduced qwen3_32b (GQA, 8 heads over 4 kv heads, qk-norm)."""
    _check(battery, f"qwen3/decode/{layout}/tp{tp}")


@pytest.mark.parametrize("scenario", ["extend/paged/tp2", "extend/paged/tp4",
                                      "preempt/paged/tp2",
                                      "preempt/paged/tp4"])
def test_qwen3_extend_and_preemption(battery, scenario):
    _check(battery, f"qwen3/{scenario}")


@pytest.mark.parametrize("tp", [0, 1, 2, 4])
@pytest.mark.parametrize("name", ["attn", "qwen3"])
def test_first_step_logits_match_jax(battery, name, tp):
    """Every engine's prefill logits within 1e-4 of JAX's, pad masked."""
    _check(battery, f"logits/{name}/tp{tp}")


def test_ranks_hold_rank0_caches_after_every_close(battery):
    _check(battery, "hygiene/rank_cache_ids")


# ---------------------------------------------------------------------------
# the mesh and the refusals (no rank is started)
# ---------------------------------------------------------------------------

def test_serving_mesh_shape_and_desc():
    mesh = make_serving_mesh(2, devices=["cpu"] * 4)
    assert mesh.devices == ("cpu", "cpu")
    assert mesh.shape == {"data": 1, "model": 2}
    assert mesh_desc(mesh) == {"devices": 2, "axes": {"data": 1,
                                                      "model": 2},
                               "platform": "cpu"}
    assert mesh_desc(None) == {"devices": 1, "axes": {}}
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_serving_mesh(3, devices=["cpu", "cpu"])


def _reduced(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), **kw)


#: what tensor-parallel serving refused at tp 4 until item 11b-ii, and
#: the words each refusal named: MLA, the encoder-decoder, and every
#: width the ranks do not divide (granite's, jamba's and qwen3's 2 kv
#: heads, 6 mLSTM heads, 6 attention heads, Mamba's d_inner 66, 6 padded
#: experts, the sLSTM's gate block of 66, mLSTM's dk of 34).  Item
#: 11b-ii serves them all; the cases keep their ids (below)
REFUSED = [
    ("granite_moe_3b_a800m", {}, "num_kv_heads 2"),     # kv heads 2 % 4
    ("deepseek_v3_671b", {}, "MLA"),                    # MLA (+ MoE)
    ("xlstm_1_3b", {"num_heads": 6, "d_model": 192},
     "mLSTM heads 6"),                                  # mLSTM heads % tp
    ("jamba_1_5_large_398b", {}, "num_kv_heads 2"),     # kv heads 2 % 4
    ("seamless_m4t_large_v2", {}, "encoder-decoder"),   # encoder-decoder
    ("minicpm_2b", {"num_heads": 6, "num_kv_heads": 2},
     "num_heads 6"),                                    # heads % tp
    ("qwen3_32b", {}, "num_kv_heads 2"),                # kv heads 2 % 4
    ("jamba_1_5_large_398b", {"num_kv_heads": 4, "d_model": 66,
                              "ssm_expand": 1},
     "Mamba d_inner 66"),                               # d_inner % tp
    ("granite_moe_3b_a800m", {"num_kv_heads": 4, "num_experts": 6},
     "padded experts 6"),                               # experts % tp
    ("xlstm_1_3b", {"block_pattern": ("slstm",), "d_model": 66},
     "sLSTM gate block"),                               # sLSTM blocks % tp
    ("xlstm_1_3b", {"block_pattern": ("mlstm",), "d_model": 68},
     "mLSTM dk 34"),                                    # mLSTM dk % tp
]


@pytest.fixture(scope="module")
def tp4_pool():
    """One set of four CPU ranks for every case (``WorkerPool``)."""
    from repro_torch.sharding.group import WorkerPool
    pool = WorkerPool()
    yield pool
    pool.close()


@pytest.mark.parametrize("name,kw", [(n, kw) for n, kw, _ in REFUSED])
def test_tp_refuses_what_11a_does_not_serve(name, kw, tp4_pool):
    """The name is kept, as every test id is (ROADMAP Test rules): each
    case was refused at tp 4 until item 11b-ii.  It is served now: the
    engine builds on four CPU ranks and its first greedy token is the
    unsharded port's."""
    cfg = _reduced(name, **kw)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 7))
    want = LLMEngine(cfg, max_len=32, device="cpu").generate(toks, 1)
    engine = LLMEngine(cfg, max_len=32, device="cpu", pool=tp4_pool,
                       mesh=make_serving_mesh(4, devices=["cpu"] * 4))
    try:
        assert np.array_equal(engine.generate(toks, 1), want)
    finally:
        engine.close()


@pytest.mark.parametrize("name,kw,what", REFUSED)
def test_tp_refusal_names_what_waits(name, kw, what):
    """The name is kept (ROADMAP Test rules): each case's refusal named
    ``what`` and item 11b-ii, which serves it.  ``check_tp_support`` now
    returns for it at tp 4."""
    assert check_tp_support(_reduced(name, **kw), 4) is None


def test_cuda_gloo_mesh_refuses_cuda_graphs():
    """A gloo collective cannot be captured: the constructor refuses
    ``cuda_graphs`` on a CUDA mesh before it touches a card."""
    mesh = make_serving_mesh(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        LLMEngine(ATTN, max_len=32, mesh=mesh)


def test_mesh_and_device_must_agree():
    with pytest.raises(ValueError, match="one device type"):
        LLMEngine(ATTN, max_len=32, device="cuda",
                  mesh=make_serving_mesh(2, devices=["cpu"] * 2))


# ---------------------------------------------------------------------------
# rank processes: hygiene and failure
# ---------------------------------------------------------------------------

def test_graphserver_on_a_mesh_leaves_no_worker_cache():
    """A drained GraphServer over a 2-rank engine (the leak check runs at
    its close): its tokens are the unsharded engine's, every worker holds
    exactly rank 0's live caches while the server lives and none once
    it is gone, the state layouts' extend is served at tp 2 (item
    11b-i), and close stops the workers."""
    prompts = [np.random.RandomState(s).randint(0, 256, 7).astype(np.int32)
               for s in range(3)]
    base = LLMEngine(ATTN, max_len=32, device="cpu")
    want = [list(base.generate(p[None], 5)[0]) for p in prompts]
    engine = LLMEngine(ATTN, max_len=32, device="cpu",
                       mesh=make_serving_mesh(2, devices=["cpu", "cpu"]))
    try:
        assert engine.check_extend_support("state") is None
        with GraphServer(engine, num_slots=2, max_new_tokens=5,
                         backend="paged", block_size=8,
                         chunk_size=4) as srv:
            got = [list(h.result(timeout=120))
                   for h in [srv.submit(p) for p in prompts]]
        ids = engine.rank_cache_ids()
        assert ids[0] and ids[1] == ids[0], ids
        del srv
        assert engine.rank_cache_ids() == [[], []]
        assert got == want
        pids = engine._mirror.workers.procs
    finally:
        engine.close()
    assert all(not p.is_alive() for p in pids)
    with pytest.raises(RuntimeError, match="closed"):
        engine.generate(prompts[0][None], 2)


def test_a_row_alone_is_its_row_of_the_batch_at_tp4():
    """The all-reduce sums the ranks' parts in rank order whatever the
    buffer's size, so at four ranks a row's logits are bitwise the same
    alone and in a batch (the law the Scheduler's exactness rests on)."""
    engine = LLMEngine(QWEN4, max_len=32, device="cpu",
                       mesh=make_serving_mesh(4, devices=["cpu"] * 4))
    try:
        toks = np.random.RandomState(4).randint(0, 256, (3, 9))
        batch = engine.prefill_logits(toks)
        for b in range(3):
            assert np.array_equal(engine.prefill_logits(toks[b:b + 1]),
                                  batch[b:b + 1])
    finally:
        engine.close()


def test_killed_worker_fails_rank0_within_the_timeout():
    engine = LLMEngine(ATTN, max_len=32, device="cpu",
                       mesh=make_serving_mesh(2, devices=["cpu", "cpu"],
                                              timeout_s=20))
    try:
        toks = np.arange(6, dtype=np.int32)[None]
        engine.generate(toks, 2)
        proc = engine._mirror.workers.procs[0]
        proc.kill()
        proc.join(10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank group failed"):
            engine.generate(toks, 2)
        assert time.monotonic() - t0 < 30
        with pytest.raises(RuntimeError, match="closed"):
            engine.generate(toks, 2)
    finally:
        engine.close()


def test_worker_error_names_its_traceback():
    """A worker whose command raises exits, and rank 0's call raises
    with the worker's traceback (here a command no engine has)."""
    engine = LLMEngine(ATTN, max_len=32, device="cpu",
                       mesh=make_serving_mesh(2, devices=["cpu", "cpu"],
                                              timeout_s=20))
    try:
        with pytest.raises(RuntimeError, match="(?s)rank 1.*AttributeError"):
            engine._mirror.call("no_such_step", (), {}, lambda: None, None)
    finally:
        engine.close()
