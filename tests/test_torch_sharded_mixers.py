"""The port's tensor-parallel serving of the MoE FFN and the recurrent
mixers, on the slot, paged, state and hybrid layouts (ROADMAP item
11b-i), on the CPU.

The equivalence runs in ONE subprocess (``tests/_torch_sharded_mixers_
battery.py``), as ``tests/test_torch_sharded.py`` runs the attention
battery: reduced xlstm_1_3b (the JAX battery's ``STATE``) on the state
layout, reduced jamba_1_5_large_398b (its ``HYBRID``, and a 4-kv-head
variant for 4 ranks) on the hybrid layout and a reduced
granite_moe_3b_a800m on the slot and paged layouts, through the port's
``GraphServer`` on meshes of 1, 2 and 4 gloo CPU ranks.  Every run's
tokens must equal the JAX unsharded engine's greedy tokens and the
port's run without a mesh, its first-step logits sit within 1e-4 of
JAX's, and each MoE call drop as many pairs as the unsharded call.  The
tests here are thin, parametrised assertions over its JSON verdicts,
with the ids of ``tests/test_sharded_serving.py``'s state and hybrid
cases.  In this process: the verify window's stacks and the rewind on a
two-rank engine, and the per-rank shapes of the recurrent states.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.serving import LLMEngine  # noqa: E402
from repro_torch.serving.kvcache import StateBackend  # noqa: E402

from test_torch_engine import one_torch_thread  # noqa: E402,F401

_BATTERY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_torch_sharded_mixers_battery.py")
STATE = dataclasses.replace(
    get_config("xlstm_1_3b").reduced(), num_layers=2, d_model=64,
    vocab_size=256, block_pattern=("mlstm", "slstm"))


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
@pytest.mark.parametrize("backend", ["state", "hybrid"])
def test_decode_bit_identical(battery, backend, tp):
    """Greedy decode on the state layouts on an N-rank mesh streams the
    JAX engine's tokens and the port's unsharded run's (hybrid at tp 4:
    the 4-kv-head variant)."""
    _check(battery, f"decode/{backend}/unfused/tp{tp}")


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_moe_decode_bit_identical(battery, backend, tp):
    """The MoE FFN on each rank's experts: the same tokens, and every
    MoE call drops the unsharded call's pairs."""
    _check(battery, f"decode/{backend}/moe/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", ["state", "hybrid"])
def test_verify_window_with_state_rewind(battery, backend, tp):
    """Speculative verify through ``verify_window`` and ``state_rewind``
    over the mirror accepts and emits the unsharded run's tokens."""
    _check(battery, f"verify/{backend}/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", ["state", "hybrid"])
def test_chunked_extend_bit_identical(battery, backend, tp):
    """Chunked prefill continues each rank's state scan exactly."""
    _check(battery, f"extend/{backend}/tp{tp}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("scenario", ["preempt/hybrid", "moe/preempt/paged"])
def test_preemption_replay_bit_identical(battery, scenario, tp):
    """Under block pressure the victims replay their tokens exactly."""
    _check(battery, f"{scenario}/tp{tp}")


@pytest.mark.parametrize("layout", ["state", "hybrid"])
def test_cache_shards_follow_jax(battery, layout):
    """tp for the hybrid layout (its kv heads divide), 1 for a stack
    with no attention layer."""
    _check(battery, f"capacity/{layout}")


@pytest.mark.parametrize("name,tp", [
    ("state", 0), ("state", 1), ("state", 2), ("state", 4),
    ("hybrid", 0), ("hybrid", 1), ("hybrid", 2),
    ("hybrid4", 0), ("hybrid4", 4),
    ("moe", 0), ("moe", 1), ("moe", 2), ("moe", 4)])
def test_first_step_logits_match_jax(battery, name, tp):
    """Every engine's prefill logits within 1e-4 of JAX's, pad masked."""
    _check(battery, f"logits/{name}/tp{tp}")


def test_ranks_hold_rank0_caches_after_every_close(battery):
    _check(battery, "hygiene/rank_cache_ids")


# ---------------------------------------------------------------------------
# in this process: the verify window and the rewind over the mirror
# ---------------------------------------------------------------------------

def test_verify_window_stacks_live_on_every_rank():
    """``verify_window`` on a two-rank engine returns stacks that every
    rank keeps under the call's id (and drops with rank 0's), and
    ``state_rewind`` of window position i commits on every rank the
    state from which a decode of window token i + 1 gives the window's
    guess there."""
    toks = np.random.RandomState(2).randint(0, 256, (2, 7))
    window = np.random.RandomState(3).randint(0, 256, (2, 4))
    engine = LLMEngine(STATE, max_len=32, device="cpu",
                       mesh=make_serving_mesh(2, devices=["cpu"] * 2))
    try:
        backend = StateBackend(engine, num_slots=2)
        _, rows = engine.prefill(toks)
        cache = engine.new_cache(backend)
        for r in range(2):
            engine.insert(backend, cache, rows, r, r)
        del rows
        pos = np.full(2, 7, np.int32)
        guess, cache, stacks = engine.verify_window(
            backend, cache, window, pos, np.ones(2, bool))
        ids = engine.rank_cache_ids()
        assert stacks.tp_id in ids[0] and ids[1] == ids[0], ids
        cache = engine.state_rewind(cache, stacks, 1, 2)
        del stacks
        ids = engine.rank_cache_ids()
        assert ids[1] == ids[0] and len(ids[0]) == 1, ids
        # slot 1 now holds the state after window tokens 0..2: its next
        # decode, of window token 3, is the window's guess there
        nxt, cache = engine.decode(backend, cache, window[:, 3], pos + 3,
                                   np.array([False, True]))
        assert nxt[1] == guess[1, 3]
    finally:
        engine.close()


def test_rank_state_shapes_are_local_tree_shapes():
    """A rank's recurrent state slabs and verify stacks are the rules'
    per-rank shapes: mLSTM's C and n on dk, its m and the sLSTM's state
    on their channels."""
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import local_tree
    from repro_torch.models import transformer as tf
    for tp in (2, 4):
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
        model = Model(STATE, device="cpu", seed=0, mesh=mesh, rank=1)
        want = flatten(local_tree(tf.abstract_cache(STATE, 3, 16), mesh))
        cache = model.new_cache(3, 16)
        got = {p: tuple(a.shape) for p, a in flatten(cache).items()}
        assert got == {p: tuple(a.shape) for p, a in want.items()}
        H, di = STATE.num_heads, 2 * STATE.d_model
        assert got["blocks.l0.mixer.C"] == (1, 3, H, di // H // tp, di // H)
        assert got["blocks.l0.mixer.m"] == (1, 3, H // tp)
        assert got["blocks.l1.mixer.h"] == (1, 3, STATE.d_model // tp)
        stacks = flatten(model.new_state_stacks(cache, 5))
        assert tuple(stacks["blocks.l0.mixer.C"].shape) == \
            (1, 3, 5) + got["blocks.l0.mixer.C"][2:]


def test_worker_pool_serves_engine_after_engine():
    """Engines on one mesh with a ``WorkerPool`` share its worker
    processes: the second engine (another configuration) takes the first
    one's idle workers and serves its own tokens, and ``close`` of the
    pool stops them; without a pool ``close`` stops an engine's own."""
    from repro_torch.sharding.group import WorkerPool
    toks = np.random.RandomState(6).randint(0, 256, (2, 9))
    granite = dataclasses.replace(
        get_config("granite_moe_3b_a800m").reduced(), d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256)
    mesh = make_serving_mesh(2, devices=["cpu"] * 2)
    pool = WorkerPool()
    pids = []
    try:
        for cfg in (STATE, granite, STATE):
            want = LLMEngine(cfg, max_len=32, device="cpu").generate(toks, 4)
            engine = LLMEngine(cfg, max_len=32, device="cpu", mesh=mesh,
                               pool=pool)
            try:
                assert np.array_equal(engine.generate(toks, 4), want)
                pids.append(engine._mirror.workers.procs[0].pid)
                procs = engine._mirror.workers.procs
            finally:
                engine.close()
            assert all(p.is_alive() for p in procs)
    finally:
        pool.close()
    assert len(set(pids)) == 1, pids
    assert all(not p.is_alive() for p in procs)
