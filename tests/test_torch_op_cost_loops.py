"""The op counter's token loops (``launch/op_cost.py``'s
``OpCounter.scan`` through ``models/layers.py``'s ``scan``): a loop of
more than 3 steps is priced once and scaled by its trip count, as the
JAX package's ``hlo_cost`` prices a ``while`` body.  Each case counts
one step on ``meta`` tensors twice, scaled and with
``OpCounter(scale_loops=False)`` (every step dispatched), on reduced
configs: FLOPs, bytes, ops by name, collective bytes by kind and by
line and the collective calls equal to a relative 1e-9, the peak within
1%.
"""
import contextlib
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import TrainingMesh  # noqa: E402
from repro_torch.launch.op_cost import OpCounter  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.steps import make_state_verify_step  # noqa: E402

from test_torch_engine import one_torch_thread  # noqa: E402,F401


def _config(arch):
    """The reduced config; xlstm's with an mLSTM and an sLSTM layer (its
    reduced two layers are both mLSTM)."""
    cfg = get_config(arch).reduced()
    if arch == "xlstm_1_3b":
        cfg = dataclasses.replace(cfg, block_pattern=("mlstm", "slstm"))
    return cfg


def _dry_step(arch, kind, seq, batch, mesh_shape):
    """The dry run's rank-0 step of the reduced ``arch`` at ``kind``,
    ``seq`` tokens, ``batch`` rows, on a (data, model) mesh."""
    cfg = _config(arch)
    orig = dryrun.get_config, dryrun.INPUT_SHAPES
    dryrun.get_config = lambda a: cfg
    dryrun.INPUT_SHAPES = {"x": InputShape("x", seq, batch, kind)}
    try:
        mesh = TrainingMesh(("meta",) * math.prod(mesh_shape),
                            ("data", "model"), mesh_shape)
        return dryrun.build_lowering(arch, "x", mesh)
    finally:
        dryrun.get_config, dryrun.INPUT_SHAPES = orig


def _count(run, scale_loops, record=None):
    with OpCounter(scale_loops=scale_loops) as c:
        if record is not None:
            record()
        run()
    return c


def _close(a, b, tol=1e-9):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1.0)


def assert_same_count(scaled, every):
    """The scaled count is the count of every step."""
    for key in ("flops", "bytes", "coll_calls"):
        assert _close(getattr(scaled, key), getattr(every, key)), \
            (key, getattr(scaled, key), getattr(every, key))
    for name in set(scaled.ops) | set(every.ops):
        assert _close(scaled.ops[name], every.ops[name]), \
            (name, scaled.ops[name], every.ops[name])
    for kind in every.coll:
        assert _close(scaled.coll[kind], every.coll[kind]), kind
    assert set(scaled.coll_by_line) == set(every.coll_by_line)
    for key in every.coll_by_line:
        assert _close(scaled.coll_by_line[key], every.coll_by_line[key]), key
    assert abs(scaled.peak_bytes - every.peak_bytes) <= \
        0.01 * every.peak_bytes, (scaled.peak_bytes, every.peak_bytes)


#: (arch, kind, tokens, global rows, (data, model)): the token loops of
#: the mLSTM and sLSTM at prefill, of the sLSTM's two-level scan in a
#: train step (two outer chunks of 64 under ``remat``, the backward and
#: its recompute included), of Mamba at prefill, and the sLSTM on a
#: tp-2 serving rank (one all-reduce a token)
LOOPS = {
    "xlstm_prefill": ("xlstm_1_3b", "prefill", 128, 2, (1, 1)),
    "xlstm_train": ("xlstm_1_3b", "train", 128, 2, (1, 1)),
    "jamba_prefill": ("jamba_1_5_large_398b", "prefill", 96, 2, (1, 1)),
    "xlstm_prefill_tp2": ("xlstm_1_3b", "prefill", 128, 4, (2, 2)),
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_scaled_loop_counts_every_step(case):
    arch, kind, seq, batch, mesh = LOOPS[case]
    step = _dry_step(arch, kind, seq, batch, mesh)
    record = step.record_gathers if step.recorder is not None else None
    every = _count(step.run, False, record)
    scaled = _count(step.run, True, record)
    assert_same_count(scaled, every)
    # the scaled count dispatched a few steps of each loop, not all
    assert scaled.n_ops < every.n_ops / 3, (scaled.n_ops, every.n_ops)
    if case == "xlstm_prefill_tp2":
        # the sLSTM gathers h whole before every token
        assert every.coll_by_line[("model", "all-reduce")] > 0
        assert every.coll_calls > seq


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_1_5_large_398b"])
def test_one_token_decode_is_unchanged(arch):
    """A decode step has no loop of more than one token: both counts
    dispatch the same ops."""
    step = _dry_step(arch, "decode", 128, 4, (2, 2))
    every = _count(step.run, False, step.record_gathers)
    scaled = _count(step.run, True, step.record_gathers)
    assert scaled.n_ops == every.n_ops
    assert dict(scaled.ops) == dict(every.ops)
    assert (scaled.flops, scaled.bytes, scaled.peak_bytes) == \
        (every.flops, every.bytes, every.peak_bytes)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_1_5_large_398b"])
def test_verify_window_with_stacks(arch):
    """A state-layout verify window of 8 tokens writes the state after
    every position into the stacks (``_write_stack``, Mamba's copies):
    the scaled count is every step's."""
    cfg = _config(arch)
    model = Model(cfg, device="meta")
    step = make_state_verify_step(model, dryrun.plain_flags())
    B, W = 3, 8

    def run():
        cache = model.new_cache(B, 64)
        stacks = model.new_state_stacks(cache, W)
        tokens = torch.zeros((B, W), dtype=torch.int32, device="meta")
        positions = torch.zeros(B, dtype=torch.int32, device="meta")
        active = torch.ones(B, dtype=torch.bool, device="meta")
        step(tokens, cache, positions, active, stacks=stacks)

    every = _count(run, False)
    scaled = _count(run, True)
    assert_same_count(scaled, every)
    assert scaled.n_ops < every.n_ops


def test_a_carry_that_changes_is_refused():
    """A loop whose carry changes dtype after step 1 cannot be priced
    once: it raises, naming the loop; counted step by step it runs."""
    def body(t, carry):
        nxt = carry * 2 if t == 0 else (carry * 2).double()
        return nxt, nxt

    x = torch.empty(4, 8, device="meta")
    with OpCounter():
        with pytest.raises(ValueError, match="my_loop"):
            layers.scan(body, x, 6, "my_loop")
    with OpCounter(scale_loops=False):
        carry, outs = layers.scan(body, x, 6, "my_loop")
    assert carry.dtype == torch.float64 and len(outs) == 6


def test_real_tensors_take_the_plain_loop():
    """On tensors, counted or not, ``scan`` runs every step in order."""
    seen = []

    def body(t, carry):
        seen.append(t)
        return carry + t, carry

    for counted in (False, True):
        seen.clear()
        with OpCounter() if counted else contextlib.nullcontext():
            carry, outs = layers.scan(body, torch.zeros(()), 5, "plain")
        assert seen == list(range(5)) and float(carry) == 10.0
        assert [float(o) for o in outs] == [0, 0, 1, 3, 6]
