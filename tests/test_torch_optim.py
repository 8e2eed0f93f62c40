"""The port's optimizers, schedules, data pipeline copy and checkpoint
store against the JAX package's, on the CPU.

* ``cosine_schedule``/``wsd_schedule`` within 1e-7 relative of JAX's at
  steps 0-200 (the port rounds its cosine once from f64, within an ulp
  of XLA's).
* ``adamw_update``/``adafactor_update`` on a tree of factored and
  unfactored f32 and bf16 leaves, three steps from JAX's grads: params
  and state within 1e-6 of each leaf's scale (f32) or one bf16 ulp
  (bf16 params), also with the leaves cut into blocks.
* The data pipeline is a copy: the same batches bitwise.
* A checkpoint crosses both ways bitwise: JAX saves, the port loads;
  the port saves, JAX loads; the port's index and leaf files are
  byte for byte JAX's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.runtime.steps import TrainState as JaxTrainState  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim import schedules as sched  # noqa: E402
from repro_torch.runtime.steps import TrainState  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401

SCHEDULES = [("wsd", dict(peak_lr=3e-4, warmup=5, total=100)),
             ("wsd", dict(peak_lr=1e-3, warmup=2, total=10)),
             ("cosine", dict(peak_lr=3e-4, warmup=5, total=100)),
             ("cosine", dict(peak_lr=1e-2, warmup=50, total=1000)),
             ("cosine", dict(peak_lr=3e-4, warmup=0, total=1))]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_matches_jax(name, kw):
    want = np.array([float(jsched.make_schedule(name, **kw)(s))
                     for s in range(201)])
    got = np.array([float(sched.make_schedule(name, **kw)(s))
                    for s in range(201)])
    assert sched.make_schedule(name, **kw)(3).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


#: (shape, dtype) of the test tree's leaves: factored (both trailing
#: dims >= 8, with and without leading dims) and unfactored ones
LEAVES = {"w": ((16, 24), np.float32), "stack": ((3, 8, 12), np.float32),
          "vec": ((10,), np.float32), "thin": ((4, 32), np.float32),
          "bf": ((9, 16), "bfloat16"), "sub": {"b": ((8,), "bfloat16"),
                                               "m": ((2, 8, 8), np.float32)}}


def _tree(spec, rng, scale=1.0):
    if isinstance(spec, dict):
        return {k: _tree(v, rng, scale) for k, v in spec.items()}
    shape, dt = spec
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16 if dt == "bfloat16" else dt)


def to_torch(x):
    """A JAX value (tree) as the port's: arrays to tensors (bf16 through
    its bits), the NamedTuples to the port's."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_torch(v) for k, v in x.items()}
    if isinstance(x, jopt.OptState):
        return opt.OptState(*(to_torch(v) for v in x))
    if isinstance(x, JaxTrainState):
        return TrainState(*(to_torch(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to_torch(v) for v in x)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_tree_close(want, got):
    w, g = jax.tree.leaves(to_numpy(want)), jax.tree.leaves(to_numpy(got))
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.uint16:                  # bf16 bits: one ulp
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            scale = max(np.abs(a).max(), 1e-30)
            assert np.abs(a - b).max() <= 1e-6 * scale, \
                (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("block", [None, 40])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_jax(name, block, monkeypatch):
    """Three updates from the same params, state and grads: the port's
    params and state against JAX's (``block`` cuts every leaf into
    blocks of at most that many elements)."""
    if block is not None:
        monkeypatch.setattr(opt, "BLOCK", block)
    rng = np.random.RandomState(0)
    jparams = _tree(LEAVES, rng)
    j_init, j_update = jopt.make_optimizer(name)
    t_init, t_update = opt.make_optimizer(name)
    jstate = j_init(jparams)
    params = to_torch(jparams)
    state = t_init(params)
    _assert_tree_close(jstate, state)
    for step in range(3):
        grads = _tree(LEAVES, rng, scale=10.0 ** (step - 1))
        lr = jnp.float32(1e-2 * (step + 1))
        jparams, jstate = j_update(grads, jstate, jparams, lr)
        params, state = t_update(to_torch(grads), state, params,
                                 torch.tensor(1e-2 * (step + 1),
                                              dtype=torch.float32))
        assert int(state.step) == step + 1
        _assert_tree_close(jparams, params)
        _assert_tree_close(jstate, state)


def test_adafactor_state_is_factored_as_jax():
    params = to_torch(_tree(LEAVES, np.random.RandomState(1)))
    v = opt.adafactor_init(params).v
    assert isinstance(v["w"], tuple) and v["w"][0].shape == (16,) \
        and v["w"][1].shape == (24,)
    assert v["stack"][0].shape == (3, 8) and v["stack"][1].shape == (3, 12)
    assert not isinstance(v["vec"], tuple) and not isinstance(v["thin"],
                                                               tuple)
    for shape in ((8, 8), (3, 8, 9), (7, 8), (8,), (4, 8, 7)):
        assert opt._factored(shape) == jopt._factored(shape)


@pytest.mark.parametrize("index", [0, 3, 17])
def test_data_pipeline_copy_batches_bitwise(index):
    for vocab, seq, seed in ((1024, 64, 0), (50000, 33, 7)):
        want = jpipe.SyntheticTextDataset(vocab, seq, seed).batch(index, 3)
        got = pipeline.SyntheticTextDataset(vocab, seq, seed).batch(index, 3)
        for k in ("tokens", "labels"):
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(want[k], got[k])


def _state(name):
    rng = np.random.RandomState(2)
    params = _tree(LEAVES, rng)
    init, update = jopt.make_optimizer(name)
    st = init(params)
    params, st = update(_tree(LEAVES, rng), st, params, jnp.float32(1e-2))
    return JaxTrainState(params, st)


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoint_crosses_both_ways_bitwise(name, tmp_path):
    jstate = _state(name)
    like = to_torch(jstate)
    # JAX saves, the port loads
    jpath = jstore.save_checkpoint(str(tmp_path / "jax"), 5, jstate)
    got = store.load_checkpoint(str(tmp_path / "jax"), None, like)
    assert isinstance(got, TrainState) and isinstance(got.opt, opt.OptState)
    for a, b in zip(jax.tree.leaves(to_numpy(jstate)),
                    jax.tree.leaves(to_numpy(got))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port saves, JAX loads
    tpath = store.save_checkpoint(str(tmp_path / "port"), 5, got)
    assert store.latest_step(str(tmp_path / "port")) == 5
    back = jstore.load_checkpoint(str(tmp_path / "port"), None, jstate)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    # the same files, byte for byte
    assert _files(jpath) == _files(tpath)
    index = msgpack.unpackb(open(os.path.join(tpath, "index.msgpack"),
                                 "rb").read())
    assert [e["key"] for e in index["leaves"]][:2] == [".params/bf",
                                                       ".params/stack"]


def test_load_refuses_a_missing_leaf(tmp_path):
    jstate = _state("adamw")
    jstore.save_checkpoint(str(tmp_path), 1, jstate.params)
    like = to_torch(jstate.params)
    like["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        store.load_checkpoint(str(tmp_path), 1, like)
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "none"), None, like)
