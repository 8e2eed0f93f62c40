"""Equivalence battery for the port's training on a mesh (ROADMAP item
11c-i).

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_train_mesh.py`` runs this file in a subprocess with
its own timeout and reads its verdicts.  A subprocess keeps the rank
processes (``repro_torch/sharding/group.py``: spawned, gloo on the CPU)
away from the pytest worker, and lets JAX run on 4 forced host devices.

The oracle of every case is JAX's ``make_train_step`` under
``jax.set_mesh`` of an ``Auto``-typed mesh, with the state laid out by
``train_state_specs`` and the production flags (``batch_axes``,
``batch_divisor``, ``model_size``, and ``moe_impl="ep"`` for the MoE
model); never the JAX launcher's host mesh (ROADMAP Hazard 2).  The
port runs the same flags through ``make_train_step(mesh=...)`` on gloo
CPU ranks, on the JAX weights (``params_from_jax``), from numpy-seeded
batches, one torch thread a rank.  Each case holds one step's loss,
aux, grad norm and every updated param leaf, and a 3-step loss curve,
by ``tests/test_torch_train.py``'s tolerances and its ``assert_leaves``
rule, read off the port's unsharded f64 step with the same flags (an
expert-parallel MoE layer there is ``moe.ep_plain``) where f32 rounding
parts the two packages further than 1e-4; a scalar or a curve of the
mesh may sit as far from it as twice the port's own unsharded f32 step
does (``held``).  The attention arm each case
takes is asserted (``chunked_attention.ARMS``), the MoE cases' dropped
pairs are held to ``ep_plain``'s, and the mesh's state shapes and its
checkpoint are checked on one case.  The architectures and the
optimizer a training mesh refused before the recurrent mixers, MLA and
Adafactor were ported build and take one step (``builds/<arch>``).

Prints one ``BATTERY {json}`` line: {case: {ok, detail}}.  By hand:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_train_mesh_battery.py
[case ...]``.
"""
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")

import numpy as np  # noqa: E402

# the rank processes are spawned and import this file again as their
# main module: JAX, torch and the packages are imported in main()
jax = torch = None
T = {}

SCHEDULE = dict(peak_lr=1e-3, warmup=2, total=10)
STEPS = 3
RESULTS = {}

#: (case, arch, mesh shape, batch [B, S], config changes, expected arm)
CASES = [
    ("minicpm/1x2", "minicpm_2b", (1, 2), (4, 64), {}, "heads"),
    ("minicpm/2x1", "minicpm_2b", (2, 1), (4, 64), {}, "whole"),
    ("minicpm/2x2", "minicpm_2b", (2, 2), (4, 64), {}, "heads"),
    ("minicpm/1x4", "minicpm_2b", (1, 4), (4, 64), {}, "seq"),
    ("minicpm/pod2x1x2", "minicpm_2b", (2, 1, 2), (4, 64), {}, "heads"),
    ("qwen3/2x2", "qwen3_32b", (2, 2), (4, 64), {}, "heads"),
    ("qwen3/1x4", "qwen3_32b", (1, 4), (4, 64), {}, "seq"),
    ("deepseek7b_window/2x2", "deepseek_7b", (2, 2), (4, 64),
     {"sliding_window": 16}, "heads"),
    ("deepseek7b_window/1x4", "deepseek_7b", (1, 4), (4, 64),
     {"sliding_window": 16}, "seq"),
    ("granite_ep/2x2", "granite_moe_3b_a800m", (2, 2), (4, 64), {},
     "heads"),
    ("granite_ep_drops/2x2", "granite_moe_3b_a800m", (2, 2), (4, 64),
     {"capacity_factor": 0.5}, "heads"),
    ("granite_ep_decode/2x2", "granite_moe_3b_a800m", (2, 2), (2, 16), {},
     "heads"),
    ("granite_ep_b3/2x2", "granite_moe_3b_a800m", (2, 2), (3, 64), {},
     "heads"),
    ("phi3v/2x2", "phi_3_vision_4_2b", (2, 2), (4, 64), {}, "heads"),
    ("seamless/1x4", "seamless_m4t_large_v2", (1, 4), (4, 64), {}, "seq"),
]
#: the cases whose state shapes and checkpoint are checked
STATE_CASES = {"minicpm/2x2"}


def _imports():
    global jax, torch
    import jax
    import torch
    torch.set_num_threads(1)
    from jax.sharding import AxisType
    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    from repro.models.transformer import RuntimeFlags as JaxFlags
    from repro.optim import make_schedule as jax_make_schedule
    from repro.runtime.steps import make_train_step as jax_train_step
    from repro.sharding.rules import train_state_specs as jax_state_specs
    from repro_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                        save_from_mesh)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import TrainingMesh
    from repro_torch.models import chunked_attention, moe, xlstm
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten, params_from_jax, unflatten
    from repro_torch.models.transformer import TRAIN_FLAGS
    from repro_torch.optim import make_schedule
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.sharding.group import WorkerPool
    from repro_torch.sharding.rules import (local_train_state_shapes,
                                            state_leaves)
    import test_torch_train as ttt
    T.update(locals())


def axes_of(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def flags_kw(arch, shape):
    """The production flags of a mesh (the JAX launcher's multi-pod
    branch, at this mesh's sizes)."""
    batch = axes_of(shape)[:-1]
    kw = dict(batch_axes=batch, batch_divisor=int(np.prod(shape[:-1])),
              model_size=shape[-1])
    if arch == "granite_moe_3b_a800m":
        kw["moe_impl"] = "ep"
    return kw


def batch_np(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.frontend:
        P = cfg.num_prefix_embeddings
        b["prefix_embeds"] = (rng.randn(B, P, cfg.d_model) * 0.02
                              ).astype(np.float32)
        b["labels"] = np.concatenate([np.zeros((B, P), np.int32),
                                      b["labels"]], axis=1)
    return b


def jax_run(jcfg, jparams, shape, kw, batches):
    """JAX's steps under an Auto mesh: [(metrics, params after the step)]."""
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes_of(shape),
                         axis_types=(T["AxisType"].Auto,) * len(shape),
                         devices=jax.devices()[:n])
    model = T["JaxModel"](jcfg)
    step, init = T["jax_train_step"](
        model, schedule=T["jax_make_schedule"](jcfg.lr_schedule, **SCHEDULE),
        flags=T["JaxFlags"](**kw))
    out = []
    with jax.set_mesh(mesh):
        state = jax.device_put(init(jparams), T["jax_state_specs"](
            model.template, mesh, jcfg.optimizer))
        fn = jax.jit(step)
        for b in batches:
            state, m = fn(state, b)
            out.append(({k: float(v) for k, v in m.items()},
                        T["flatten"](jax.tree.map(np.asarray,
                                                  state.params))))
    return out


def jax_plain_loss(jcfg, jparams, b):
    """JAX's unsharded gather step's loss on ``b`` (no mesh)."""
    model = T["JaxModel"](jcfg)
    step, init = T["jax_train_step"](
        model, schedule=T["jax_make_schedule"](jcfg.lr_schedule, **SCHEDULE))
    _, m = jax.jit(step)(init(jparams), b)
    return float(m["loss"])


def tbatch(b, dtype):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v).to(dtype) for k, v in b.items()}


def port_plain(cfg, np_params, kw, batches, dtype="float64"):
    """The port's unsharded steps with the same flags, in ``dtype``:
    [(metrics, params, grads of the first step)]."""
    c = dataclasses.replace(cfg, dtype=dtype)
    npt = np.float64 if dtype == "float64" else np.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    p = jax.tree.map(lambda a: a.astype(npt), np_params)
    model = T["Model"](c, device="cpu", params=T["params_from_jax"](p, c))
    flags = dataclasses.replace(T["TRAIN_FLAGS"], **kw)
    step, init = T["make_train_step"](model, schedule=T["make_schedule"](
        c.lr_schedule, **SCHEDULE), flags=flags)
    state = init(model.params)
    leaves = T["flatten"](state.params)
    grads, moments = {}, None

    def keep(k):
        def hook(q):
            grads.setdefault(k, q.grad.detach().double().numpy())
        return hook
    hooks = [q.requires_grad_(True).register_post_accumulate_grad_hook(
        keep(k)) for k, q in leaves.items()]
    out = []
    for b in batches:
        state, m = step(state, tbatch(b, tdt))
        for h in hooks:
            h.remove()
        hooks = []
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().double().numpy() for k, v in
                     T["flatten"](state.params).items()}))
        if moments is None:
            moments = {k: v.detach().double().numpy() for k, v in
                       T["state_leaves"](state.opt).items()}
    return out, grads, moments


def routed_drops(cfg, np_params, kw, b):
    """Dropped pairs a MoE layer of the port's unsharded forward on ``b``,
    for ``ep_plain`` (the flags' divisor) and for the gather dispatch."""
    moe = T["moe"]
    model = T["Model"](cfg, device="cpu", params=T["params_from_jax"](
        np_params, cfg))
    calls = []
    route = moe.route

    def rec(*a, **k):
        out = route(*a, **k)
        calls.append(out[1])
        return out
    moe.route = rec
    try:
        with torch.no_grad():
            model.forward(torch.as_tensor(b["tokens"]).long(),
                          flags=dataclasses.replace(T["TRAIN_FLAGS"], **kw))
    finally:
        moe.route = route
    B, S = b["tokens"].shape
    div = kw["batch_divisor"]
    return ([moe.ep_dropped(cfg, idx, B, S, div) for idx in calls],
            [moe.ep_dropped(cfg, idx, B, S, 1) for idx in calls])


def verdict(name, fn):
    t0 = time.perf_counter()
    try:
        detail = fn() or {}
        RESULTS[name] = {"ok": True, "detail": detail}
    except Exception as e:              # noqa: BLE001 - reported
        RESULTS[name] = {"ok": False, "detail": f"{e!r}\n"
                         f"{traceback.format_exc()[-3000:]}"}
    RESULTS[name]["seconds"] = time.perf_counter() - t0
    print(("ok  " if RESULTS[name]["ok"] else "FAIL") + f" {name} "
          f"{RESULTS[name]['seconds']:.1f}s", flush=True)


def scaled(params, scale):
    """``params`` (a JAX tree) with each leaf named in ``scale`` (by its
    last key) multiplied by its factor."""
    def leaf(path, a):
        return a * scale.get(path[-1].key, 1.0)
    return jax.tree_util.tree_map_with_path(leaf, params)


def run_case(case, pool):
    """A case ``(name, arch, mesh shape, (B, S), config changes, arm[,
    scale])``; ``scale``: leaves multiplied after the seed's draw
    (:func:`scaled`)."""
    name, arch, shape, (B, S), change, arm, *scale = case
    ttt = T["ttt"]
    jcfg = dataclasses.replace(T["jax_get_config"](arch).reduced(), **change)
    cfg = dataclasses.replace(T["get_config"](arch).reduced(), **change)
    jparams = scaled(T["JaxModel"](jcfg).init(jax.random.PRNGKey(0)),
                     scale[0] if scale else {})
    np_params = jax.tree.map(np.asarray, jparams)
    kw = flags_kw(arch, shape)
    batches = [batch_np(cfg, B, S, seed) for seed in range(STEPS)]
    want = jax_run(jcfg, jparams, shape, kw, batches)

    mesh = T["TrainingMesh"](("cpu",) * int(np.prod(shape)), axes_of(shape),
                             shape)
    model = T["Model"](cfg, device="cpu",
                       params=T["params_from_jax"](np_params, cfg))
    step, init = T["make_train_step"](
        model, schedule=T["make_schedule"](cfg.lr_schedule, **SCHEDULE),
        flags=dataclasses.replace(T["TRAIN_FLAGS"], **kw), mesh=mesh,
        pool=pool)
    trainer = step.trainer
    detail = {}
    try:
        state = init(model.params)
        if name in STATE_CASES:
            detail.update(check_state(cfg, mesh, trainer, state, model))
            state = init(model.params)      # the case's initial state
        moe_case = arch == "granite_moe_3b_a800m"
        trainer.record_drops(moe_case)
        T["chunked_attention"].ARMS.clear()
        T["xlstm"].ARMS.clear()
        got = []
        for i, b in enumerate(batches):
            state, m = step(state, tbatch(b, torch.float32))
            got.append({k: float(v) for k, v in m.items()})
            if i == 0:
                whole = trainer.gather_state(state)
                first = T["flatten"](whole.params)
                moments = {k: v.double().numpy() for k, v in
                           T["state_leaves"](whole.opt).items()}
                reports = trainer.report()
                trainer.record_drops(False)
        # the attention arms, and the mLSTM's as "mlstm_<arm>"
        arms = dict(T["chunked_attention"].ARMS)
        arms.update({f"mlstm_{k}": v for k, v in T["xlstm"].ARMS.items()})
    finally:
        trainer.close()
    assert all(r["grads_finite"] for r in reports), "a rank's grads"
    assert set(arms) == ({arm} if isinstance(arm, str) else set(arm)), \
        (arms, arm)
    detail["arms"] = arms
    if moe_case:
        mesh_drops = [sum(r["drops"][k] for r in reports
                          if r["coords"]["model"] == 0)
                      for k in sorted(reports[0]["drops"])]
        plain, gather = routed_drops(cfg, np_params, kw, batches[0])
        detail["drops"] = {"mesh": mesh_drops, "ep_plain": plain,
                           "gather": gather}
        assert mesh_drops == plain, detail["drops"]
        if name.startswith("granite_ep_drops"):
            # the per-shard capacity shows: the gather would drop others,
            # and JAX's own unsharded gather step is another function
            assert plain != gather, detail["drops"]
            jg = jax_plain_loss(jcfg, jparams, batches[0])
            detail["jax_gather_loss"] = jg
            assert abs(jg - want[0][0]["loss"]) > ttt.TOL * jg, detail

    # one step: the metrics and every updated leaf
    (jm, jp) = want[0]
    xs, xg, xv = port_plain(cfg, np_params, kw, batches, "float64")
    ps, _, pv = port_plain(cfg, np_params, kw, batches, "float32")
    xm, xp = xs[0]
    tm = got[0]
    for k in ("loss", "aux", "grad_norm", "mtp_loss"):
        if k in jm:
            detail[k] = held(k, tm[k], jm[k], xm[k], ps[0][0][k])
    if cfg.optimizer == "adafactor":
        # the factored state after the step: the unsharded f32 step's
        detail["moments"] = moments_held(moments, pv, xv)
    assert tm["lr"] == jm["lr"], (tm["lr"], jm["lr"])
    keep = {k: np.abs(g) > 1e-3 * np.abs(g).max() for k, g in xg.items()}
    tp = {k: v.double().numpy() for k, v in first.items()}
    detail["params"] = leaves_held(tp, jp, xp, ps[0][1], keep)
    # the 3-step curve
    wl = np.array([m["loss"] for m, _ in want])
    gl = np.array([m["loss"] for m in got])
    direct = float(np.abs(gl - wl).max() / np.abs(wl).min())
    detail.update(losses=list(gl), jax_losses=list(wl), curve_rel=direct)
    if direct > 1e-3:
        xl = np.array([m["loss"] for m, _ in xs])
        pl = np.array([m["loss"] for m, _ in ps])
        jx = float((np.abs(wl - xl) / xl).max())
        tx = float((np.abs(gl - xl) / xl).max())
        px = float((np.abs(pl - xl) / xl).max())
        detail.update(curve_jax_f64=jx, curve_mesh_f64=tx,
                      curve_plain_f64=px)
        assert jx <= ttt.ANCHOR["curve"], jx
        assert tx <= ttt.CURVE_RATIO * max(jx, px), (tx, jx, px)
    return detail


def moments_held(got, plain, x):
    """Every optimizer moment of the mesh after one step (``got``:
    Adafactor's v, its factors as ``.0`` and ``.1``) within
    1e-4 of the unsharded f32 step's (``plain``) of the leaf's largest
    magnitude; or else, by the norm of the difference over the f64
    step's (``x``), no further from it than twice the unsharded f32 step
    or than 1e-4.  Returns (leaves held directly, leaves)."""
    ttt = T["ttt"]
    assert sorted(got) == sorted(plain), (sorted(got), sorted(plain))
    bad, direct = [], 0
    for k, p in plain.items():
        t, xk = got[k], x[k]
        if np.abs(t - p).max() <= ttt.TOL * max(np.abs(p).max(), 1e-30):
            direct += 1
            continue
        n = max(np.linalg.norm(xk), 1e-30)
        tx, px = np.linalg.norm(t - xk) / n, np.linalg.norm(p - xk) / n
        if tx > max(2 * px, ttt.TOL):
            bad.append((k, tx, px))
    assert not bad, ("moments", bad)
    return {"direct": direct, "leaves": len(plain)}


def leaves_held(got, want, x, plain, keep):
    """Every updated leaf of the mesh (``got``) within 1e-4 of JAX's
    (``want``) of the leaf's largest magnitude, where the f64 step's
    gradient exceeds 1e-3 of the leaf's largest (Adam's first step is
    about sign(g)); or else, by the norm of the difference over the f64
    leaf's (``x``), no further from it than twice the farther of JAX and
    the port's unsharded f32 step (``plain``), or than 1e-4.  (No anchor
    on JAX's distance here: on reduced seamless_m4t_large_v2 the first
    Adam step flips the sign of embedding elements whose gradient sits
    within the f32 rounding of 0, and JAX, the unsharded port and the
    mesh all sit 0.059 from f64 by the norm; the loss, aux and grad norm
    anchors hold the f64 step to JAX's model.)  Returns (leaves held
    directly, the largest mesh/floor ratio and its leaf)."""
    ttt = T["ttt"]
    bad, direct, worst = [], 0, (0.0, None)
    for k, j in want.items():
        m = keep[k]
        if not m.any():
            continue
        j, t = np.asarray(j, np.float64)[m], np.asarray(got[k])[m]
        xk, pk = np.asarray(x[k])[m], np.asarray(plain[k])[m]
        if np.abs(t - j).max() <= ttt.TOL * max(np.abs(j).max(), 1e-30):
            direct += 1
            continue
        n = max(np.linalg.norm(xk), 1e-30)
        jx, tx, px = (np.linalg.norm(a - xk) / n for a in (j, t, pk))
        floor = max(2 * max(jx, px), ttt.TOL)
        worst = max(worst, (tx / floor, k))
        if tx > floor:
            bad.append((k, jx, tx, px))
    assert not bad, ("params", bad)
    return {"direct": direct, "worst_ratio": worst[0], "worst_leaf": worst[1]}


def held(what, t, j, x, p):
    """The mesh's reading ``t`` within 1e-4 of JAX's ``j``; or else (the f32
    floor) JAX within its anchor of the port's f64 reading ``x``, and the
    mesh no further from ``x`` than twice the farther of JAX and the
    port's unsharded f32 step ``p`` (the function the mesh computes, whose
    f32 floor ``tests/test_torch_train.py`` holds against JAX's: on these
    batches its first layer's attention gradients sit up to 3x JAX's
    distance from f64, reduced phi_3_vision_4_2b's and
    seamless_m4t_large_v2's saturated softmaxes).  Returns the
    readings."""
    ttt = T["ttt"]
    out = {"mesh": t, "jax": j, "f64": x, "plain_f32": p}
    if abs(t - j) <= ttt.TOL * max(abs(j), 1e-30) or j == t == 0:
        return out
    s = max(abs(x), 1e-30)
    jx, tx, px = abs(j - x) / s, abs(t - x) / s, abs(p - x) / s
    anchor = ttt.ANCHOR["grad_norm" if what == "grad_norm" else "aux"]
    assert jx <= anchor, (what, out)
    assert tx <= 2 * max(jx, px), (what, out)
    return out


def check_state(cfg, mesh, trainer, state, model):
    """(d): each rank's TrainState shapes are ``train_state_specs``'s
    local shapes (Adafactor's factors by their own specs), the mesh
    checkpoint of the initial state is byte for byte the unsharded save
    of the same state, and a whole state one step on (its moments
    non-zero), cut into the ranks' slices (``init_state`` of a
    ``TrainState``), gathers back bitwise."""
    want = T["local_train_state_shapes"](model.template, mesh,
                                         cfg.optimizer)
    for r in trainer.report():
        assert r["shapes"] == want, (r["rank"], r["shapes"], want)
    step, init = T["make_train_step"](model, schedule=lambda s: 1e-3)
    whole = init(T["unflatten"]({k: v.detach().clone() for k, v in
                                 T["flatten"](model.params).items()}))
    with tempfile.TemporaryDirectory() as d:
        a = T["save_from_mesh"](os.path.join(d, "mesh"), 0, trainer, state)
        b = T["save_checkpoint"](os.path.join(d, "plain"), 0, whole)
        files = sorted(os.listdir(a))
        assert files == sorted(os.listdir(b))
        for f in files:
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f
        back = T["load_checkpoint"](os.path.join(d, "mesh"), 0, whole)
        for k, v in T["flatten"](back.params).items():
            assert torch.equal(v, T["flatten"](whole.params)[k]), k
    # a whole TrainState (one step on, moments non-zero) cut into every
    # rank's slices and gathered back is itself, bitwise
    b = {k: torch.as_tensor(v).long() for k, v in
         batch_np(cfg, 4, 16, 7).items()}
    whole, _ = step(whole, b)
    resumed = trainer.init_state(whole)
    again = trainer.gather_state(resumed)
    assert int(again.opt.step) == int(whole.opt.step) == 1
    for got, want_ in ((T["flatten"](again.params),
                        T["flatten"](whole.params)),
                       (T["state_leaves"](again.opt),
                        T["state_leaves"](whole.opt))):
        assert sorted(got) == sorted(want_)
        for k, v in got.items():
            assert torch.equal(v, want_[k].detach()), k
    return {"state_leaves": len(want), "checkpoint_files": len(files),
            "resumed_bitwise": True}


#: the architectures and optimizers a (1, 2) mesh once refused: each
#: builds and takes one step
BUILDS = {"xlstm_1_3b": None, "jamba_1_5_large_398b": None,
          "deepseek_v3_671b": None, "minicpm_2b": "adafactor"}


def check_build(arch, pool):
    """``make_train_step(mesh=)`` of reduced ``arch``'s config (with its
    own optimizer, or ``BUILDS``') on a (1, 2) mesh builds, the ranks
    draw their slices from the seed, and one step on 2 x 16 tokens is
    finite; each leaf's ``update_sums`` (the change's sum of squares and
    its dot product with the draw, over the ranks' distinct slices) is
    the unsharded step's on ``Model(cfg, seed=0)`` within 1e-2 (the sum
    of the squares relative, the dot product of their scale), but for a
    leaf whose gradient is f32 rounding noise (below 1e-6 of the tree's
    largest: the mLSTM's input-gate bias, whose AdamW step is the
    noise's sign)."""
    cfg = T["get_config"](arch).reduced()
    shape = (1, 2)
    mesh = T["TrainingMesh"](("cpu",) * 2, axes_of(shape), shape)
    flags = dataclasses.replace(T["TRAIN_FLAGS"], **flags_kw(arch, shape))
    batch = tbatch(batch_np(cfg, 2, 16, 0), torch.float32)
    step, init = T["make_train_step"](
        cfg, schedule=lambda s: 1e-3, optimizer=BUILDS[arch], mesh=mesh,
        flags=flags, pool=pool)
    try:
        _, m = step(init(seed=0), batch)
        sums = step.trainer.update_sums(0)
    finally:
        step.trainer.close()
    m = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in m.values()), m
    model = T["Model"](cfg, device="cpu", seed=0)
    w0 = {k: v.detach().double().clone()
          for k, v in T["flatten"](model.params).items()}
    pstep, pinit = T["make_train_step"](model, schedule=lambda s: 1e-3,
                                        optimizer=BUILDS[arch], flags=flags)
    top = {}

    def keep(k):
        def hook(q):
            top[k] = float(q.grad.abs().max())
        return hook
    hooks = [q.requires_grad_(True).register_post_accumulate_grad_hook(
        keep(k)) for k, q in T["flatten"](model.params).items()]
    state, _ = pstep(pinit(model.params), batch)
    for h in hooks:
        h.remove()
    noise = 1e-6 * max(top.values())
    worst, where = 0.0, None
    for k, p in T["flatten"](state.params).items():
        if top.get(k, 0.0) <= noise:
            continue
        d = p.detach().double() - w0[k]
        sq, dot = float((d * d).sum()), float((d * w0[k]).sum())
        scale = math.sqrt(sq * float((w0[k] ** 2).sum()))
        rel = max(abs(sums[k][0] - sq) / max(sq, 1e-30),
                  abs(sums[k][1] - dot) / max(scale, 1e-30))
        if rel > worst:
            worst, where = rel, (k, sums[k], [sq, dot])
    assert worst <= 1e-2, (arch, worst, where)
    m["update_sums_rel"] = worst
    return m


def main(names):
    _imports()
    pools = {}
    t0 = time.perf_counter()
    for arch in BUILDS:
        if not names or f"builds/{arch}" in names:
            pool = pools.setdefault(2, T["WorkerPool"]())
            verdict(f"builds/{arch}", lambda: check_build(arch, pool))
    for case in CASES:
        if names and case[0] not in names:
            continue
        n = int(np.prod(case[2]))
        pool = pools.setdefault(n, T["WorkerPool"]())
        verdict(case[0], lambda: run_case(case, pool))
    for pool in pools.values():
        pool.close()
    print(f"battery {time.perf_counter() - t0:.1f}s", flush=True)
    print("BATTERY " + json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
