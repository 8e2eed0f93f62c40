"""Equivalence battery for the port's dry run (``repro_torch.launch.dryrun``)
against the JAX package's (ROADMAP item 11d).

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_dryrun.py`` runs this file in a subprocess with its own
timeout and reads its verdicts.  A subprocess lets JAX run on 4 forced
host devices, set before JAX loads (``repro.launch.dryrun`` asks for 512
when it is imported first; here JAX is initialised before it).

The oracle of every case is JAX's own ``dryrun.build_lowering``, lowered
and compiled under ``jax.set_mesh`` of an ``Auto``-typed mesh (ROADMAP
Hazard 2's workaround), with ``dryrun.get_config`` and
``dryrun.INPUT_SHAPES`` replaced in this process only: the reduced
configs, and train, prefill and decode at 4 x 64 plus a 1 x 256 decode
named ``long_500k`` (so that ``adjusted_config``'s window branch runs).
The port runs its own ``build_lowering`` with the same replacements, on a
``TrainingMesh`` of ``meta`` devices, under the op counter.  Each case
holds:

* the argument bytes per device, exactly, but for the leaves named in
  ``named_args`` (JAX's decode takes a scalar position where the port's
  step takes one a row, and JAX drops the arguments a step does not read:
  jit's ``keep_unused=False``);
* on ``(1, 1)`` the counted FLOPs within 2% of ``hlo_cost``'s, after the
  attention products are taken out of both: the port's attention runs in
  fixed 128-key blocks (its chunked attention and K3's plain version),
  JAX's chunked attention in chunks of ``min(1024, T)``, so the port's
  are counted by scope (``_scope_attention``; a train step's backward
  products, which autograd runs outside it, by their sizes) and JAX's
  analytically from the shapes (``jax_attention_flops``); and, on the
  decode shapes of the
  recurrent stacks, the port's 32-row blocks of the mixers' products
  (``layers.ROW_BLOCK``, ROADMAP Hazard 4), counted as the same step's
  count less its count at 1-row blocks;
* on ``(2, 2)`` and ``(2, 1, 2)`` the FLOPs by the tolerance table
  ``MESH_TOL`` (each entry above 2% with its cause);
* and prints the HBM-byte proxies and the collectives by kind side by
  side: they differ by design (``launch/op_cost.py``).

Prints one ``BATTERY {json}`` line: {case: {ok, detail}}.  By hand:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_dryrun_battery.py
[mesh ...]``: the default ``PLAN``, or every case on the meshes named
(``1x1 2x2 2x1x2``).
"""
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")

ARCHS = ["minicpm_2b", "qwen3_32b", "stablelm_12b", "deepseek_7b",
         "granite_moe_3b_a800m", "xlstm_1_3b", "jamba_1_5_large_398b",
         "deepseek_v3_671b", "phi_3_vision_4_2b", "seamless_m4t_large_v2"]
#: (kind, seq_len, global_batch) of the small shapes, under the
#: production names
SHAPES = {"train_4k": ("train", 64, 4), "prefill_32k": ("prefill", 64, 4),
          "decode_32k": ("decode", 64, 4), "long_500k": ("decode", 256, 1)}
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "2x1x2": (2, 1, 2)}

#: the cases run by default, within the test's 150 s budget: every
#: architecture and shape on (1, 1); on (2, 2) every architecture's
#: serving shapes and two architectures' train step; on (2, 1, 2) every
#: architecture's decode (cut: the other train steps on (2, 2) and the
#: train, prefill and long_500k shapes on (2, 1, 2))
PLAN = ([("1x1", a, s) for a in ARCHS for s in SHAPES]
        + [("2x2", a, s) for a in ARCHS
           for s in ("prefill_32k", "decode_32k", "long_500k")]
        + [("2x2", a, "train_4k") for a in ("minicpm_2b",
                                            "deepseek_v3_671b")]
        + [("2x1x2", a, "decode_32k") for a in ARCHS])

#: with one row, which the batch axes do not divide, GSPMD keeps every
#: embed->data weight cut and contracts each device's slice of d_model,
#: summed over data; the port's rank gathers the weights whole and runs
#: each product whole (the cost it pays for a gather)
ONE_ROW = "1 row on (2, 2): GSPMD contracts the data-cut d slices"
#: JAX's ``_moe_ep_decode`` contracts each device's d slice of the
#: experts (summed over data); the port's rank gathers them whole
EP_DECODE = "MoE decode: JAX's _moe_ep_decode contracts the d slices"
#: MLA's latent down-projections (wq_a, wkv_a) are whole on every rank
#: of the port's model line (their widths are not cut); GSPMD cuts their
#: contraction over model
MLA_LATENT = "MLA's latent down-projections whole on every model rank"

#: the FLOPs' tolerance on the meshes of more than one device, by
#: architecture and shape: (low, high) bounds of the port's count over
#: JAX's, both less the named products, and the cause; 0.98-1.02 where
#: no entry is given
MESH_TOL = {
    **{a: {"long_500k": (0.98, 1.76, ONE_ROW)}
       for a in ("minicpm_2b", "qwen3_32b", "stablelm_12b", "deepseek_7b",
                 "phi_3_vision_4_2b")},
    "seamless_m4t_large_v2": {"long_500k": (0.98, 1.79, ONE_ROW)},
    "xlstm_1_3b": {"long_500k": (0.98, 1.87, ONE_ROW)},
    "granite_moe_3b_a800m": {"decode_32k": (0.98, 1.92, EP_DECODE),
                             "long_500k": (0.98, 2.0, EP_DECODE)},
    "jamba_1_5_large_398b": {"decode_32k": (0.98, 1.65, EP_DECODE),
                             "long_500k": (0.98, 1.93, EP_DECODE)},
    "deepseek_v3_671b": {
        "train_4k": (0.98, 1.04, MLA_LATENT + "; and two 256x512 products "
                     "more in the port's step, not traced further"),
        "prefill_32k": (0.98, 1.03, MLA_LATENT),
        "decode_32k": (0.98, 1.75, EP_DECODE),
        "long_500k": (0.98, 2.0, EP_DECODE)},
}

RESULTS = {}
T = {}


def _imports():
    import jax
    jax.devices()                       # 4 host devices, before dryrun
    import torch
    torch.set_num_threads(1)
    from jax.sharding import AxisType
    import repro.launch.dryrun as jd
    from repro.configs import get_config as jax_get_config
    from repro.launch.analysis import memory_stats as jax_memory_stats
    from repro.launch.hlo_cost import hlo_cost
    from repro.models.config import InputShape as JaxShape
    import repro_torch.launch.dryrun as pd
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import TrainingMesh
    from repro_torch.models import (attention, chunked_attention, layers,
                                    mla, transformer)
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import flatten
    T.update(locals())
    jd.get_config = lambda a: jax_get_config(a).reduced()
    pd.get_config = lambda a: get_config(a).reduced()
    jd.INPUT_SHAPES = {k: JaxShape(k, s, b, kind)
                       for k, (kind, s, b) in SHAPES.items()}
    pd.INPUT_SHAPES = {k: InputShape(k, s, b, kind)
                       for k, (kind, s, b) in SHAPES.items()}
    _scope_attention()


# ---------------------------------------------------------------------------
# the port's attention products, by scope
# ---------------------------------------------------------------------------

SCOPE = [0]
#: inside the MTP block (``transformer.mesh_block`` at ``mtp.block``)
MTP = [0]


def _scope_attention():
    """Wrap the port's full-sequence attention functions (the chunked
    attention and K3's plain version, wherever a module holds them) so
    that the counter can tell their products apart."""
    def wrap(fn):
        def scoped(*a, **k):
            SCOPE[0] += 1
            try:
                return fn(*a, **k)
            finally:
                SCOPE[0] -= 1
        return scoped
    for mod in (T["ref"], T["attention"], T["chunked_attention"], T["mla"],
                T["transformer"]):
        for name in ("chunked_attention", "flash_attention_ref"):
            if hasattr(mod, name):
                setattr(mod, name, wrap(getattr(mod, name)))
    tf = T["transformer"]
    block = tf.mesh_block

    def mtp_scoped(*a, **k):
        mtp = k.get("path") == "mtp.block"
        MTP[0] += mtp
        try:
            return block(*a, **k)
        finally:
            MTP[0] -= mtp
    tf.mesh_block = mtp_scoped


def _counter():
    op_cost = T["op_cost"]

    class Scoped(op_cost.OpCounter):
        """The op counter, with the FLOPs under the attention scope apart."""

        def __init__(self):
            super().__init__()
            self.attention = 0.0
            self.mtp = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if SCOPE[0]:
                self.attention += self.flops - before
            elif MTP[0]:
                self.mtp += self.flops - before
            return out
    return Scoped()


def jax_attention_flops(cfg, kind: str, S: int, B: int) -> float:
    """JAX's products of the attention calls that the port runs through
    the scoped functions, from the shapes: 2·B·H·S_q·T·d for QK^T (d the
    query-key head dim) and for PV (d the value head dim), full S_q x T
    (JAX's chunks of min(1024, T) hold T whole here).  Train runs each
    QK^T 5 times (forward, the group's recompute, the inner
    ``jax.checkpoint``'s recompute, and its two backward products) and
    each PV 4 times; prefill and decode once."""
    H = cfg.num_heads
    if cfg.use_mla:
        dq, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        dq = dv = cfg.head_dim
    calls = []                          # (S_q, T) of each call
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    if kind == "train":
        calls += [(S, S)] * n_attn
        if cfg.mtp_depth:
            calls += [(S, S)] * cfg.mtp_depth
        if cfg.is_encoder_decoder:
            calls += [(S, S)] * cfg.num_encoder_layers + [(S, S)] * n_attn
    elif kind == "prefill":
        if cfg.is_encoder_decoder:
            calls += [(S, S)] * cfg.num_encoder_layers + [(1, 1)] * n_attn \
                + [(1, S)] * n_attn
        else:
            calls += [(S, S)] * n_attn
    elif cfg.is_encoder_decoder:
        calls += [(1, S)] * n_attn      # decode: the cross attention
    qk, pv = (5, 4) if kind == "train" else (1, 1)
    return sum(2.0 * B * H * s * t * (qk * dq + pv * dv) for s, t in calls)


# ---------------------------------------------------------------------------
# one case
# ---------------------------------------------------------------------------

def named_args(arch: str, shape: str, step, mesh) -> dict:
    """The argument bytes the port holds and JAX's compiled step does not
    (or the reverse), by name: the decode positions (a [B] vector in the
    port, a scalar in JAX that a recurrent-only stack does not read and
    jit drops), and the weights a serving step does not read, which jit
    drops too (the MTP head; an encoder-decoder's encoder and its cross
    attention's key and value projections at decode)."""
    cfg = step.cfg
    kind = SHAPES[shape][0]
    out = {}
    if kind == "decode":
        reads_pos = "attn" in cfg.layer_kinds()
        out["positions"] = step.arguments["positions"] - (4 if reads_pos
                                                          else 0)
    if kind != "train":
        import math
        from repro_torch.sharding.rules import local_shape, param_specs
        template = T["pd"].Model(cfg, device="meta").template
        flat = T["flatten"](template)
        specs = T["flatten"](param_specs(template, mesh))
        unread = T["pd"].unread_weights(cfg, kind, flat)
        if unread:
            # the reduced configs are f32
            out["unread weights"] = sum(
                math.prod(local_shape(flat[p].shape, specs[p], mesh)) * 4
                for p in unread)
    return out


def run_case(mesh_name: str, arch: str, shape: str) -> dict:
    import jax
    jd, pd = T["jd"], T["pd"]
    sizes = MESHES[mesh_name]
    axes = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    n = 1
    for s in sizes:
        n *= s
    jmesh = jax.make_mesh(sizes, axes,
                          axis_types=(T["AxisType"].Auto,) * len(sizes),
                          devices=jax.devices()[:n])
    t0 = time.perf_counter()
    with jax.set_mesh(jmesh):
        fn, args = jd.build_lowering(arch, shape, jmesh)
        compiled = fn.lower(*args).compile()
    jax_s = time.perf_counter() - t0
    jcost = T["hlo_cost"](compiled.as_text())
    jargs = T["jax_memory_stats"](compiled)["argument_size_in_bytes"]

    t0 = time.perf_counter()
    pmesh = T["TrainingMesh"](("meta",) * n, axes, sizes)
    step = pd.build_lowering(arch, shape, pmesh)
    counter = _counter()
    with counter:
        step.record_gathers()
        step.run()
    port_s = time.perf_counter() - t0
    pargs = sum(step.arguments.values())
    named = named_args(arch, shape, step, pmesh)
    detail = {"jax_flops": jcost["flops"], "port_flops": counter.flops,
              "flops_ratio": counter.flops / jcost["flops"],
              "jax_args": jargs, "port_args": pargs, "named_args": named,
              "jax_hbm_bytes": jcost["bytes"], "port_hbm_bytes":
              counter.bytes, "jax_coll": {k: jcost[k] for k in
                                          T["op_cost"].COLLECTIVES
                                          if jcost[k]},
              "port_coll": {k: v for k, v in counter.coll.items() if v},
              "seconds": [round(jax_s, 2), round(port_s, 2)]}
    ok = pargs - sum(named.values()) == jargs
    kind, S, B = SHAPES[shape]
    # JAX's attention per device: the batch cut on the batch axes where
    # they divide it, the heads (or the queries) on the model axis
    batch = n // sizes[-1]
    share = (batch if B % batch == 0 else 1) * sizes[-1]
    jattn = jax_attention_flops(step.cfg, kind, S, B) / share
    # the 32-row blocks: the recurrent mixers' products, and every
    # product of fewer rows on a tensor-parallel rank (Hazard 4)
    pad = 0.0
    if kind != "train" and (n > 1 or set(step.cfg.layer_kinds())
                            != {"attn"}):
        pad = counter.flops - _flops_at_row_block(arch, shape, pmesh, 1)
    # in train the scope holds the forward and the group's recompute;
    # the backward's four products a call, which autograd runs outside
    # the scope, have their sizes (dP and dV those of PV, dQ and dK
    # those of QK^T)
    pattn = counter.attention * (2 if kind == "train" else 1)
    # the port checkpoints the MTP block (``mesh_mtp_logits``), JAX does
    # not: its recompute, half of the block's products outside the
    # attention in the scope (the forward and the recompute)
    mtp = counter.mtp / 2
    rest_p = counter.flops - pattn - pad - mtp
    rest_j = jcost["flops"] - jattn
    detail.update(port_attention=pattn, jax_attention=jattn,
                  row_block_padding=pad, mtp_recompute=mtp,
                  rest_ratio=rest_p / rest_j)
    lo, hi = (0.98, 1.02)
    if mesh_name != "1x1" and shape in MESH_TOL.get(arch, {}):
        lo, hi, cause = MESH_TOL[arch][shape]
        detail["tolerance_cause"] = cause
    ok = ok and lo <= rest_p / rest_j <= hi
    return {"ok": bool(ok), "detail": detail}


def _flops_at_row_block(arch, shape, pmesh, rows: int) -> float:
    layers = T["layers"]
    saved = layers.ROW_BLOCK
    layers.ROW_BLOCK = rows
    try:
        step = T["pd"].build_lowering(arch, shape, pmesh)
        with T["op_cost"].OpCounter() as c:
            step.run()
        return c.flops
    finally:
        layers.ROW_BLOCK = saved


def main(argv):
    _imports()
    plan = PLAN if not argv else [(m, a, s) for m in argv for a in ARCHS
                                  for s in SHAPES]
    t0 = time.perf_counter()
    for mesh_name, arch, shape in plan:
        key = f"{arch}/{shape}/{mesh_name}"
        try:
            RESULTS[key] = run_case(mesh_name, arch, shape)
        except Exception:          # noqa: BLE001 - a failed case
            RESULTS[key] = {"ok": False, "detail": traceback.format_exc()}
        r = RESULTS[key]
        d = r["detail"]
        line = d if isinstance(d, str) else \
            (f"flops {d['flops_ratio']:.4f} rest {d['rest_ratio']:.4f}"
             f" args {d['port_args']}/{d['jax_args']}"
             f" hbm {d['port_hbm_bytes']:.3e}/{d['jax_hbm_bytes']:.3e}"
             f" coll {d['port_coll']}/{d['jax_coll']} s {d['seconds']}")
        print(f"{'ok' if r['ok'] else 'FAIL'} {key}: {line}", flush=True)
    RESULTS["_seconds"] = {"ok": True,
                           "detail": round(time.perf_counter() - t0, 1)}
    print("BATTERY " + json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
