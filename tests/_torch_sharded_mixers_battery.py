"""Equivalence battery for the port's tensor-parallel serving of the MoE
FFN and the recurrent mixers, with the state and hybrid layouts.

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_sharded_mixers.py`` runs this file in a subprocess
with its own timeout and reads its verdicts, as
``tests/test_torch_sharded.py`` runs ``_torch_sharded_battery.py`` (a
file of its own, so that ``--dist loadfile`` runs the two side by side).

Every scenario serves a fixed greedy workload through the port's
``GraphServer`` on engines without a mesh (tp 0) and on meshes of 1, 2
and 4 CPU ranks, all holding the JAX engine's weights
(``params_from_jax``).  The streamed tokens of each run must equal the
JAX unsharded engine's per-request greedy ``generate`` on the same
weights and the port's tp 0 run; the first-step logits of every engine
must sit within 1e-4 of JAX's.  The configurations:

* ``state``: the JAX battery's ``STATE`` (reduced xlstm_1_3b, one mLSTM
  layer of 4 heads and one sLSTM layer of 2 heads, d_model 64), on the
  state layout;
* ``hybrid``: the JAX battery's ``HYBRID`` (reduced jamba: an attention
  layer with a dense FFN and a Mamba layer with a MoE FFN, d_model 64),
  on the hybrid layout at tp 1 and 2; its 2 kv heads do not divide 4
  ranks, so tp 4 serves ``hybrid4``, the same with 4 kv heads (named
  as ``QWEN4`` is), against the JAX engine on that config;
* ``moe``: reduced granite_moe_3b_a800m at d_model 64, 4 heads of 16
  over 4 kv heads, vocab 256 (4 experts, top 2), on the slot and paged
  layouts; every MoE call's dropped (token, expert) pairs, read on rank
  0, must equal the tp 0 run's call by call.

Besides decode: speculative verify windows through ``verify_window`` and
``state_rewind`` on the state and hybrid layouts (vocab 4, where
prompt-lookup drafting proposes windows), chunked extend, preemption
replay under block pressure, the ranks' caches after every server
closes, and ``cache_shards`` (tp for the hybrid layout, 1 for a stack
with no attention layer).

Prints one ``BATTERY {json}`` line: {scenario: {ok, detail}}.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

# the rank processes are spawned, and a spawned process imports this
# file again as its main module: JAX and the packages are imported in
# main() (``_imports``), not here, so that each rank starts light
jax = jnp = torch = moe = None
jax_get_config = JaxEngine = get_config = make_serving_mesh = None
params_from_jax = GraphServer = LLMEngine = None


def _imports():
    global jax, jnp, torch, moe, jax_get_config, JaxEngine, get_config
    global make_serving_mesh, params_from_jax, GraphServer, LLMEngine
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.serving import LLMEngine as JaxEngine
    import repro_torch.calculators  # noqa: F401 - registers the library
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import params_from_jax
    from repro_torch.serving import GraphServer, LLMEngine


MESH_SIZES = (1, 2, 4)
MAX_LEN = 64
LOGIT_TOL = 1e-4
RESULTS = {}

STATE_KW = dict(num_layers=2, d_model=64, vocab_size=256,
                block_pattern=("mlstm", "slstm"))
HYBRID_KW = dict(d_model=64, vocab_size=256)
MOE_KW = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
              vocab_size=256)


def _pair(name, **kw):
    return (dataclasses.replace(get_config(name).reduced(), **kw),
            dataclasses.replace(jax_get_config(name).reduced(), **kw))


def _configs():
    return {
        "state": _pair("xlstm_1_3b", **STATE_KW),
        "hybrid": _pair("jamba_1_5_large_398b", **HYBRID_KW),
        "hybrid4": _pair("jamba_1_5_large_398b", num_kv_heads=4,
                         **HYBRID_KW),
        "moe": _pair("granite_moe_3b_a800m", **MOE_KW),
        # tiny vocab: greedy decode settles into repetition loops, where
        # prompt-lookup drafting proposes windows to verify
        "state_spec": _pair("xlstm_1_3b", **dict(STATE_KW, vocab_size=4)),
        "hybrid_spec": _pair("jamba_1_5_large_398b", num_kv_heads=4,
                             **dict(HYBRID_KW, vocab_size=4)),
    }


#: the layout each configuration is served on, and the meshes it runs
LAYOUT = {"state": "state", "hybrid": "hybrid", "hybrid4": "hybrid",
          "state_spec": "state", "hybrid_spec": "hybrid"}
CONFIGS = {}
_JAX = {}
_PARAMS = {}
_ENGINES = {}
_GREEDY = {}


def jax_engine(name):
    if name not in _JAX:
        _JAX[name] = JaxEngine(CONFIGS[name][1], max_len=MAX_LEN, seed=0)
        _PARAMS[name] = params_from_jax(
            jax.tree.map(np.asarray, _JAX[name].params), CONFIGS[name][0])
    return _JAX[name]


def engine_for(name, tp):
    """One engine per (config, mesh size); tp 0 has no mesh."""
    key = (name, tp)
    if key not in _ENGINES:
        jax_engine(name)
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp) if tp else None
        _ENGINES[key] = LLMEngine(CONFIGS[name][0], _PARAMS[name],
                                  max_len=MAX_LEN, device="cpu", mesh=mesh)
    return _ENGINES[key]


def close_engines(name):
    for key in [k for k in _ENGINES if k[0] == name]:
        _ENGINES.pop(key).close()


def greedy(name, prompts, n):
    """The JAX unsharded engine's per-request greedy tokens."""
    out = []
    for p in prompts:
        key = (name, p.tobytes(), n)
        if key not in _GREEDY:
            _GREEDY[key] = [int(t) for t in
                            jax_engine(name).generate(p[None], n)[0]]
        out.append(_GREEDY[key])
    return out


def record(key, ok, detail=""):
    RESULTS[key] = {"ok": bool(ok), "detail": str(detail)}
    print(f"{'ok ' if ok else 'FAIL'} {key} {detail}", flush=True)


_HYGIENE = []


class Drops:
    """While installed, the dropped (token, expert) pairs of every MoE
    call rank 0 routes, in call order (its ``route`` returns the
    choices over every expert)."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __enter__(self):
        self._route = route = moe.route

        def recorded(params, cfg, xf, *rest):
            out = route(params, cfg, xf, *rest)
            self.calls.append(moe.count_dropped(
                out[1], moe.padded_experts(cfg),
                moe.capacity(cfg, xf.shape[0])))
            return out

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def serve(engine, prompts, drops=None, **srv_kw):
    kw = dict(num_slots=2, max_new_tokens=6)
    kw.update(srv_kw)
    rec = Drops(engine.cfg) if drops is not None else None
    if rec is not None:
        rec.__enter__()
    try:
        with GraphServer(engine, **kw) as srv:
            handles = [srv.submit(p) for p in prompts]
            outs = [[int(t) for t in h.result(timeout=600)]
                    for h in handles]
            stats = srv.stats()
    finally:
        if rec is not None:
            rec.__exit__()
            drops.extend(rec.calls)
    ids = engine.rank_cache_ids()
    if any(r != ids[0] for r in ids):
        _HYGIENE.append(f"{engine.mesh_desc}: rank cache ids {ids}")
    return outs, stats


def prompts_for(cfg, n=4, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size,
                        size=int(rng.choice([5, 9, 12]))).astype(np.int32)
            for _ in range(n)]


def layout_kw(backend):
    return {"backend": backend, "block_size": 8} \
        if backend in ("paged", "hybrid") else {"backend": backend}


def compare(key, name, prompts, n, outs, base, extra=""):
    want = greedy(name, prompts, n)
    ok = outs == base == want
    record(key, ok, extra if ok else
           f"{extra} port {outs} / tp0 {base} / jax {want}")


def check_logits(name, sizes):
    """Every engine's first-step logits against JAX's, real vocab."""
    cfg, _ = CONFIGS[name]
    toks = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    je = jax_engine(name)
    jl, _ = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                             flags=je.flags)
    jl = np.asarray(jl)[:, :cfg.vocab_size]
    for tp in (0,) + sizes:
        got = engine_for(name, tp).prefill_logits(toks)
        err = float(np.abs(got[:, :cfg.vocab_size] - jl).max())
        pad_ok = bool((got[:, cfg.vocab_size:] == -1e30).all())
        record(f"logits/{name}/tp{tp}", err <= LOGIT_TOL and pad_ok,
               f"max abs err {err:.3g}, pad masked {pad_ok}")


def decode_scenarios(name, backend, key, sizes):
    cfg = CONFIGS[name][0]
    prompts = prompts_for(cfg)
    base, _ = serve(engine_for(name, 0), prompts, **layout_kw(backend))
    for tp in sizes:
        outs, _ = serve(engine_for(name, tp), prompts, **layout_kw(backend))
        compare(f"{key}/tp{tp}", name, prompts, 6, outs, base)


def moe_scenarios():
    """Decode on the slot and paged layouts with every MoE call's drops
    equal to the unsharded call's, then preemption replay."""
    cfg = CONFIGS["moe"][0]
    for backend in ("slot", "paged"):
        prompts = prompts_for(cfg)
        want_drops = []
        base, _ = serve(engine_for("moe", 0), prompts, drops=want_drops,
                        **layout_kw(backend))
        for tp in MESH_SIZES:
            drops = []
            outs, _ = serve(engine_for("moe", tp), prompts, drops=drops,
                            **layout_kw(backend))
            want = greedy("moe", prompts, 6)
            ok = outs == base == want and drops == want_drops
            record(f"decode/{backend}/moe/tp{tp}", ok,
                   f"calls={len(drops)} dropped={sum(drops)}" if ok else
                   f"drops {drops} / tp0 {want_drops}; port {outs} / tp0 "
                   f"{base} / jax {want}")
    preempt_scenarios("moe", "paged", "moe/")


def verify_scenarios(name, sizes):
    backend = LAYOUT[name]
    prompts = prompts_for(CONFIGS[name][0], seed=5)
    srv_kw = dict(layout_kw(backend), speculate_k=3, max_new_tokens=24)
    base, bstats = serve(engine_for(name, 0), prompts, **srv_kw)
    drafted = bstats["scheduler"].get("spec_drafted", 0)
    for tp in sizes:
        outs, _ = serve(engine_for(name, tp), prompts, **srv_kw)
        want = greedy(name, prompts, 24)
        ok = outs == base == want and drafted > 0
        record(f"verify/{backend}/tp{tp}", ok,
               f"drafted={drafted}" if ok else
               f"drafted={drafted} {outs} / {base} / {want}")


def extend_scenarios(name, sizes):
    backend = LAYOUT[name]
    rng = np.random.RandomState(7)
    long_prompts = [rng.randint(0, CONFIGS[name][0].vocab_size,
                                size=40).astype(np.int32) for _ in range(3)]
    srv_kw = dict(layout_kw(backend), chunk_size=8, max_new_tokens=6)
    base, _ = serve(engine_for(name, 0), long_prompts, **srv_kw)
    for tp in sizes:
        outs, _ = serve(engine_for(name, tp), long_prompts, **srv_kw)
        compare(f"extend/{backend}/tp{tp}", name, long_prompts, 6, outs,
                base)


def preempt_scenarios(name, backend, prefix="", sizes=(2, 4)):
    # 1 page at admission, 2+ worst-case, 5 usable blocks: optimistic
    # admission must preempt and the victims' replay reproduce their
    # tokens exactly, on every mesh size
    rng = np.random.RandomState(8)
    short = [rng.randint(0, CONFIGS[name][0].vocab_size,
                         size=6).astype(np.int32) for _ in range(5)]
    srv_kw = {"backend": backend, "block_size": 8, "num_blocks": 6,
              "num_slots": 5, "admission": "preempt", "max_new_tokens": 6}
    base, _ = serve(engine_for(name, 0), short, **srv_kw)
    for tp in sizes:
        outs, stats = serve(engine_for(name, tp), short, **srv_kw)
        pre = stats["scheduler"]["preemptions"]
        want = greedy(name, short, 6)
        ok = outs == base == want and pre > 0
        record(f"{prefix}preempt/{backend}/tp{tp}", ok,
               f"preemptions={pre}" if ok else
               f"preemptions={pre} {outs} / {base} / {want}")


def capacity_scenario(name, want):
    got = {tp: engine_for(name, tp).cache_shards() for tp in (1, 2)}
    record(f"capacity/{LAYOUT[name]}", got == want, f"cache_shards={got}")


def main():
    _imports()
    torch.set_num_threads(1)
    CONFIGS.update(_configs())

    check_logits("state", MESH_SIZES)
    decode_scenarios("state", "state", "decode/state/unfused", MESH_SIZES)
    extend_scenarios("state", (2, 4))
    capacity_scenario("state", {1: 1, 2: 1})
    close_engines("state")

    check_logits("hybrid", (1, 2))
    decode_scenarios("hybrid", "hybrid", "decode/hybrid/unfused", (1, 2))
    extend_scenarios("hybrid", (2,))
    preempt_scenarios("hybrid", "hybrid", sizes=(2,))
    capacity_scenario("hybrid", {1: 1, 2: 2})
    close_engines("hybrid")
    check_logits("hybrid4", (4,))
    decode_scenarios("hybrid4", "hybrid", "decode/hybrid/unfused", (4,))
    extend_scenarios("hybrid4", (4,))
    preempt_scenarios("hybrid4", "hybrid", sizes=(4,))
    close_engines("hybrid4")

    check_logits("moe", MESH_SIZES)
    moe_scenarios()
    close_engines("moe")

    verify_scenarios("state_spec", (2, 4))
    close_engines("state_spec")
    verify_scenarios("hybrid_spec", (2, 4))
    close_engines("hybrid_spec")

    record("hygiene/rank_cache_ids", not _HYGIENE, "; ".join(_HYGIENE))
    print("BATTERY " + json.dumps(RESULTS, sort_keys=True))
    return 0 if all(r["ok"] for r in RESULTS.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
