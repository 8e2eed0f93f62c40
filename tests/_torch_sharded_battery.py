"""Equivalence battery for the port's tensor-parallel serving.

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_sharded.py`` runs this file in a subprocess with its
own timeout and reads its verdicts, as ``tests/test_sharded_serving.py``
runs the JAX package's battery.  A subprocess keeps the rank processes
each engine starts (``repro_torch/sharding/group.py``: spawned, gloo on
the CPU) away from the pytest worker.

Every scenario serves a fixed greedy workload through the port's
``GraphServer`` on engines without a mesh (tp 0) and on meshes of 1, 2
and 4 CPU ranks, all holding the JAX engine's weights
(``params_from_jax``).  The streamed tokens of each run must equal the
JAX unsharded engine's per-request greedy ``generate`` on the same
weights and the port's tp 0 run; the first-step logits of every engine
must sit within 1e-4 of JAX's.  Covered, on the slot and paged layouts:
decode with the fused op and without, speculative verify windows,
chunked extend, preemption replay, the capacity of the default paged
arena, on the JAX battery's reduced minicpm_2b (one layer, d_model 64,
4 heads of 16 over 4 kv heads; vocab 256, and 4 for the verify runs)
and a reduced qwen3_32b (GQA: 8 heads over 4 kv heads, qk-norm).  After
every server closes, every rank must hold exactly rank 0's live cache
ids.

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
jax = jnp = torch = None
jax_get_config = JaxEngine = get_config = make_serving_mesh = None
params_from_jax = RuntimeFlags = GraphServer = LLMEngine = None


def _imports():
    global jax, jnp, torch, jax_get_config, JaxEngine, get_config
    global make_serving_mesh, params_from_jax, RuntimeFlags, GraphServer
    global LLMEngine
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.serving import LLMEngine as JaxEngine
    import repro_torch.calculators  # noqa: F401 - registers the library
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.params import params_from_jax
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import GraphServer, LLMEngine


MESH_SIZES = (1, 2, 4)
MAX_LEN = 64
LOGIT_TOL = 1e-4
RESULTS = {}

ATTN_KW = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=4,
               head_dim=16, vocab_size=256)


def _pair(name, **kw):
    return (dataclasses.replace(get_config(name).reduced(), **kw),
            dataclasses.replace(jax_get_config(name).reduced(), **kw))


def _configs():
    return {
        "attn": _pair("minicpm_2b", **ATTN_KW),
        # tiny vocab: greedy decode settles into repetition loops, where
        # prompt-lookup drafting proposes windows to verify
        "spec": _pair("minicpm_2b", **dict(ATTN_KW, vocab_size=4)),
        "qwen3": _pair("qwen3_32b", num_layers=1, d_model=64, num_heads=8,
                       num_kv_heads=4, head_dim=16, vocab_size=256),
    }


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


def engine_for(name, fused, tp):
    """One engine per (config, fused, mesh size); tp 0 has no mesh."""
    key = (name, fused, tp)
    if key not in _ENGINES:
        jax_engine(name)
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp) if tp else None
        _ENGINES[key] = LLMEngine(
            CONFIGS[name][0], _PARAMS[name], max_len=MAX_LEN,
            flags=RuntimeFlags(use_fused_decode=fused), device="cpu",
            mesh=mesh)
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


def serve(engine, prompts, **srv_kw):
    kw = dict(num_slots=2, max_new_tokens=6)
    kw.update(srv_kw)
    with GraphServer(engine, **kw) as srv:
        handles = [srv.submit(p) for p in prompts]
        outs = [[int(t) for t in h.result(timeout=600)] for h in handles]
        stats = srv.stats()
    ids = engine.rank_cache_ids()
    if any(r != ids[0] for r in ids):
        _HYGIENE.append(f"{engine.mesh_desc}: rank cache ids {ids}")
    return outs, stats


def prompts_for(cfg, n=4, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size,
                        size=int(rng.choice([5, 9, 12]))).astype(np.int32)
            for _ in range(n)]


def compare(key, name, prompts, n, outs, base, extra=""):
    want = greedy(name, prompts, n)
    ok = outs == base == want
    record(key, ok, extra if ok else
           f"{extra} port {outs} / tp0 {base} / jax {want}")


def check_logits(name):
    """Every engine's first-step logits against JAX's, real vocab."""
    cfg, jcfg = CONFIGS[name]
    toks = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    je = jax_engine(name)
    jl, _ = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                             flags=je.flags)
    jl = np.asarray(jl)[:, :cfg.vocab_size]
    for tp in (0,) + MESH_SIZES:
        got = engine_for(name, False, tp).prefill_logits(toks)
        err = float(np.abs(got[:, :cfg.vocab_size] - jl).max())
        pad_ok = bool((got[:, cfg.vocab_size:] == -1e30).all())
        record(f"logits/{name}/tp{tp}", err <= LOGIT_TOL and pad_ok,
               f"max abs err {err:.3g}, pad masked {pad_ok}")


def decode_scenarios(name, prefix=""):
    cfg = CONFIGS[name][0]
    for backend in ("slot", "paged"):
        for fused in (False, True):
            prompts = prompts_for(cfg)
            srv_kw = {"backend": backend}
            if backend == "paged":
                srv_kw["block_size"] = 8
            base, _ = serve(engine_for(name, fused, 0), prompts, **srv_kw)
            tag = "fused" if fused else "unfused"
            for tp in MESH_SIZES:
                outs, _ = serve(engine_for(name, fused, tp), prompts,
                                **srv_kw)
                compare(f"{prefix}decode/{backend}/{tag}/tp{tp}", name,
                        prompts, 6, outs, base)


def verify_scenarios():
    for backend, fused in (("slot", False), ("paged", False),
                           ("paged", True)):
        prompts = prompts_for(CONFIGS["spec"][0], seed=5)
        srv_kw = {"backend": backend, "speculate_k": 3,
                  "max_new_tokens": 24}
        if backend == "paged":
            srv_kw["block_size"] = 8
        base, bstats = serve(engine_for("spec", fused, 0), prompts, **srv_kw)
        drafted = bstats["scheduler"].get("spec_drafted", 0)
        tag = "fused" if fused else "unfused"
        for tp in (2, 4):
            outs, _ = serve(engine_for("spec", fused, tp), prompts, **srv_kw)
            want = greedy("spec", prompts, 24)
            ok = outs == base == want and drafted > 0
            record(f"verify/{backend}/{tag}/tp{tp}", ok,
                   f"drafted={drafted}" if ok else
                   f"drafted={drafted} {outs} / {base} / {want}")


def extend_scenarios(name, prefix="", backends=("slot", "paged")):
    rng = np.random.RandomState(7)
    long_prompts = [rng.randint(0, 256, size=40).astype(np.int32)
                    for _ in range(3)]
    for backend in backends:
        srv_kw = {"backend": backend, "chunk_size": 8, "max_new_tokens": 6}
        if backend == "paged":
            srv_kw["block_size"] = 8
        base, _ = serve(engine_for(name, False, 0), long_prompts, **srv_kw)
        for tp in (2, 4):
            outs, _ = serve(engine_for(name, False, tp), long_prompts,
                            **srv_kw)
            compare(f"{prefix}extend/{backend}/tp{tp}", name, long_prompts,
                    6, outs, base)


def preempt_scenarios(name, prefix=""):
    # 1 page at admission, 2+ worst-case, 5 usable blocks: optimistic
    # admission must preempt and the victims' replay reproduce their
    # tokens exactly, on every mesh size
    rng = np.random.RandomState(8)
    short = [rng.randint(0, 256, size=6).astype(np.int32) for _ in range(5)]
    srv_kw = {"backend": "paged", "block_size": 8, "num_blocks": 6,
              "num_slots": 5, "admission": "preempt", "max_new_tokens": 6}
    base, _ = serve(engine_for(name, False, 0), short, **srv_kw)
    for tp in (2, 4):
        outs, stats = serve(engine_for(name, False, tp), short, **srv_kw)
        pre = stats["scheduler"]["preemptions"]
        want = greedy(name, short, 6)
        ok = outs == base == want and pre > 0
        record(f"{prefix}preempt/paged/tp{tp}", ok,
               f"preemptions={pre}" if ok else
               f"preemptions={pre} {outs} / {base} / {want}")


def capacity_scenario():
    blocks = {}
    for tp in MESH_SIZES:
        with GraphServer(engine_for("attn", False, tp), num_slots=2,
                         max_new_tokens=4, backend="paged",
                         block_size=8) as srv:
            blocks[tp] = srv._num_blocks
    record("capacity/paged", blocks[1] < blocks[2] < blocks[4],
           f"blocks={blocks}")


def main():
    _imports()
    torch.set_num_threads(1)
    CONFIGS.update(_configs())
    check_logits("attn")
    decode_scenarios("attn")
    extend_scenarios("attn")
    preempt_scenarios("attn")
    capacity_scenario()
    close_engines("attn")
    verify_scenarios()
    close_engines("spec")
    check_logits("qwen3")
    decode_scenarios("qwen3", "qwen3/")
    extend_scenarios("qwen3", "qwen3/", ("paged",))
    preempt_scenarios("qwen3", "qwen3/")
    close_engines("qwen3")
    record("hygiene/rank_cache_ids", not _HYGIENE, "; ".join(_HYGIENE))
    print("BATTERY " + json.dumps(RESULTS, sort_keys=True))
    return 0 if all(r["ok"] for r in RESULTS.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
