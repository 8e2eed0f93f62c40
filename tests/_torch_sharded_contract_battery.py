"""Equivalence battery for the port's tensor-parallel serving of the
contractions and of the widths the ranks do not divide: K/V on head_dim
and on the sequence, MLA's latent on its lora rank, the encoder-decoder
on a mesh, and every width ``resolve_spec`` leaves whole.

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_sharded_contract.py`` runs this file in a subprocess
with its own timeout and reads its verdicts, as the other two tp test
files run theirs (a file of its own, so that ``--dist loadfile`` runs
the three side by side).

Every case serves fixed greedy workloads through the port's
``GraphServer`` on an engine without a mesh (tp 0) and on meshes of 1,
2 and 4 gloo CPU ranks, all holding the JAX engine's weights
(``params_from_jax``).  Each run's tokens must equal the JAX unsharded
engine's per-request greedy ``generate`` on the same weights and the
port's tp 0 run, and every engine's first-step logits sit within 1e-4
of JAX's.  The cases (tp 2 / tp 4):

* ``mla``: reduced deepseek_v3_671b at d_model 64 (one dense head
  layer, one MoE layer), slot and paged: heads cut, ``c_kv`` on its lora
  rank and ``k_rope`` on the sequence (a paged block's offsets);
* ``hd``: a reduced qwen3_32b of 6 heads over 2 kv heads of 16, slot
  and paged: kv heads / head_dim with the heads whole;
* ``hd_hybrid``: the JAX battery's reduced jamba (2 kv heads of 64) on
  the hybrid layout: kv heads / head_dim with the heads cut;
* ``seq``: a reduced minicpm_2b of 6 heads over 3 kv heads of 6 and an
  FFN of 90, slot and paged: head_dim / the sequence, the heads and
  FFN whole at tp 4;
* ``encdec``: reduced seamless_m4t_large_v2 (2 kv heads of 64) through
  ``generate`` with 8 stub frames: kv heads / head_dim, encoder and
  cross attention included;
* at tp 4 only, the widths the constructor refused before: mLSTM heads
  (``xlstm_heads``), mLSTM dk (``xlstm_dk``), the sLSTM's gate blocks
  (``slstm``), Mamba's d_inner (``mamba``, hybrid), padded experts
  (``experts``, paged).

Per case and layout: decode, speculative verify windows (prompts that
repeat, so prompt-lookup drafting proposes windows), chunked extend
and, on the paged and hybrid layouts, preemption replay under block
pressure.  Besides: ``cache_shards`` equal to the JAX engine's rule,
every rank's cache leaves of ``local_tree``'s shapes, the ranks'
caches after every server closes, and every MoE call dropping nothing
(the shapes keep each call's tokens within its capacity, ROADMAP
Hazard 7).

Prints one ``BATTERY {json}`` line: {scenario: {ok, detail}}.
"""
import dataclasses
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

# the rank processes are spawned, and a spawned process imports this
# file again as its main module: JAX and the packages are imported in
# main() (``_imports``), not here, so that each rank starts light
jax = jnp = torch = moe = tf = None
jax_get_config = JaxEngine = get_config = make_serving_mesh = None
params_from_jax = GraphServer = LLMEngine = WorkerPool = None
flatten = local_tree = None


def _imports():
    global jax, jnp, torch, moe, tf, jax_get_config, JaxEngine, get_config
    global make_serving_mesh, params_from_jax, GraphServer, LLMEngine
    global WorkerPool, flatten, local_tree
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.serving import LLMEngine as JaxEngine
    import repro_torch.calculators  # noqa: F401 - registers the library
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import flatten, params_from_jax
    from repro_torch.serving import GraphServer, LLMEngine
    from repro_torch.sharding.group import WorkerPool
    from repro_torch.sharding.rules import local_tree


MAX_LEN = 64
BLOCK = 8
LOGIT_TOL = 1e-4
ENC_FRAMES = 8
RESULTS = {}

#: name -> (arch, overrides, layouts, mesh sizes)
CASES = {
    "mla": ("deepseek_v3_671b", dict(d_model=64, vocab_size=256, d_ff=64,
                                     dense_d_ff=64),
            ("slot", "paged"), (1, 2, 4)),
    "hd": ("qwen3_32b", dict(num_layers=1, d_model=64, num_heads=6,
                             num_kv_heads=2, head_dim=16, vocab_size=256),
           ("slot", "paged"), (1, 2, 4)),
    "hd_hybrid": ("jamba_1_5_large_398b", dict(d_model=64, vocab_size=256),
                  ("hybrid",), (1, 2, 4)),
    "seq": ("minicpm_2b", dict(num_layers=1, d_model=64, num_heads=6,
                               num_kv_heads=3, head_dim=6, d_ff=90,
                               dense_d_ff=90, vocab_size=256),
            ("slot", "paged"), (1, 2, 4)),
    "encdec": ("seamless_m4t_large_v2", dict(d_model=64, vocab_size=256),
               ("generate",), (1, 2, 4)),
    "xlstm_heads": ("xlstm_1_3b", dict(num_heads=6, d_model=96,
                                       vocab_size=256), ("state",), (4,)),
    "xlstm_dk": ("xlstm_1_3b", dict(block_pattern=("mlstm",), d_model=68,
                                    vocab_size=256), ("state",), (4,)),
    "slstm": ("xlstm_1_3b", dict(block_pattern=("slstm",), d_model=66,
                                 vocab_size=256), ("state",), (4,)),
    "mamba": ("jamba_1_5_large_398b", dict(num_kv_heads=4, d_model=66,
                                           ssm_expand=1, vocab_size=256),
              ("hybrid",), (4,)),
    "experts": ("granite_moe_3b_a800m", dict(d_model=64, num_heads=4,
                                             num_kv_heads=4, head_dim=16,
                                             num_experts=6, vocab_size=256),
                ("paged",), (4,)),
}

CONFIGS = {}
_JAX = {}
_PARAMS = {}
_ENGINES = {}
_GREEDY = {}
_HYGIENE = []
POOL = None


def _pair(arch, kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


def jax_engine(name):
    if name not in _JAX:
        _JAX[name] = JaxEngine(CONFIGS[name][1], max_len=MAX_LEN, seed=0)
        _PARAMS[name] = params_from_jax(
            jax.tree.map(np.asarray, _JAX[name].params), CONFIGS[name][0])
    return _JAX[name]


def engine_for(name, tp):
    """One engine per (case, mesh size); tp 0 has no mesh.  The meshes'
    workers come from one pool, so each mesh size starts its ranks
    once."""
    key = (name, tp)
    if key not in _ENGINES:
        jax_engine(name)
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp) if tp else None
        _ENGINES[key] = LLMEngine(CONFIGS[name][0], _PARAMS[name],
                                  max_len=MAX_LEN, device="cpu", mesh=mesh,
                                  pool=POOL if tp else None)
    return _ENGINES[key]


def close_engines(name):
    for key in [k for k in _ENGINES if k[0] == name]:
        _ENGINES.pop(key).close()


def record(key, ok, detail=""):
    RESULTS[key] = {"ok": bool(ok), "detail": str(detail)}
    print(f"{'ok ' if ok else 'FAIL'} {key} {detail}", flush=True)


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


class Drops:
    """While installed, the dropped (token, expert) pairs of every MoE
    call rank 0 routes."""

    def __init__(self):
        self.calls = []

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


def serve(engine, prompts, **srv_kw):
    """The prompts' streamed tokens and the server's stats; every MoE
    call's drops go to ``_HYGIENE`` where there are any."""
    kw = dict(num_slots=2, max_new_tokens=6)
    kw.update(srv_kw)
    with Drops() as drops:
        with GraphServer(engine, **kw) as srv:
            handles = [srv.submit(p) for p in prompts]
            outs = [[int(t) for t in h.result(timeout=600)]
                    for h in handles]
            stats = srv.stats()
    if any(drops.calls):
        _HYGIENE.append(f"{engine.cfg.name} {engine.mesh_desc}: MoE calls "
                        f"dropped {drops.calls}")
    ids = engine.rank_cache_ids()
    if any(r != ids[0] for r in ids):
        _HYGIENE.append(f"{engine.mesh_desc}: rank cache ids {ids}")
    return outs, stats


def layout_kw(backend):
    return {"backend": backend, "block_size": BLOCK} \
        if backend in ("paged", "hybrid") else {"backend": backend}


def prompts_for(cfg, lengths, seed, repeat=False):
    """Prompts of ``lengths``; ``repeat``: a 3-token motif repeated, so
    prompt-lookup drafting proposes windows to verify."""
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        p = rng.randint(0, cfg.vocab_size, size=3 if repeat else n)
        out.append(np.resize(p, n).astype(np.int32))
    return out


#: (scenario, prompt lengths, prompts repeat, server options) per
#: layout; every MoE call (the JAX reference's whole-prompt prefills
#: among them) stays within 8 tokens, which no capacity drops
SCENARIOS = {
    "decode": ((5, 7, 6, 8), False, {}),
    "verify": ((8, 7), True, {"speculate_k": 3, "max_new_tokens": 24}),
    "extend": ((8, 8), False, {"chunk_size": 3}),
    "preempt": ((4, 4, 4, 4), False, {"num_blocks": 4,
                                      "admission": "preempt",
                                      "max_new_tokens": 8}),
}


def serving_scenarios(name, backend, sizes):
    cfg = CONFIGS[name][0]
    for i, (scen, (lengths, repeat, kw)) in enumerate(SCENARIOS.items()):
        if scen == "preempt" and backend not in ("paged", "hybrid"):
            continue
        prompts = prompts_for(cfg, lengths, 10 + i, repeat)
        srv_kw = dict(layout_kw(backend), **kw)
        n = srv_kw.get("max_new_tokens", 6)
        base, bstats = serve(engine_for(name, 0), prompts, **srv_kw)
        want = greedy(name, prompts, n)
        for tp in sizes:
            outs, stats = serve(engine_for(name, tp), prompts, **srv_kw)
            sched = stats["scheduler"]
            seen = {"verify": sched.get("spec_drafted", 0),
                    "preempt": sched.get("preemptions", 0)}.get(scen, 1)
            ok = outs == base == want and seen > 0
            record(f"{scen}/{backend}/{name}/tp{tp}", ok,
                   f"seen={seen}" if ok else
                   f"seen={seen}; port {outs} / tp0 {base} / jax {want}")


def check_logits(name, sizes, enc=None):
    """Every engine's first-step logits against JAX's, real vocab."""
    cfg, _ = CONFIGS[name]
    toks = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    je = jax_engine(name)
    kw = {} if enc is None else {"enc_embeds": jnp.asarray(enc)}
    jl, _ = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                             flags=je.flags, **kw)
    jl = np.asarray(jl)[:, :cfg.vocab_size]
    for tp in (0,) + sizes:
        got = engine_for(name, tp).prefill_logits(toks, enc_embeds=enc)
        err = float(np.abs(got[:, :cfg.vocab_size] - jl).max())
        pad_ok = bool((got[:, cfg.vocab_size:] == -1e30).all())
        record(f"logits/{name}/tp{tp}", err <= LOGIT_TOL and pad_ok,
               f"max abs err {err:.3g}, pad masked {pad_ok}")


def jax_generate_with_memory(name, toks, enc, n):
    """The JAX model's greedy tokens of an encoder-decoder given its
    stub frames: its prefill with ``enc_embeds``, then n - 1 decode
    steps over the cache (the JAX engine's ``generate`` takes tokens
    only)."""
    je = jax_engine(name)
    logits, cache = je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                                     enc_embeds=jnp.asarray(enc),
                                     flags=je.flags)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    B, S = toks.shape
    for i in range(n - 1):
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, cache = je.model.decode_step(je.params, tok[:, None], cache,
                                             pos, flags=je.flags)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def encdec_scenarios(name, sizes):
    """``generate`` with the encoder's frames on every mesh: tokens equal
    to the JAX model's and tp 0's, each row equal to the row generated
    alone, and the logits of a prefill with memory within 1e-4."""
    cfg = CONFIGS[name][0]
    rng = np.random.RandomState(12)
    toks = rng.randint(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    enc = rng.randn(2, ENC_FRAMES, cfg.d_model).astype(np.float32)
    want = jax_generate_with_memory(name, toks, enc, 8)
    base = engine_for(name, 0).generate(toks, 8, enc_embeds=enc)
    for tp in sizes:
        eng = engine_for(name, tp)
        got = eng.generate(toks, 8, enc_embeds=enc)
        alone = np.concatenate([eng.generate(toks[b:b + 1], 8,
                                             enc_embeds=enc[b:b + 1])
                                for b in range(2)])
        ok = (np.array_equal(got, want) and np.array_equal(base, want)
              and np.array_equal(alone, got))
        record(f"generate/{name}/tp{tp}", ok, "" if ok else
               f"port {got.tolist()} / alone {alone.tolist()} / tp0 "
               f"{base.tolist()} / jax {want.tolist()}")
    check_logits(name, sizes, enc)


def _abstract(cfg, backend):
    if backend in ("slot", "state", "generate"):
        enc = ENC_FRAMES if cfg.is_encoder_decoder else 0
        return tf.abstract_cache(cfg, 2, MAX_LEN, enc)
    if backend == "paged":
        return tf.abstract_paged_cache(cfg, 9, BLOCK)
    return tf.abstract_hybrid_cache(cfg, 2, 9, BLOCK)


def structure_scenarios(name, layouts, sizes):
    """``cache_shards`` against the JAX engine's own rule, and every
    rank's cache leaves against ``local_tree``'s shapes."""
    cfg, jcfg = CONFIGS[name]
    for tp in sizes:
        mesh = make_serving_mesh(tp, devices=["cpu"] * tp)
        stub = types.SimpleNamespace(mesh=mesh, tp=tp, cfg=jcfg)
        want = JaxEngine.cache_shards(stub)
        got = engine_for(name, tp).cache_shards()
        record(f"cache_shards/{name}/tp{tp}", got == want,
               f"port {got} / jax rule {want}")
        for backend in layouts:
            eng = engine_for(name, tp)
            if backend == "generate":       # the prefill's rows
                _, cache = eng.prefill(
                    np.zeros((2, 5), np.int32),
                    enc_embeds=np.zeros((2, ENC_FRAMES, cfg.d_model),
                                        np.float32))
            else:
                kw = dict(kind=backend, num_slots=2, num_blocks=9,
                          block_size=BLOCK)
                cache = eng.new_cache(types.SimpleNamespace(**kw))
            shapes = eng.rank_cache_shapes(cache)
            want = {p: tuple(a.shape) for p, a in flatten(local_tree(
                _abstract(cfg, backend), mesh)).items()}
            ok = all(s == want for s in shapes)
            record(f"cache_shapes/{backend}/{name}/tp{tp}", ok,
                   "" if ok else f"ranks {shapes} / local_tree {want}")


def main(names=()):
    """Every case, or the ``names`` given on the command line."""
    global POOL
    _imports()
    torch.set_num_threads(1)
    POOL = WorkerPool()
    t0 = time.time()
    try:
        for name, (arch, kw, layouts, sizes) in CASES.items():
            if names and name not in names:
                continue
            CONFIGS[name] = _pair(arch, kw)
            if "generate" in layouts:
                encdec_scenarios(name, sizes)
            else:
                check_logits(name, sizes)
                for backend in layouts:
                    serving_scenarios(name, backend, sizes)
            structure_scenarios(name, layouts, sizes)
            close_engines(name)
            print(f"-- {name}: {time.time() - t0:.1f}s", flush=True)
    finally:
        POOL.close()
    record("hygiene/ranks_and_drops", not _HYGIENE, "; ".join(_HYGIENE))
    print("BATTERY " + json.dumps(RESULTS, sort_keys=True))
    return 0 if all(r["ok"] for r in RESULTS.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
