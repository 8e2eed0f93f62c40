"""Equivalence battery for the port's tensor-parallel serving of
sliding-window attention: every arm a rank's K/V (or MLA's latents) can
lie on, each with a window of 16 over prompts that pass it.

NOT a test module (the leading underscore keeps pytest away):
``tests/test_torch_window.py`` runs this file in a subprocess with its
own timeout and reads its verdicts, as the tp test files run theirs.

Every arm serves the same requests through the port's Scheduler (2
slots, no chunking, no speculation, as JAX serves a window; one forced
preemption, replayed through the decode step) on an engine without a
mesh and on a mesh of gloo CPU ranks, both holding the JAX engine's
weights (``params_from_jax``).  Each run's tokens must equal the JAX
unsharded engine's per-request greedy ``generate`` on the same weights,
and its first-step logits sit within 1e-4 of JAX's.  The arms:

* ``heads``: reduced minicpm_2b (4 heads over 2 kv heads) at tp 2: a
  rank holds its kv heads and decodes through
  ``attention.window_decode``;
* ``head_dim``: a reduced qwen3_32b of 6 heads over 3 kv heads of 16 at
  tp 2: K/V on head_dim (``attention.tp_decode``);
* ``seq``: a reduced minicpm_2b of 6 heads over 3 kv heads of 6 at tp
  4: K/V on the window's slots;
* ``mla``: reduced deepseek_v3_671b at d_model 64 at tp 2: ``c_kv`` on
  its lora rank, ``k_rope`` on the window's slots (``mla.tp_decode``);
* ``state``: the reduced jamba_1_5_large_398b (2 kv heads of 64) on the
  state layout at tp 2: windowed attention rows beside the Mamba state.

Prints one ``BATTERY {json}`` line: {arm: {ok, detail}}; run by hand,
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_window_battery.py
[arm ...]``.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

# the rank processes are spawned, and a spawned process imports this
# file again as its main module: JAX and the packages are imported in
# main() (``_imports``), not here, so that each rank starts light
jax = jnp = torch = None
jax_get_config = JaxEngine = get_config = make_serving_mesh = None
params_from_jax = LLMEngine = Scheduler = WorkerPool = None
SlotBackend = StateBackend = None

WINDOW = 16
MAX_LEN = 64
LENGTHS = (21, 9, 30, 12)
MAX_NEW = 8
LOGIT_TOL = 1e-4

#: arm -> (arch, overrides, layout, mesh size)
ARMS = {
    "heads": ("minicpm_2b", dict(num_layers=1, d_model=64, vocab_size=256),
              "slot", 2),
    "head_dim": ("qwen3_32b", dict(num_layers=1, d_model=64, num_heads=6,
                                   num_kv_heads=3, head_dim=16,
                                   vocab_size=256), "slot", 2),
    "seq": ("minicpm_2b", dict(num_layers=1, d_model=64, num_heads=6,
                               num_kv_heads=3, head_dim=6, d_ff=90,
                               dense_d_ff=90, vocab_size=256), "slot", 4),
    "mla": ("deepseek_v3_671b", dict(d_model=64, vocab_size=256, d_ff=64,
                                     dense_d_ff=64), "slot", 2),
    "state": ("jamba_1_5_large_398b", dict(d_model=64, vocab_size=256),
              "state", 2),
}
RESULTS = {}


def _imports():
    global jax, jnp, torch, jax_get_config, JaxEngine, get_config
    global make_serving_mesh, params_from_jax, LLMEngine, Scheduler
    global WorkerPool, SlotBackend, StateBackend
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.serving import LLMEngine as JaxEngine
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.params import params_from_jax
    from repro_torch.serving import (LLMEngine, Scheduler, SlotBackend,
                                     StateBackend)
    from repro_torch.sharding.group import WorkerPool


def record(key, ok, detail=""):
    RESULTS[key] = {"ok": bool(ok), "detail": str(detail)}
    print(f"{'ok ' if ok else 'FAIL'} {key} {detail}", flush=True)


def serve(engine, layout, prompts):
    """Each prompt's tokens through a 2-slot Scheduler, the first request
    to stream 3 tokens preempted once."""
    be = (StateBackend if layout == "state" else SlotBackend)(engine, 2)
    sched = Scheduler(be, max_new_tokens=MAX_NEW)
    for i, p in enumerate(prompts):
        sched.submit({"tokens": p, "id": i})
    got, preempted = {}, False
    while sched.has_work():
        for ev in sched.admit() + sched.step():
            if ev.finished:
                got[ev.request.id] = [int(t) for t in ev.request.tokens]
        for req in sched.slots:
            if not preempted and req is not None \
                    and len(req.tokens) >= 3 and req not in sched.ingesting:
                sched.preempt(req)
                preempted = True
    assert sched.stats["replayed_tokens"] > 0
    return [got[i] for i in range(len(prompts))]


def run_arm(name, pools):
    arch, kw, layout, tp = ARMS[name]
    kw = dict(kw, sliding_window=WINDOW)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    je = JaxEngine(jcfg, max_len=MAX_LEN, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, je.params), cfg)
    rng = np.random.RandomState(30)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    want = [[int(t) for t in je.generate(p[None], MAX_NEW)[0]]
            for p in prompts]
    toks = np.stack([prompts[0][:13], prompts[2][:13]])
    jl = np.asarray(je.model.prefill(je.params, jnp.asarray(toks), MAX_LEN,
                                     flags=je.flags)[0])[:, :cfg.vocab_size]
    faults = []
    for size in (0, tp):
        mesh = make_serving_mesh(size, devices=["cpu"] * size) \
            if size else None
        engine = LLMEngine(cfg, params, max_len=MAX_LEN, device="cpu",
                           mesh=mesh, pool=pools.get(size))
        try:
            err = float(np.abs(engine.prefill_logits(toks)[
                :, :cfg.vocab_size] - jl).max())
            if err > LOGIT_TOL:
                faults.append(f"tp{size}: logits {err:.3g} from JAX's")
            got = serve(engine, layout, prompts)
            if got != want:
                faults.append(f"tp{size}: tokens {got} != JAX {want}")
        finally:
            engine.close()
    record(name, not faults, "; ".join(faults))


def main(names=()):
    _imports()
    torch.set_num_threads(1)
    pools = {}
    t0 = time.time()
    try:
        for name in ARMS:
            if names and name not in names:
                continue
            tp = ARMS[name][3]
            if tp not in pools:
                pools[tp] = WorkerPool()
            try:
                run_arm(name, pools)
            except Exception as err:          # a verdict, not a crash
                record(name, False, f"{type(err).__name__}: {err}")
            print(f"-- {name}: {time.time() - t0:.1f}s", flush=True)
    finally:
        for pool in pools.values():
            pool.close()
    print("BATTERY " + json.dumps(RESULTS, sort_keys=True))
    return 0 if all(r["ok"] for r in RESULTS.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
