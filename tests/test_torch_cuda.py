"""The port's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode: the tests here carry the ``cuda`` marker
and skip without a CUDA device (the fixture decides, at run time).  The
module imports no JAX, so it also runs on a machine without it
(``--noconftest`` skips the JAX package's fixtures):

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    dt = TDT[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dt)

    x, s = rand(9, 2304), rand(2304)
    assert (ops.rmsnorm(x, s).float()
            - ref.rmsnorm_ref(x, s).float()).abs().max() < TOL[dtype]
    q, k, v = rand(2, 140, 4, 64), rand(2, 140, 2, 64), rand(2, 140, 2, 64)
    full = ops.flash_attention(q, k, v)
    assert (full.float() - ref.flash_attention_ref(q, k, v).float()
            ).abs().max() < TOL[dtype]
    suffix = ops.flash_attention(q[:, 37:].contiguous(), k, v, q_offset=37)
    assert torch.equal(suffix, full[:, 37:])
    B, Sq, P, bs = 3, 3, 6, 8
    args = [rand(B, Sq, 4, 64), rand(B, Sq, 2, 64), rand(B, Sq, 2, 64),
            rand(1 + B * P, bs, 2, 64), rand(1 + B * P, bs, 2, 64)]
    tables = (1 + torch.arange(B, device=cuda_device)[:, None] * P
              + torch.arange(P, device=cuda_device)).int()
    pos = torch.tensor([0, 20, 44], dtype=torch.int32, device=cuda_device)
    freqs = ref.rope_freqs(64, 10_000.0, cuda_device)
    plain = [a.clone() for a in args]
    out = ops.fused_flash_decode(*args, tables, pos, freqs)
    want = ref.fused_flash_decode_ref(*plain, tables, pos, freqs)
    assert (out.float() - want.float()).abs().max() < TOL[dtype]
    # the arenas on every non-trash block, as allclose(atol=rtol=TOL):
    # the kernel's cosf/sinf and torch's cos/sin may round the rotated K
    # one ulp apart
    for got, ref_arena in ((args[3], plain[3]), (args[4], plain[4])):
        torch.testing.assert_close(got[1:].float(), ref_arena[1:].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_kernels_match_plain(cuda_device, dtype):
    """K4 (split-K fused decode) against its plain version and K2, K5
    (paged attention) against its plain version, on a paged arena whose
    rows span several 256-key splits; each row alone is bitwise equal to
    its row of the batch."""
    dt = TDT[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dt)

    B, Sq, H, KV, hd, bs, P = 3, 2, 8, 2, 64, 16, 40
    pos = torch.tensor([0, 255, 600], dtype=torch.int32, device=cuda_device)
    tables = (1 + torch.randperm(B * P, device=cuda_device, generator=g)
              .view(B, P)).int()
    q, kn, vn = rand(B, Sq, H, hd), rand(B, Sq, KV, hd), rand(B, Sq, KV, hd)
    arena = [rand(1 + B * P, bs, KV, hd), rand(1 + B * P, bs, KV, hd)]
    freqs = ref.rope_freqs(hd, 10_000.0, cuda_device)
    a4, a2, ap = ([t.clone() for t in arena] for _ in range(3))
    out4 = ops.fused_flash_decode(q, kn, vn, *a4, tables, pos, freqs,
                                  split_k=True)
    out2 = ops.fused_flash_decode(q, kn, vn, *a2, tables, pos, freqs)
    want = ref.fused_flash_decode_ref(q, kn, vn, *ap, tables, pos, freqs)
    for got in (out4, out2):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    for got, ref_arena in zip(a4, ap):
        torch.testing.assert_close(got[1:].float(), ref_arena[1:].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    alone = ops.fused_flash_decode(
        q[2:].contiguous(), kn[2:].contiguous(), vn[2:].contiguous(),
        *[t.clone() for t in arena], tables[2:].contiguous(),
        pos[2:].contiguous(), freqs, split_k=True)
    assert torch.equal(alone, out4[2:])

    q5 = rand(B, H, hd)
    out5 = ops.paged_attention(q5, *arena, tables, pos)
    torch.testing.assert_close(
        out5.float(), ref.paged_attention_ref(q5, *arena, tables, pos).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    alone5 = ops.paged_attention(q5[1:2].contiguous(), *arena,
                                 tables[1:2].contiguous(),
                                 pos[1:2].contiguous())
    assert torch.equal(alone5, out5[1:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_kernels_at_qwen3_shape(cuda_device, dtype):
    """K3 and K5 at qwen3_32b's attention shape (64 heads, 8 kv heads,
    head_dim 128) against their plain versions: in bf16 the tensor-core
    kernels, in f32 the exact-f32 bodies.  K3's suffix at q_offset 256
    (a serving chunk boundary) is bitwise equal to the full prefill's
    rows; K5's rows alone are bitwise equal to their rows of the batch,
    at up to 4096 keys and with one inactive all-zero row."""
    dt = TDT[dtype]
    tol = TOL[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dt)

    H, KV, hd = 64, 8, 128
    q, k, v = rand(1, 512, H, hd), rand(1, 512, KV, hd), rand(1, 512, KV, hd)
    full = ops.flash_attention(q, k, v)
    torch.testing.assert_close(
        full.float(), ref.flash_attention_ref(q, k, v).float(), atol=tol,
        rtol=tol)
    suffix = ops.flash_attention(q[:, 256:].contiguous(), k, v, q_offset=256)
    assert torch.equal(suffix, full[:, 256:])

    bs, P = 16, 4096 // 16
    keys = (1, 300, 4096)
    need = [-(-n // bs) for n in keys]
    NB = 1 + sum(need)
    perm = 1 + torch.randperm(NB - 1, device=cuda_device, generator=g)
    tables = torch.zeros(len(keys) + 1, P, dtype=torch.int32,
                         device=cuda_device)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n].int()
        at += n
    pos = torch.tensor([n - 1 for n in keys] + [37], dtype=torch.int32,
                       device=cuda_device)
    arena = [rand(NB, bs, KV, hd), rand(NB, bs, KV, hd)]
    q5 = rand(len(keys) + 1, H, hd)
    out = ops.paged_attention(q5, *arena, tables, pos)
    want = ref.paged_attention_ref(q5, *arena, tables, pos)
    active = slice(0, len(keys))
    torch.testing.assert_close(out[active].float(), want[active].float(),
                               atol=tol, rtol=tol)
    assert bool(torch.isfinite(out).all())
    for b in range(len(keys) + 1):
        alone = ops.paged_attention(q5[b:b + 1].contiguous(), *arena,
                                    tables[b:b + 1].contiguous(),
                                    pos[b:b + 1].contiguous())
        assert torch.equal(alone, out[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,hd", [(64, 8, 128), (32, 8, 160)],
                         ids=["qwen3_32b", "stablelm_12b"])
def test_cuda_fused_decode_verify_window(cuda_device, dtype, H, KV, hd):
    """K2 and K4 over a verify window of 5 queries at qwen3_32b's GQA
    shape (40 query rows a kv head: three 16-row tiles) and stablelm_12b's
    head_dim 160, against their plain version (output and both arenas),
    on a paged arena whose rows end inside, at and past 256-key span
    boundaries; each row alone is bitwise equal to its row of the
    batch."""
    dt = TDT[dtype]
    tol = TOL[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dt)

    Sq, bs, P = 5, 16, 64
    pos = torch.tensor([0, 252, 700, 1000], dtype=torch.int32,
                       device=cuda_device)
    B = pos.numel()
    tables = (1 + torch.randperm(B * P, device=cuda_device, generator=g)
              .view(B, P)).int()
    q, kn, vn = rand(B, Sq, H, hd), rand(B, Sq, KV, hd), rand(B, Sq, KV, hd)
    arena = [rand(1 + B * P, bs, KV, hd), rand(1 + B * P, bs, KV, hd)]
    freqs = ref.rope_freqs(hd, 10_000.0, cuda_device)
    ap = [t.clone() for t in arena]
    want = ref.fused_flash_decode_ref(q, kn, vn, *ap, tables, pos, freqs)
    for split_k in (False, True):
        a = [t.clone() for t in arena]
        out = ops.fused_flash_decode(q, kn, vn, *a, tables, pos, freqs,
                                     split_k=split_k)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        for got, ref_arena in zip(a, ap):
            torch.testing.assert_close(got[1:].float(), ref_arena[1:].float(),
                                       atol=tol, rtol=tol)
        for b in range(B):
            alone = ops.fused_flash_decode(
                q[b:b + 1].contiguous(), kn[b:b + 1].contiguous(),
                vn[b:b + 1].contiguous(), *[t.clone() for t in arena],
                tables[b:b + 1].contiguous(), pos[b:b + 1].contiguous(),
                freqs, split_k=split_k)
            assert torch.equal(alone, out[b:b + 1])


@pytest.mark.cuda
def test_cuda_sync_point_waits_for_the_card(cuda_device):
    """The port's ``SyncPointCalculator`` on CUDA payloads: a graph
    ``InferenceCalculator -> SyncPointCalculator`` whose engine queues a
    device sleep and a product on the card, called from the graph's
    executor thread.  The packet that leaves the sync point carries the
    very same tensors (bare, and in a tuple, a list and a dict), and an
    event recorded after the work has completed by then."""
    import repro_torch.calculators  # noqa: F401 (registers them)
    from repro_torch.core import Graph, GraphBuilder

    b = GraphBuilder()
    infer = b.add_node("InferenceCalculator", name="infer",
                       inputs={"IN": b.input("in")},
                       side_inputs={"engine": b.side_input("engine")})
    sync = b.add_node("SyncPointCalculator", name="sync",
                      inputs={"IN": infer.out("OUT", name="results")})
    b.output(sync.out("OUT", name="synced"))
    made = []
    forms = (lambda y: y, lambda y: (y, 1), lambda y: [0, y],
             lambda y: {"y": y, "n": "x"})

    def engine(i):
        x = torch.full((256, 256), 0.5, device=cuda_device)
        torch.cuda._sleep(100_000_000)          # ~50 ms of device time
        y = x @ x
        event = torch.cuda.Event()
        event.record()
        made.append((y, event))
        return forms[i](y)

    graph = Graph(b.build(), side_packets={"engine": engine})
    poller = graph.add_output_stream_poller("synced")
    graph.start_run()
    for i in range(len(forms)):
        graph.add_packet_to_input_stream("in", i, i)
    graph.close_all_input_streams()
    for i in range(len(forms)):
        payload = poller.next().payload
        y, event = made[i]
        assert event.query(), f"form {i}: the packet left before the work"
        got = {0: lambda p: p, 1: lambda p: p[0], 2: lambda p: p[1],
               3: lambda p: p["y"]}[i](payload)
        assert got is y
        assert torch.equal(y.cpu(), torch.full((256, 256), 64.0))
    graph.wait_until_done(timeout=60)


# ---------------------------------------------------------------------------
# decode and verify as captured CUDA graphs (runtime/graphs.py)
# ---------------------------------------------------------------------------

def _captured_and_eager(dtype, arch="minicpm_2b", **flags):
    """A reduced ``arch`` engine on the card that captures its steps,
    and one on the same weights that runs them eagerly."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeFlags
    from repro_torch.serving import LLMEngine
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              num_layers=2, d_model=128, vocab_size=512,
                              dtype=dtype)
    cap = LLMEngine(cfg, max_len=128, seed=3, flags=RuntimeFlags(**flags))
    eager = LLMEngine(cfg, dict(cap.model.named_parameters()), max_len=128,
                      flags=RuntimeFlags(cuda_graphs=False, **flags))
    assert cap.graphs is not None and eager.graphs is None
    return cap, eager


@pytest.mark.cuda
@pytest.mark.parametrize("split_k", [False, True])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_cuda_captured_steps_equal_eager(cuda_device, kind, split_k):
    """Serve decode and verify windows through their captured graphs give
    the eager steps' tokens and leave the same cache, bitwise, on the
    first call of a key (run eagerly, then captured) and on replays."""
    cap, eager = _captured_and_eager("bfloat16", fused_split_k=split_k)
    _check_captured(cuda_device, cap, eager, kind)


def _check_captured(cuda_device, cap, eager, kind):
    """Decode and verify calls through ``cap`` (captured) and ``eager``
    on equal caches: equal tokens and caches after every call."""
    be = types.SimpleNamespace(kind=kind, num_slots=4, block_size=16,
                               num_blocks=1 + 4 * 128 // 16)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    caches = [e.new_cache(be) for e in (cap, eager)]
    for a, b in zip(*(list(_leaves(c)) for c in caches)):
        a.copy_(torch.randn(a.shape, device=cuda_device, generator=g))
        b.copy_(a)
    rng = np.random.RandomState(4)
    tables = None
    if kind == "paged":
        P = 128 // 16
        tables = (1 + np.arange(4 * P).reshape(4, P)).astype(np.int32)
        tables[3] = 0                      # an inactive slot
    active = np.array([True, True, True, False])
    for call, width in (("decode", 1), ("verify", 3), ("decode", 1),
                        ("verify", 3), ("verify", 3)):
        pos = rng.randint(0, 120, 4).astype(np.int32)
        toks = rng.randint(0, 512, (4, width)).astype(np.int32)
        outs = []
        for e, c in zip((cap, eager), caches):
            fn = getattr(e, call)
            arg = toks[:, 0] if call == "decode" else toks
            out, _ = fn(be, c, arg, pos, active, block_tables=tables)
            outs.append(out)
        np.testing.assert_array_equal(outs[0], outs[1], err_msg=call)
        for a, b in zip(*(list(_leaves(c)) for c in caches)):
            assert torch.equal(a, b), call
    assert len(cap.graphs) == 2


def _leaves(tree):
    """The tensors of a nested dict, in a fixed order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.cuda
def test_cuda_replay_counts_its_launches(cuda_device):
    """A captured step counts the launches of the work it does: the
    first call once (its eager run; the capture launches nothing), each
    replay again; the same counts as the eager engine's."""
    from repro_torch.kernels import build
    cap, eager = _captured_and_eager("bfloat16")
    be = types.SimpleNamespace(kind="slot", num_slots=4)
    pos = np.array([3, 9, 20, 40], np.int32)
    toks = np.array([1, 2, 3, 4], np.int32)
    active = np.ones(4, bool)
    counts = {}
    for name, e in (("captured", cap), ("eager", eager)):
        cache = e.new_cache(be)
        per = []
        for _ in range(3):
            for k in build.launches:
                build.launches[k] = 0
            e.decode(be, cache, toks, pos, active)
            per.append(dict(build.launches))
        counts[name] = per
    L = cap.cfg.num_layers
    one = {k: 0 for k in build.launches}
    one.update({"rmsnorm": 2 * L + 1, "fused_flash_decode": L})
    assert counts["captured"] == counts["eager"] == [one] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [0, 3])
def test_cuda_preempted_replay_captured_equals_eager(cuda_device, spec):
    """The Scheduler on a paged arena, a request preempted after it
    streamed tokens: its replay through the decode step gives the run's
    tokens without preemption, and the captured and eager engines give
    the same tokens and the same launches, bitwise."""
    from repro_torch.kernels import build
    from repro_torch.serving import PagedBackend, Scheduler
    cap, eager = _captured_and_eager("bfloat16")
    prompts = [np.random.RandomState(i).randint(0, 512, n).astype(np.int32)
               for i, n in enumerate((21, 34, 9))]
    runs = {}
    for name, e in (("captured", cap), ("eager", eager)):
        for preempt in (False, True):
            sched = Scheduler(PagedBackend(e, 2, num_blocks=33,
                                           block_size=16),
                              max_new_tokens=16, chunk_size=16,
                              speculate_k=spec)
            reqs = [sched.submit({"tokens": p, "id": i})
                    for i, p in enumerate(prompts)]
            for k in build.launches:
                build.launches[k] = 0
            while sched.has_work():
                sched.admit()
                sched.step()
                if preempt and reqs[0].preemptions == 0 \
                        and len(reqs[0].tokens) >= 8:
                    sched.preempt(reqs[0])
            runs[name, preempt] = ([list(r.tokens) for r in reqs],
                                   dict(build.launches),
                                   sched.stats["replay_steps"])
    for name in ("captured", "eager"):
        assert runs[name, True][0] == runs[name, False][0]
        assert runs[name, True][2] > 0
    assert runs["captured", True] == runs["eager", True]
    assert runs["captured", False] == runs["eager", False]


# ---------------------------------------------------------------------------
# the MoE FFN on the card (models/moe.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_moe_layer_matches_cpu(cuda_device):
    """One reduced granite MoE layer in f32 on the card and on the CPU:
    the same routing and outputs within 1e-4 of their scale, a token's
    choices in the order of the CPU's (ties to the lower index)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = get_config("granite_moe_3b_a800m").reduced()
    gen = torch.Generator().manual_seed(0)
    params = init_params(moe.moe_template(cfg), gen, "float32", "cpu")
    x = torch.randn(1, 64, cfg.d_model, generator=gen)
    out, aux = moe.moe_apply(params, cfg, x)
    dev = {k: v.to(cuda_device) for k, v in params.items()}
    out_d, aux_d = moe.moe_apply(dev, cfg, x.to(cuda_device))
    _, idx, _ = moe.route(params, cfg, x[0])
    _, idx_d, _ = moe.route(dev, cfg, x[0].to(cuda_device))
    assert torch.equal(idx_d.cpu(), idx)
    assert (out_d.cpu() - out).abs().max() <= 1e-4 * out.abs().max()
    assert abs(float(aux_d) - float(aux)) <= 1e-6
    zero = dict(dev, router=torch.zeros_like(dev["router"]))
    _, tied, _ = moe.route(zero, cfg, x[0].to(cuda_device))
    assert (tied.cpu() == torch.arange(cfg.num_experts_per_tok)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_cuda_moe_captured_steps_equal_eager(cuda_device, kind):
    """The MoE layer inside the captured decode and verify steps of
    reduced granite: captured and eager give the same tokens and caches,
    bitwise."""
    cap, eager = _captured_and_eager("bfloat16", "granite_moe_3b_a800m")
    _check_captured(cuda_device, cap, eager, kind)
