"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each port op runs its plain PyTorch version; it is held
against the JAX Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) and against the JAX ``ref.py`` oracle on the same numpy-seeded
inputs, at f32 2e-5 and bf16 2e-2.  The CUDA wrappers' input checks run
here too; the CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro.kernels.flash_decode import fused_flash_decode_kernel  # noqa: E402
from repro.kernels.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref,
    fused_flash_decode_ref as jax_decode_ref, rmsnorm_ref as jax_rmsnorm_ref)
from repro.kernels.rmsnorm import rmsnorm_kernel  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    fused_flash_decode_cuda, fused_flash_decode_splitk_cuda)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_cuda)
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    MAX_THREADS, MAX_VECS, rmsnorm_cuda)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    launch_plan as rmsnorm_launch_plan)
from test_torch_engine import one_torch_thread  # noqa: E402,F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype`` (both
    round f32 to bf16 to nearest even)."""
    return (jnp.asarray(a, jnp.float32).astype(JDT[dtype]),
            torch.tensor(a, dtype=torch.float32).to(TDT[dtype]))


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32)
                        - t.float().numpy()).max())


# ---------------------------------------------------------------------------
# K1 rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(7, 256), (33, 512), (3, 2304),
                                    # the other served widths
                                    (4, 1536), (5, 4096), (4, 5120),
                                    (3, 8192)])
def test_rmsnorm_plain_matches_jax(rows, d, dtype):
    rng = np.random.RandomState(rows * d)
    jx, tx = _pair(rng.randn(rows, d), dtype)
    js, ts = _pair(rng.randn(d), dtype)
    out = ops.rmsnorm(tx, ts, eps=1e-5)
    assert out.dtype == TDT[dtype] and out.shape == (rows, d)
    assert _err(rmsnorm_kernel(jx, js, eps=1e-5), out) < TOL[dtype]
    assert _err(jax_rmsnorm_ref(jx, js), out) < TOL[dtype]


def _ported_configs():
    return [(name, cfg) for name in ALL_ARCHS
            for cfg in (get_config(name), get_config(name).reduced())]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_launch_plan_covers_every_config(dtype):
    """K1's plan at every ported config's d_model, full and reduced:
    whole warps within MAX_THREADS (at most 1024, the kernel's
    ``kMaxThreads``), at most MAX_VECS vectors a thread, so at most 64
    registers of row data a thread (x and scale, 4 registers a 16-byte
    vector), vectors enough to cover the row and none a thread holds in
    vain."""
    dt = TDT[dtype]
    n = 16 // torch.empty((), dtype=dt).element_size()
    widths = {cfg.d_model for _, cfg in _ported_configs()}
    assert {1024, 1536, 2048, 2304, 3072, 4096, 5120, 8192} <= widths
    for d in sorted(widths):
        threads, vecs = rmsnorm_launch_plan(d, dt)
        assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS <= 1024
        assert 1 <= vecs <= MAX_VECS and 2 * 4 * vecs <= 64
        nvec = d // n
        assert threads * vecs >= nvec > threads * (vecs - 1), d
    assert rmsnorm_launch_plan(2304, torch.bfloat16) == (160, 2)
    assert rmsnorm_launch_plan(8192, torch.float32) == (256, 8)


def test_rmsnorm_launch_plan_limits_match_the_kernel():
    src = (build.CSRC / "rmsnorm.cu").read_text()
    assert f"constexpr int kMaxThreads = {MAX_THREADS};" in src
    assert f"constexpr int kMaxVecs = {MAX_VECS};" in src


@pytest.mark.parametrize("d,dtype,match", [
    (2300, torch.bfloat16, "16-byte"), (2306, torch.float32, "16-byte"),
    (0, torch.float32, "16-byte"), (16384 + 8, torch.bfloat16, "wider"),
    (8192 + 4, torch.float32, "wider")])
def test_rmsnorm_launch_plan_refuses(d, dtype, match):
    with pytest.raises(ValueError, match=match):
        rmsnorm_launch_plan(d, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 1536, 2048, 2304, 3072, 4096, 5120,
                               8192])
def test_rmsnorm_wrapper_plan_is_the_same_at_every_row_count(
        monkeypatch, d, dtype):
    """The wrapper passes the C entry the plan of (d, dtype) whatever
    the row count (1, 4, 256, 1024; x of 2 or 3 dims), and counts one
    launch a call.  The operand checks (a CUDA tensor) are stubbed and
    the library is a recorder: no card here."""
    calls = []

    class Lib:
        @staticmethod
        def repro_rmsnorm(x, s, out, rows, d_, eps, code, threads, vecs,
                          stream):
            calls.append((rows, d_, code, threads, vecs))
            return 0

    monkeypatch.setattr(build, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(build, "stream_handle", lambda t: 0)
    monkeypatch.setattr(build, "lib", lambda: Lib)
    dt = TDT[dtype]
    before = build.launches["rmsnorm"]
    shapes = [(1, d), (4, d), (256, d), (1024, d), (2, 128, d)]
    for shape in shapes:
        out = rmsnorm_cuda(torch.zeros(shape, dtype=dt),
                           torch.ones(d, dtype=dt))
        assert out.shape == shape and out.dtype == dt
    plan = rmsnorm_launch_plan(d, dt)
    assert calls == [(r, d, build.DTYPE_CODE[dt], *plan)
                     for r in (1, 4, 256, 1024, 256)]
    assert build.launches["rmsnorm"] == before + len(shapes)


# ---------------------------------------------------------------------------
# K3 flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, S_total, KV, G, hd, window, q_offset
    (2, 40, 2, 1, 64, 0, 0),
    (1, 150, 1, 2, 64, 0, 0),
    (2, 64, 2, 2, 64, 24, 0),
    (2, 100, 2, 2, 64, 0, 37),
    (1, 90, 1, 2, 64, 32, 50),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,KV,G,hd,window,off", FLASH_CASES)
def test_flash_attention_plain_matches_jax(B, S, KV, G, hd, window, off,
                                           dtype):
    H = KV * G
    rng = np.random.RandomState(S * H + hd + off)
    jq, tq = _pair(rng.randn(B, S - off, H, hd), dtype)
    jk, tk = _pair(rng.randn(B, S, KV, hd), dtype)
    jv, tv = _pair(rng.randn(B, S, KV, hd), dtype)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              q_offset=off)
    assert out.shape == (B, S - off, H, hd) and out.dtype == TDT[dtype]
    jout = flash_attention_kernel(jq, jk, jv, causal=True, window=window,
                                  q_offset=off)
    assert _err(jout, out) < TOL[dtype]
    if off == 0:
        assert _err(jax_flash_ref(jq, jk, jv, causal=True, window=window),
                    out) < TOL[dtype]
    else:
        # the JAX oracle has no q_offset: compare with its full rows
        full_q = _pair(np.concatenate([rng.randn(B, off, H, hd),
                                       np.asarray(jq, np.float32)], axis=1),
                       dtype)[0]
        jfull = jax_flash_ref(full_q, jk, jv, causal=True, window=window)
        assert _err(jfull[:, off:], out) < TOL[dtype]


# ---------------------------------------------------------------------------
# K2 fused flash decode
# ---------------------------------------------------------------------------

def _decode_inputs(seed, B, Sq, KV, G, hd, bs, P, positions, dtype):
    """Arena with trash block 0 and tables padded with 0 past each row's
    last page, as the paged layout lays them out."""
    H = KV * G
    rng = np.random.RandomState(seed)
    NB = 1 + B * P
    arrays = [rng.randn(B, Sq, H, hd), rng.randn(B, Sq, KV, hd),
              rng.randn(B, Sq, KV, hd), rng.randn(NB, bs, KV, hd),
              rng.randn(NB, bs, KV, hd)]
    tbl = np.zeros((B, P), np.int32)
    for b in range(B):
        n_pages = -(-(positions[b] + Sq) // bs)
        tbl[b, :n_pages] = 1 + b * P + np.arange(n_pages)
    pos = np.asarray(positions, np.int32)
    pairs = [_pair(a, dtype) for a in arrays]
    jax_args = [p[0] for p in pairs] + [jnp.asarray(tbl), jnp.asarray(pos)]
    torch_args = [p[1] for p in pairs] + [torch.from_numpy(tbl),
                                          torch.from_numpy(pos)]
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,G,positions", [
    (1, 1, [5, 17]), (1, 2, [0, 23]), (3, 1, [6, 13]), (3, 2, [0, 28])])
def test_fused_decode_plain_matches_jax(Sq, G, positions, dtype):
    KV, hd, bs, P = 2, 64, 8, 4
    jargs, targs = _decode_inputs(Sq * 7 + G + positions[1], 2, Sq, KV, G,
                                  hd, bs, P, positions, dtype)
    freqs = ref.rope_freqs(hd, 10_000.0)
    out = ops.fused_flash_decode(*targs, freqs)
    k_pages, v_pages = targs[3], targs[4]
    for fn in (fused_flash_decode_kernel, jax_decode_ref):
        jout, jk, jv = fn(*jargs)
        assert _err(jout, out) < TOL[dtype], fn.__name__
        # every non-trash block: the window written in place, the rest
        # untouched
        assert _err(jk[1:], k_pages[1:]) < TOL[dtype], fn.__name__
        assert _err(jv[1:], v_pages[1:]) < TOL[dtype], fn.__name__


def test_fused_decode_slot_arena_view_updates_cache():
    """The slot layout: a [B, max_len, KV, hd] cache viewed as an arena
    through slot_arena_tables is written in place at pos..pos+S'-1."""
    from repro_torch.models import paging
    B, L, KV, hd, Sq = 2, 32, 2, 64, 2
    rng = np.random.RandomState(3)
    cache_k = torch.tensor(rng.randn(B, L, KV, hd), dtype=torch.float32)
    cache_v = torch.tensor(rng.randn(B, L, KV, hd), dtype=torch.float32)
    before_k = cache_k.clone()
    q = torch.tensor(rng.randn(B, Sq, 2 * KV, hd), dtype=torch.float32)
    kn = torch.tensor(rng.randn(B, Sq, KV, hd), dtype=torch.float32)
    vn = torch.tensor(rng.randn(B, Sq, KV, hd), dtype=torch.float32)
    pos = torch.tensor([7, 20], dtype=torch.int32)
    page = paging.fused_page_size(L)
    tables = paging.slot_arena_tables(B, L, page)
    ops.fused_flash_decode(q, kn, vn, cache_k.view(-1, page, KV, hd),
                           cache_v.view(-1, page, KV, hd), tables, pos,
                           ref.rope_freqs(hd, 10_000.0))
    for b in range(B):
        p = int(pos[b])
        assert torch.equal(cache_v[b, p:p + Sq], vn[b])
        changed = (cache_k[b] != before_k[b]).any(-1).any(-1)
        assert changed.nonzero().flatten().tolist() == list(range(p, p + Sq))


# ---------------------------------------------------------------------------
# the CUDA wrappers' checks (reachable without a card)
# ---------------------------------------------------------------------------

def _wrapper_calls(x):
    """Each CUDA wrapper called with ``x`` as its first operand."""
    B, S, H, hd = 1, 4, 2, 64
    k = torch.zeros(B, S, H, hd)
    arena = torch.zeros(3, 8, H, hd)
    return [
        lambda: rmsnorm_cuda(x, torch.ones(hd)),
        lambda: flash_attention_cuda(x, k, k),
        lambda: fused_flash_decode_cuda(
            x, k, k, arena, arena, torch.zeros(B, 3, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32), torch.zeros(hd // 2)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("misuse,match", [
    ("dtype", "dtype"), ("strided", "contiguous"), ("cpu", "CUDA tensor")])
def test_cuda_wrappers_refuse_misuse(which, misuse, match):
    x = torch.zeros(1, 4, 2, 64)
    if misuse == "dtype":
        x = x.to(torch.float16)
    elif misuse == "strided":
        x = torch.zeros(1, 4, 2, 128)[..., ::2]
    before = dict(build.launches)
    with pytest.raises(ValueError, match=match):
        _wrapper_calls(x)[which]()
    assert build.launches == before


def _paged_wrapper_calls(x):
    """K5 and K4's wrappers called with ``x`` as their query."""
    B, H, hd = 1, 2, 64
    arena = torch.zeros(3, 8, H, hd)
    tables = torch.zeros(B, 3, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    kn = torch.zeros(B, 4, H, hd)
    return [
        lambda: paged_attention_cuda(x[:, 0], arena, arena, tables, pos),
        lambda: fused_flash_decode_splitk_cuda(
            x, kn, kn, arena, arena, tables, pos, torch.zeros(hd // 2)),
    ]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("misuse,match", [
    ("dtype", "dtype"), ("strided", "contiguous"), ("cpu", "CUDA tensor")])
def test_paged_wrappers_refuse_misuse(which, misuse, match):
    """K5 and K4 refuse a float16, a strided and a CPU operand before
    any launch is counted."""
    x = torch.zeros(1, 4, 2, 64)
    if misuse == "dtype":
        x = x.to(torch.float16)
    elif misuse == "strided":
        x = torch.zeros(1, 4, 2, 128)[..., ::2]
    before = dict(build.launches)
    with pytest.raises(ValueError, match=match):
        _paged_wrapper_calls(x)[which]()
    assert build.launches == before


def test_flash_wrapper_checks_operands_before_head_dim():
    """A CPU bf16 query of head_dim 72 (no bf16 kernel instance) is
    refused for lying on the CPU: the operand checks come first."""
    q = torch.zeros(1, 4, 2, 72, dtype=torch.bfloat16)
    before = dict(build.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q)
    assert build.launches == before


@pytest.mark.parametrize("kernel,hd", [
    ("flash_attention", 72), ("paged_attention", 72),
    ("paged_attention", 176), ("fused_flash_decode", 72),
    ("fused_flash_decode", 176), ("fused_flash_decode_splitk", 72),
    ("fused_flash_decode_splitk", 176)])
def test_bf16_head_dims_outside_the_instances_refused(monkeypatch, kernel,
                                                      hd):
    """With the operand checks passed (stubbed here, as no CUDA tensor
    exists on the CPU), a bf16 head_dim that no kernel instance covers
    raises ValueError before the library is touched or a launch
    counted; f32 at the same head_dim passes this check."""
    monkeypatch.setattr(build, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(build, "lib", lambda: pytest.fail("reached the "
                                                          "kernel library"))
    before = dict(build.launches)
    for dt in (torch.bfloat16, torch.float32):
        if kernel == "flash_attention":
            q = torch.zeros(1, 4, 2, hd, dtype=dt)
            call = lambda: flash_attention_cuda(q, q, q)  # noqa: E731
        elif kernel.startswith("fused_flash_decode"):
            fn = (fused_flash_decode_splitk_cuda if kernel.endswith("splitk")
                  else fused_flash_decode_cuda)
            q = torch.zeros(1, 2, 2, hd, dtype=dt)
            arena = torch.zeros(3, 8, 2, hd, dtype=dt)
            call = lambda: fn(  # noqa: E731
                q, q, q, arena, arena, torch.zeros(1, 3, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32), torch.zeros(hd // 2))
        else:
            q = torch.zeros(1, 2, hd, dtype=dt)
            arena = torch.zeros(3, 8, 2, hd, dtype=dt)
            call = lambda: paged_attention_cuda(  # noqa: E731
                q, arena, arena, torch.zeros(1, 3, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32))
        if dt == torch.bfloat16:
            with pytest.raises(ValueError, match="multiple of 16"):
                call()
        else:
            with pytest.raises(pytest.fail.Exception):
                call()
    assert build.launches == before
