"""The port's paged KV layout (repro_torch) against the JAX package's, on
the CPU at reduced f32 sizes and the same numpy-seeded inputs/weights:
the block-table helpers, K5's plain version (paged attention) and K4's
(split-K fused decode, the plain version K2 shares) against the JAX
Pallas kernels in interpret mode and the JAX oracles, and the engine's
paged decode / verify / extend against the JAX engine's paged layout —
tokens equal, arenas at the f32 floor (``assert_cache_close``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import fused_flash_decode_kernel  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_kernel)
from repro.kernels.ref import (  # noqa: E402
    paged_attention_ref as jax_paged_ref)
from repro.models import paging as jax_paging  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import paging  # noqa: E402
from repro_torch.models.transformer import RuntimeFlags  # noqa: E402
from repro_torch.serving import LLMEngine  # noqa: E402
from test_torch_engine import (MAX_LEN, Pair,  # noqa: E402,F401
                               assert_cache_close, one_torch_thread)
from test_torch_kernels import TOL, _decode_inputs, _err  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the block-table seam
# ---------------------------------------------------------------------------

def test_paging_helpers_match_jax():
    rng = np.random.RandomState(0)
    NB, bs, KV, hd, B, P = 9, 4, 2, 8, 3, 4
    arena = rng.randn(NB, bs, KV, hd).astype(np.float32)
    tables = np.array([[3, 5, 0, 0], [1, 2, 7, 8], [0, 0, 0, 0]], np.int32)
    pos = np.array([6, 13, 2], np.int32)
    win = pos[:, None] + np.arange(3)[None, :]
    for p in (pos, win):
        jb, jo = jax_paging.tail_refs(jnp.asarray(tables), jnp.asarray(p), bs)
        tb, to = paging.tail_refs(_t(tables), _t(p), bs)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # scatter one token per row (rows 0 and 1 only: row 2 is inactive and
    # writes the trash block, whose content is unspecified)
    new = rng.randn(B, KV, hd).astype(np.float32)
    jb, jo = jax_paging.tail_refs(jnp.asarray(tables), jnp.asarray(pos), bs)
    want = np.asarray(jax_paging.scatter_token(jnp.asarray(arena), jb, jo,
                                               jnp.asarray(new)))
    got = torch.from_numpy(arena.copy())
    tb, to = paging.tail_refs(_t(tables), _t(pos), bs)
    assert paging.scatter_token(got, tb, to, _t(new)) is got
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(
        paging.gather_pages(_t(arena), _t(tables)).numpy(),
        np.asarray(jax_paging.gather_pages(jnp.asarray(arena),
                                           jnp.asarray(tables))))
    np.testing.assert_array_equal(
        paging.valid_mask(P * bs, _t(pos)).numpy(),
        np.asarray(jax_paging.valid_mask(P * bs, jnp.asarray(pos))))
    np.testing.assert_array_equal(
        paging.slot_arena_tables(3, 32, 8).numpy(),
        np.asarray(jax_paging.slot_arena_tables(3, 32, 8)))
    cache = {"k": arena, "v": arena[::-1].copy()}
    slots = rng.randn(4, 16, KV, hd).astype(np.float32)
    for jref, tref, leaves, n in (
            (jax_paging.PagedPrefix(jnp.asarray(tables[:2]), bs),
             paging.PagedPrefix(_t(tables[:2]), bs), cache, 8),
            (jax_paging.SlotPrefix(jnp.asarray([2, 0])),
             paging.SlotPrefix(torch.tensor([2, 0])),
             {"k": slots, "v": slots * 2}, 11)):
        want = jax_paging.gather_prefix_kv(
            {k: jnp.asarray(a) for k, a in leaves.items()}, jref, n)
        got = paging.gather_prefix_kv({k: _t(a) for k, a in leaves.items()},
                                      tref, n)
        for k in ("k", "v"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# K5 paged attention and K4 split-K fused decode, plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,hd,NB,bs,P", [
    (3, 8, 2, 16, 10, 4, 5), (2, 4, 4, 32, 6, 8, 3), (2, 4, 2, 96, 8, 4, 3),
    (4, 36, 36, 64, 12, 16, 4)])
def test_paged_attention_plain_matches_jax(B, H, KV, hd, NB, bs, P):
    rng = np.random.RandomState(B + H + hd)
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(NB, bs, KV, hd).astype(np.float32)
    v = rng.randn(NB, bs, KV, hd).astype(np.float32)
    tbl = rng.randint(1, NB, size=(B, P)).astype(np.int32)
    pos = rng.randint(0, P * bs, size=B).astype(np.int32)
    out = ops.paged_attention(_t(q), _t(k), _t(v), _t(tbl), _t(pos))
    assert out.shape == (B, H, hd) and out.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (q, k, v, tbl, pos)]
    for fn in (lambda *a: paged_attention_kernel(*a, interpret=True),
               jax_paged_ref):
        assert _err(fn(*jargs), out) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,G,positions", [
    (1, 1, [5, 17]), (1, 2, [0, 23]), (3, 1, [6, 13]), (5, 2, [0, 26])])
def test_splitk_plain_matches_jax_splitk_kernel(Sq, G, positions, dtype):
    KV, hd, bs, P = 2, 64, 8, 4
    jargs, targs = _decode_inputs(Sq * 11 + G + positions[1], 2, Sq, KV, G,
                                  hd, bs, P, positions, dtype)
    out = ops.fused_flash_decode(*targs, ref.rope_freqs(hd, 10_000.0),
                                 split_k=True)
    jout, jk, jv = fused_flash_decode_kernel(*jargs, split_k=True,
                                             interpret=True)
    assert _err(jout, out) < TOL[dtype]
    assert _err(jk[1:], targs[3][1:]) < TOL[dtype]
    assert _err(jv[1:], targs[4][1:]) < TOL[dtype]


def test_splitk_op_is_the_fused_op_on_cpu():
    """K4 computes K2's function: on a CPU tensor both run the one plain
    version, bitwise."""
    _, targs = _decode_inputs(3, 2, 3, 2, 2, 64, 8, 4, [4, 19], "float32")
    freqs = ref.rope_freqs(64, 10_000.0)
    a = [t.clone() for t in targs]
    out2 = ops.fused_flash_decode(*targs, freqs)
    out4 = ops.fused_flash_decode(*a, freqs, split_k=True)
    assert torch.equal(out2, out4)
    assert torch.equal(targs[3], a[3]) and torch.equal(targs[4], a[4])


# ---------------------------------------------------------------------------
# the engine's paged layout against the JAX engine's
# ---------------------------------------------------------------------------

BS = 8
PAGES = MAX_LEN // BS


@pytest.fixture(scope="module", params=["minicpm", "qwen3"])
def pair(request):
    return Pair(request.param)


def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _serve_paged(engine, cfg, log):
    """prefill -> insert (page scatter) -> prefix-shared extend -> decode
    (slot 3 inactive half the time, its table zeroed as the backend
    does) -> verify, on a 4-slot paged arena; returns the arena."""
    backend = types.SimpleNamespace(kind="paged", num_slots=4,
                                    num_blocks=1 + 4 * PAGES, block_size=BS)
    cache = engine.new_cache(backend)
    tables = 1 + np.arange(4 * PAGES, dtype=np.int32).reshape(4, PAGES)
    last = np.zeros(4, np.int32)
    pos = np.zeros(4, np.int32)
    groups = [_prompts(cfg, 2, 10, 10), _prompts(cfg, 1, 14, 11)]
    for g, toks in enumerate(groups):
        first, rows = engine.prefill(toks)
        for r in range(toks.shape[0]):
            slot = 2 * g + r
            n = -(-toks.shape[1] // BS)
            page_ids = np.zeros(PAGES, np.int32)
            page_ids[:n] = tables[slot, :n]
            cache = engine.insert(backend, cache, rows, r, page_ids)
            last[slot], pos[slot] = first[r], toks.shape[1]
    # slot 3 shares slot 2's first block and extends its own suffix
    prompt3 = np.concatenate([groups[1][0, :BS], _prompts(cfg, 1, 9, 12)[0]])
    tables[3, 0] = tables[2, 0]
    page_ids = np.zeros(PAGES, np.int32)
    page_ids[:2] = tables[3, 1:3]
    first, cache = engine.extend(backend, cache, prompt3[BS:], BS,
                                 (tables[3], page_ids))
    last[3], pos[3] = first[0], prompt3.size
    log.append(("prefill+extend", last.copy()))
    for t in range(6):
        active = np.array([True, True, True, t % 2 == 0])
        tbl = np.where(active[:, None], tables, 0).astype(np.int32)
        tok, cache = engine.decode(backend, cache, last, pos, active,
                                   block_tables=tbl)
        log.append(("decode", tok))
        last = np.where(active, tok, last)
        pos = pos + active
    window = np.concatenate([last[:, None], _prompts(cfg, 4, 2, 7)], axis=1)
    guess, cache = engine.verify(backend, cache, window, pos,
                                 np.ones(4, bool), block_tables=tables)
    log.append(("verify", guess))
    return cache


def _arena(cache, to_numpy):
    """The arena without trash block 0 (its content is unspecified)."""
    return jax.tree.map(lambda a: to_numpy(a)[:, 1:], cache)


@pytest.mark.parametrize("flags", ["fused", "paged_kernel"])
def test_paged_serving_sequence_matches_jax(pair, flags):
    port = pair.port
    if flags == "paged_kernel":
        port = LLMEngine(pair.cfg, dict(port.model.named_parameters()),
                         max_len=MAX_LEN, device="cpu",
                         flags=RuntimeFlags(use_fused_decode=False,
                                            use_paged_kernel=True))
    jlog, tlog, xlog = [], [], []
    jcache = _serve_paged(pair.jax, pair.jcfg, jlog)
    tcache = _serve_paged(port, pair.cfg, tlog)
    xcache = _serve_paged(pair.exact, pair.cfg, xlog)
    assert [k for k, _ in jlog] == [k for k, _ in tlog]
    for (kind, want), (_, got) in zip(jlog, tlog):
        if not np.array_equal(want, got):
            pytest.fail(f"{kind}: port tokens {got} != JAX tokens {want}")
    assert_cache_close(_arena(jcache, np.asarray),
                       _arena(tcache, lambda t: t),
                       _arena(xcache, lambda t: t))
