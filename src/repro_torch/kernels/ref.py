"""Plain PyTorch versions of the kernels: ports of the JAX package's
``kernels/ref.py`` oracles.

They are what a CPU tensor runs, what a layer runs when its kernel flag
is turned off, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.  Each follows the JAX oracle's op sequence
(explicit max/exp/sum softmax in f32, the same scale expressions).
They compute in f32, or in f64 for f64 inputs: an f64 run of the plain
path is the tests' exact reference for the f32 floor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation dtype: f32, or f64 for an f64 input."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * upcast(scale)).to(x.dtype)


#: keys per block of the plain flash attention: K3's absolute k-block
KEY_BLOCK = 128


def two_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with a size-1 ``dim`` doubled by a copy of its row.  A CPU
    matrix product of one row takes another path than one of several
    and rounds differently, while rows of products of two or more rows
    do not depend on the row count: callers multiply two rows and keep
    the first, so a row's bits never depend on how many rows it
    travels with."""
    return torch.cat([x, x], dim) if x.shape[dim] == 1 else x


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd]; GQA by head grouping.  Query row
    ``s`` sits at absolute position ``q_offset + s`` for the masks, as
    in the flash kernel.

    The softmax runs online over keys in blocks of ``KEY_BLOCK`` fixed
    at absolute multiples of 128 (the last padded with masked zeros), as
    K3 does: a row's arithmetic then depends on its absolute position
    only, never on ``T``, ``q_offset`` or the number of query rows, so
    the suffix rows of a ``q_offset`` call are bitwise equal to the same
    rows of the full prefill.  A block fully masked for a row adds exact
    zeros (``exp(NEG_INF - m) == 0``, rescale by ``exp(0) == 1``), and
    blocks past the last query are skipped."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    Sp = 2 if S == 1 else S
    qb = heads_major(upcast(two_rows(q, 1)).reshape(B, Sp, KV, G, hd))
    kf, vf = upcast(k), upcast(v)
    ft = kf.dtype
    i = q_offset + torch.arange(Sp, device=dev)[:, None]
    m = torch.full((B, KV, G, Sp), NEG_INF, dtype=ft, device=dev)
    l = torch.zeros((B, KV, G, Sp), dtype=ft, device=dev)
    acc = torch.zeros((B, KV, G, Sp, hd), dtype=ft, device=dev)
    sq = torch.sqrt(torch.tensor(float(hd), dtype=ft))
    last = min(T, q_offset + S) if causal else T
    for k0 in range(0, last, KEY_BLOCK):
        kb, vb = kf[:, k0:k0 + KEY_BLOCK], vf[:, k0:k0 + KEY_BLOCK]
        if kb.shape[1] < KEY_BLOCK:
            pad = (0, 0, 0, 0, 0, KEY_BLOCK - kb.shape[1])
            kb, vb = F.pad(kb, pad), F.pad(vb, pad)
        s = (torch.bmm(qb, keys_t(kb)) / sq).view(B, KV, G, Sp, KEY_BLOCK)
        j = k0 + torch.arange(KEY_BLOCK, device=dev)[None, :]
        valid = j < T
        if causal:
            valid = valid & (j <= i)
        if window:
            valid = valid & (j > i - window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.bmm(p.reshape(B * KV, G * Sp, KEY_BLOCK), values(vb))
        acc = acc * corr[..., None] + pv.view(B, KV, G, Sp, hd)
        m = m_new
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)[:, :S]
    return out.reshape(B, S, H, hd).to(q.dtype)


def heads_major(qg: torch.Tensor) -> torch.Tensor:
    """[B, S, KV, G, hd] queries as the ``[B*KV, G*S, hd]`` left operand
    of a batched product, one matrix per (row, kv head)."""
    B, S, KV, G, hd = qg.shape
    return qg.permute(0, 2, 3, 1, 4).reshape(B * KV, G * S, hd).contiguous()


def keys_t(k: torch.Tensor) -> torch.Tensor:
    """[B, T, KV, hd] keys as the ``[B*KV, hd, T]`` right operand."""
    B, T, KV, hd = k.shape
    return k.permute(0, 2, 3, 1).reshape(B * KV, hd, T).contiguous()


def values(v: torch.Tensor) -> torch.Tensor:
    """[B, T, KV, hd] values as the ``[B*KV, T, hd]`` right operand."""
    B, T, KV, hd = v.shape
    return v.permute(0, 2, 1, 3).reshape(B * KV, T, hd).contiguous()


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """[hd/2] f32 inverse rotary frequencies — the
    ``models.layers.rope_frequencies`` expression, computed once outside
    the fused kernel and passed in as an operand."""
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rotate(x: torch.Tensor, positions: torch.Tensor,
           freqs: torch.Tensor) -> torch.Tensor:
    """The ``models.layers.apply_rope`` f32 expression.  x: [B, S, n, hd]
    (any float dtype); positions: [B, S] int; returns f32 (f64 for an
    f64 ``x``)."""
    x = upcast(x)
    angles = positions[..., None].to(x.dtype) * freqs.to(x.dtype)
    cos = torch.cos(angles)[..., None, :]                  # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def fused_flash_decode_ref(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, freqs: torch.Tensor
                           ) -> torch.Tensor:
    """Fused decode/verify-window attention, plain PyTorch.

    Per row ``b`` holding ``positions[b]`` tokens:

    1. rotate q and k_new at absolute positions ``pos .. pos + S' - 1``
       (``rotate``, frequencies ``freqs`` from :func:`rope_freqs`);
    2. write the rotated k_new and v_new, rounded to the arena dtype,
       into the row's tail block(s) (``block_tables[b, g // bs]`` at
       offset ``g % bs``) — **in place**, as the kernel does (the JAX
       kernel's aliased outputs); window positions at or past
       ``P * bs`` are not written;
    3. attend each query ``s`` over the pages gathered in position
       order, masked to ``idx <= pos + s``, with a fully gathered f32
       softmax.

    q: [B, S', H, hd]; k_new/v_new: [B, S', KV, hd] un-rotated;
    k_pages/v_pages: [NB, bs, KV, hd]; block_tables: [B, P] int32;
    positions: [B] int32.  Block 0 is the trash block: rows whose window
    resolves to it get unspecified output.  Returns ``out [B, S', H, hd]``.
    """
    B, Sq, H, hd = q.shape
    bs, KV = k_pages.shape[1], k_pages.shape[2]
    T = block_tables.shape[1] * bs
    dev = q.device
    tables = block_tables.long()
    pos_s = positions.long()[:, None] + torch.arange(Sq, device=dev)
    q_r = rotate(q, pos_s, freqs)                          # f32 (f64)
    k_r = rotate(k_new, pos_s, freqs).to(k_pages.dtype)
    v_c = v_new.to(v_pages.dtype)

    keep = pos_s < T
    g = pos_s.clamp(max=T - 1)
    blk = torch.gather(tables, 1, g // bs)[keep]
    off = (g % bs)[keep]
    k_pages[blk, off] = k_r[keep]
    v_pages[blk, off] = v_c[keep]

    k = upcast(k_pages[tables].reshape(B, T, KV, hd))
    v = upcast(v_pages[tables].reshape(B, T, KV, hd))
    return gathered_attention(q_r, k, v, pos_s).to(q.dtype)


def gathered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos_s: torch.Tensor) -> torch.Tensor:
    """The decode attention of the plain versions, in the accumulation
    dtype: query ``s`` of row ``b`` over the row's position-ordered keys
    ``idx <= pos_s[b, s]``, one fully gathered softmax (scores, max,
    exp, sum, weighted sum).  q: [B, S', H, hd] (rotated); k, v:
    [B, T, KV, hd]; pos_s: [B, S'].  With one query row per kv head
    the products run on two (``two_rows``), so decode and verify give a
    query the same bits.  Returns [B, S', H, hd] unrounded."""
    B, Sq, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    one = Sq * G == 1
    qf = upcast(two_rows(q, 1) if one else q)
    pos_s = two_rows(pos_s, 1) if one else pos_s
    Sp = qf.shape[1]
    # a host scalar: a tensor made on the card from a host value would
    # wait for the card
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=k.dtype))
    qb = heads_major(qf.to(k.dtype).reshape(B, Sp, KV, G, hd))
    s = (torch.bmm(qb, keys_t(k)) * scale).view(B, KV, G, Sp, T)
    idx = torch.arange(T, device=dev)
    valid = idx[None, None, :] <= pos_s.long()[:, :, None]  # [B, S', T]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.bmm(p.reshape(B * KV, G * Sp, T), values(v)).view(
        B, KV, G, Sp, hd) / p.sum(dim=-1)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sp, H, hd)[:, :Sq]


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """Paged single-query decode attention, plain PyTorch: the JAX
    ``paged_attention_ref``.

    q: [B, H, hd] (rotated); k_pages/v_pages: [NB, bs, KV, hd];
    block_tables: [B, P] int32, position-ordered, padded with the trash
    block 0 past the row's pages; positions: [B] int32.  Query ``b``
    attends keys ``idx <= positions[b]`` of its row, gathered through
    its table, with an f32 softmax.  Masking is by position alone: a
    row's table holds block 0 only past its last page, so block 0 is
    read only by rows whose table is all zero (inactive slots), whose
    output is finite but unspecified.  Returns [B, H, hd]."""
    B, H, hd = q.shape
    bs, KV = k_pages.shape[1], k_pages.shape[2]
    T = block_tables.shape[1] * bs
    tables = block_tables.long()
    k = upcast(k_pages[tables].reshape(B, T, KV, hd))
    v = upcast(v_pages[tables].reshape(B, T, KV, hd))
    return gathered_attention(q[:, None], k, v,
                              positions.long()[:, None])[:, 0].to(q.dtype)
