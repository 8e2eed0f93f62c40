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

NEG_INF = -1e30


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation dtype: f32, or f64 for an f64 input."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * upcast(scale)).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd]; GQA by head grouping.  Query row
    ``s`` sits at absolute position ``q_offset + s`` for the masks, as
    in the flash kernel."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = upcast(q.reshape(B, S, KV, G, hd))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, upcast(k)) \
        / torch.sqrt(torch.tensor(float(hd)))
    i = q_offset + torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    m = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (j <= i)
    if window:
        m = m & (j > i - window)
    scores = torch.where(m, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, upcast(v))
    return out.reshape(B, S, H, hd).to(q.dtype)


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
    P = block_tables.shape[1]
    G = H // KV
    T = P * bs
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=dev))
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
    qg = q_r.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bskgd,btkd->bksgt", qg, k) * scale   # [B,KV,S',G,T]
    idx = torch.arange(T, device=dev)
    valid = idx[None, None, :] <= pos_s[:, :, None]        # [B, S', T]
    s = torch.where(valid[:, None, :, None, :], s,
                    torch.tensor(NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bksgt,btkd->bskgd", p, v) \
        / p.sum(dim=-1).permute(0, 2, 1, 3)[..., None]
    return o.reshape(B, Sq, H, hd).to(q.dtype)
