"""Blockwise online-softmax attention in plain PyTorch: the port of the
JAX package's ``models/chunked_attention.py`` (the single-device path).

MLA's prefill and extend attend with it: their per-head keys carry
``qk_nope + qk_rope`` dims and their values ``v_head_dim`` (192 against
128 at deepseek_v3's width), which neither K3 nor its plain version
(``kernels/ref.py::flash_attention_ref``, K3's alone) takes.  So do an
encoder-decoder's bidirectional encoder and its decoder's cross
attention (``causal=False``).  The JAX package computes all three
outside any Pallas kernel too.

The port's row rules hold here as in K3's plain version: keys go in
blocks of ``kv_chunk`` at absolute multiples of it (the last padded with
masked zeros), so a query row's arithmetic depends on its absolute
position alone, never on ``T``, ``q_offset`` or the number of query
rows; a suffix's rows at ``q_offset`` are bitwise the full prefill's.
A single query row is multiplied as two (``two_rows``).  On a
tensor-parallel rank (``layers.rows_padded``) the batch's rows attend
one at a time (``layers.each_row``): at one rank's heads the card's
batched products round a row apart by the batch beside it.

On a training mesh ``sequence_parallel_attention`` runs the JAX
function's two strategies, by heads or by query rows (:func:`sp_arm`),
for GQA attention (``attention.mesh_attention``) and MLA
(``mla.mesh_forward``).
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ..kernels.ref import NEG_INF, heads_major, keys_t, two_rows, upcast, \
    values
from .layers import each_row, products_padded

#: keys per block: K3's absolute key block
KV_CHUNK = 128


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0,
                      kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """q: [B, S, H, hd]; k: [B, T, KV, hd]; v: [B, T, KV, vd] with
    ``H % KV == 0``; returns [B, S, H, vd] in q's dtype.  Query row ``s``
    sits at absolute position ``q_offset + s``; the scale is
    ``1/sqrt(hd)``.  Computes in f32 (f64 for f64 inputs); blocks past
    the last query's position are skipped under ``causal``."""
    if q.shape[0] > 1 and products_padded():
        return each_row(lambda a, b, c: chunked_attention(
            a, b, c, causal=causal, window=window, q_offset=q_offset,
            kv_chunk=kv_chunk), q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    dev = q.device
    Sp = 2 if S == 1 else S
    qb = heads_major(upcast(two_rows(q, 1)).reshape(B, Sp, KV, G, hd))
    kf, vf = upcast(k), upcast(v)
    ft = kf.dtype
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=ft))
    i = q_offset + torch.arange(Sp, device=dev)[:, None]
    m = torch.full((B, KV, G, Sp), NEG_INF, dtype=ft, device=dev)
    l = torch.zeros((B, KV, G, Sp), dtype=ft, device=dev)
    acc = torch.zeros((B, KV, G, Sp, vd), dtype=ft, device=dev)
    last = min(T, q_offset + S) if causal else T
    for k0 in range(0, last, kv_chunk):
        kb, vb = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
        if kb.shape[1] < kv_chunk:
            pad = (0, 0, 0, 0, 0, kv_chunk - kb.shape[1])
            kb, vb = F.pad(kb, pad), F.pad(vb, pad)
        s = (torch.bmm(qb, keys_t(kb)) * scale).view(B, KV, G, Sp, kv_chunk)
        j = k0 + torch.arange(kv_chunk, device=dev)[None, :]
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
        pv = torch.bmm(p.reshape(B * KV, G * Sp, kv_chunk), values(vb))
        acc = acc * corr[..., None] + pv.view(B, KV, G, Sp, vd)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(
        0, 3, 1, 2, 4)[:, :S]
    return out.reshape(B, S, H, vd).to(q.dtype)


def sp_arm(H: int, KV: int, S: int, mp: int) -> str:
    """The strategy of the JAX ``sequence_parallel_attention`` for ``H``
    query heads over ``KV`` kv heads and ``S`` query rows on a model axis
    of ``mp``: ``"heads"`` where the heads divide it (each rank its own
    query and kv heads, no attention collective), else ``"seq"`` where
    the rows do (each rank its ``S/mp`` query rows against the whole
    K/V), else ``"whole"`` (plain ``chunked_attention``)."""
    if mp > 1 and H % mp == 0 and KV % mp == 0 \
            and (H // mp) % (KV // mp) == 0:
        return "heads"
    if mp <= 1 or S % mp != 0:
        return "whole"
    return "seq"


#: the arm of every call of :func:`sequence_parallel_attention` in this
#: process (a reading for the tests)
ARMS: collections.Counter = collections.Counter()


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                window: int, flags, arm: str = "whole"
                                ) -> torch.Tensor:
    """The JAX package's model-axis-parallel attention on a training rank
    (``flags.train``, its group): the body of each of its two
    ``shard_map`` strategies, on what the rank holds on ``arm``
    (:func:`sp_arm` of the whole shapes, which ``attention.mesh_attention``
    lays the rank's q/k/v out for).

    * ``"heads"``: q [B, S, H/mp, hd] and k/v [B, T, KV/mp, hd], the
      rank's heads; their attention, as without a mesh.
    * ``"seq"``: q [B, S/mp, H, hd], the rank's query rows, against the
      whole k/v [B, T, KV, hd], at ``q_offset = index * S/mp`` (the
      causal mask and the window shifted to match; the keys in their
      blocks at absolute multiples, so a row's arithmetic is the whole
      call's).
    * ``"whole"`` (or no training group): ``chunked_attention`` of the
      whole.

    Returns the rank's rows or heads of the output."""
    ARMS[arm] += 1
    off = 0
    if arm == "seq" and flags is not None and flags.train is not None:
        off = flags.train.model.index * q.shape[1]
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
