"""Dispatch for the port's kernels — the counterpart of the JAX
package's ``kernels/ops.py`` and its ``INTERPRET`` switch.

Each op looks at where its tensor lies: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the CUDA kernel, which raises if
it cannot build or launch.  Nothing falls back from the kernel to the
plain version.  ``launches`` counts the kernel launches by name.

The kernels have no backward, as the JAX package's Pallas kernels have
none, so every op refuses, on every device, to run where autograd would
record it (:func:`no_backward`): a kernel's output would carry no
``grad_fn`` and the weights before it would silently get no gradient.
Training runs the plain path (``use_flash=False``,
``fused_rmsnorm=False``).

On ``meta`` operands (the cost analysis, ``launch/op_cost.py``) each op
runs neither: it records itself with the active counter as one fused
op, with the kernel's analytic bytes and operations (:func:`priced`),
and returns an empty output of its shape.  That is the counterpart of a
Pallas custom call in JAX's HLO.  The bytes read each operand and write
each output once; an attention kernel reads only the keys its queries
see, and counts 4 x head_dim operations per (query row, visible key,
head).  Where that depends on the data (a decode row's position), a
host tensor of positions gives the call's count; ``meta`` positions
count every key the row's block table addresses, the most the call can
read.
"""
from __future__ import annotations

import torch

from ..launch import op_cost
from .build import launches
from .flash_attention import flash_attention_cuda, flash_attention_ref
from .flash_decode import (fused_flash_decode_cuda, fused_flash_decode_ref,
                           fused_flash_decode_splitk_cuda)
from .paged_attention import paged_attention_cuda, paged_attention_ref
from .rmsnorm import rmsnorm_cuda, rmsnorm_ref

__all__ = ["launches", "rmsnorm", "flash_attention", "fused_flash_decode",
           "paged_attention", "no_backward"]


def no_backward(op: str, *operands: torch.Tensor) -> None:
    """Raise where autograd would record ``op``: grad mode is on and an
    operand requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{op}: the port's kernels have no backward, as the JAX "
            f"package's Pallas kernels have none; train on the plain path "
            f"(RuntimeFlags(use_flash=False, fused_rmsnorm=False)) or call "
            f"the op under torch.no_grad()")


def priced(name: str, out: torch.Tensor, moved: float, flops: float,
           peak: str = "bf16") -> torch.Tensor:
    """Record kernel ``name``'s call on ``meta`` operands with the active
    counter (``op_cost.record_kernel``) and return its empty output."""
    op_cost.record_kernel(name, moved, flops, peak)
    return out


def visible_pairs(S: int, T: int, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> int:
    """The keys S query rows see in all: query ``s`` at ``q_offset + s``
    sees keys ``max(0, at - window + 1) .. at`` causally (``T`` keys
    otherwise, ``window`` of them at most)."""
    if not causal:
        return S * (min(T, window) if window else T)
    lo, hi = q_offset + 1, q_offset + S          # keys at s = 0 .. S - 1
    if not window or window >= hi:
        return (lo + hi) * S // 2
    if window <= lo:
        return window * S
    ramp = window - lo                             # rows below the window
    return (lo + window - 1) * ramp // 2 + window * (S - ramp)


def _keys(positions: torch.Tensor, T: int, Sq: int) -> list:
    """Each row's keys seen by its first query, that query's own
    included: ``positions + 1`` from a host tensor, else every key the
    row addresses but the window's later ones."""
    if positions.is_meta:
        return [T - Sq + 1] * positions.shape[0]
    return [int(p) + 1 for p in positions.tolist()]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    no_backward("rmsnorm", x, scale)
    if x.is_meta:
        return priced("rmsnorm", torch.empty_like(x),
                      2 * op_cost.nbytes(x) + op_cost.nbytes(scale),
                      4 * x.numel(), "f32")
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps=eps)
    return rmsnorm_ref(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    no_backward("flash_attention", q, k, v)
    if q.is_meta:
        B, S, H, hd = q.shape
        pairs = B * H * visible_pairs(S, k.shape[1], causal=causal,
                                      window=window, q_offset=q_offset)
        return priced("flash_attention", torch.empty_like(q),
                      2 * op_cost.nbytes(q) + op_cost.nbytes(k)
                      + op_cost.nbytes(v), 4 * hd * pairs)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def fused_flash_decode(q, k_new, v_new, k_pages, v_pages, block_tables,
                       positions, freqs, *, split_k: bool = False
                       ) -> torch.Tensor:
    """One-call fused decode/verify attention: RoPE + tail-block scatter
    (in place into ``k_pages``/``v_pages``) + per-query-masked attention
    over the arena.  ``split_k`` picks K4 over K2 on the card; both
    compute the same function, so the CPU runs one plain version.
    Returns the attention output."""
    no_backward("fused_flash_decode", q, k_new, v_new, k_pages, v_pages)
    if q.is_meta:
        B, Sq, H, hd = q.shape
        KV, es = k_pages.shape[2], k_pages.element_size()
        keys = _keys(positions, block_tables.shape[1] * k_pages.shape[1], Sq)
        kv = 2 * sum(n + Sq - 1 for n in keys) * KV * hd * es
        io = 2 * (op_cost.nbytes(q) + op_cost.nbytes(k_new)) + \
            op_cost.nbytes(block_tables) + op_cost.nbytes(positions)
        flops = 4 * hd * H * sum(n + s for n in keys for s in range(Sq))
        return priced("fused_flash_decode_splitk" if split_k
                      else "fused_flash_decode", torch.empty_like(q),
                      kv + io, flops)
    if q.is_cuda:
        kernel = fused_flash_decode_splitk_cuda if split_k \
            else fused_flash_decode_cuda
        return kernel(q, k_new, v_new, k_pages, v_pages, block_tables,
                      positions, freqs)
    return fused_flash_decode_ref(q, k_new, v_new, k_pages, v_pages,
                                  block_tables, positions, freqs)


def paged_attention(q, k_pages, v_pages, block_tables,
                    positions) -> torch.Tensor:
    """Single-query paged decode attention through block tables (K5):
    q [B, H, hd] rotated, the new token already in the arena."""
    no_backward("paged_attention", q, k_pages, v_pages)
    if q.is_meta:
        B, H, hd = q.shape
        KV, es = k_pages.shape[2], k_pages.element_size()
        keys = _keys(positions, block_tables.shape[1] * k_pages.shape[1], 1)
        kv = 2 * sum(keys) * KV * hd * es
        io = 2 * op_cost.nbytes(q) + op_cost.nbytes(block_tables) + \
            op_cost.nbytes(positions)
        return priced("paged_attention", torch.empty_like(q), kv + io,
                      4 * hd * H * sum(keys))
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                    positions)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, positions)
