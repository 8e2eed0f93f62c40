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
"""
from __future__ import annotations

import torch

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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    no_backward("rmsnorm", x, scale)
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps=eps)
    return rmsnorm_ref(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    no_backward("flash_attention", q, k, v)
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
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                    positions)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, positions)
