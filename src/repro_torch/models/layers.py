"""Shared layers: the one matrix product, RMSNorm, RoPE, SwiGLU MLP,
embeddings.  Plain functions on tensors, in the JAX package's layouts."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import rmsnorm_ref, rotate, two_rows, upcast
from ..kernels.ref import rope_freqs as rope_frequencies
from .params import ParamSpec, Template


# ---------------------------------------------------------------------------
# the matrix product
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and a 2-D weight w [K, N]: every matrix
    product of the model goes through here, so the width rule lives in
    one place.

    Serving holds a row's tokens bitwise equal whether it decodes alone
    (``generate``, one row) or in a continuous batch (one row per slot),
    so a row's product must not depend on how many rows it travels with.
    On the CPU, rows of a product of two or more rows do not, but a
    single row takes another path and rounds differently: a single row
    is multiplied as two (a copy) and the first kept.  On the card the
    product runs as it is (``chip_smoke.py`` phase ``gemm_width`` reads
    cuBLAS's behaviour; ROADMAP Hazard 4)."""
    K, N = w.shape
    rows = x.reshape(-1, K)
    if rows.shape[0] == 1 and x.device.type == "cpu":
        y = (two_rows(rows, 0) @ w)[:1]
    else:
        y = rows @ w
    return y.view(*x.shape[:-1], N)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_template(d: int) -> Template:
    return {"scale": ParamSpec((d,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5,
             use_kernel: bool = False) -> torch.Tensor:
    """``use_kernel`` routes through the fused RMSNorm op (the CUDA
    kernel on a CUDA tensor); otherwise the plain version runs."""
    if use_kernel:
        return ops.rmsnorm(x, params["scale"], eps=eps)
    return rmsnorm_ref(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, heads, head_dim]; positions: [B, S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    return rotate(x, positions, freqs).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_template(d: int, d_ff: int) -> Template:
    return {
        "w_gate": ParamSpec((d, d_ff)),
        "w_up": ParamSpec((d, d_ff)),
        "w_down": ParamSpec((d_ff, d)),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, params["w_gate"])
    u = linear(x, params["w_up"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    return linear(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embed_template(vocab: int, d: int) -> Template:
    return {"embedding": ParamSpec((vocab, d), init="scaled", scale=0.02)}


def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embedding"][tokens].to(dtype)


def lm_head_template(d: int, vocab: int) -> Template:
    return {"w": ParamSpec((d, vocab))}


def lm_head_apply(params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params["w"])
