"""Shared layers: the one matrix product, RMSNorm, RoPE, SwiGLU MLP,
embeddings.  Plain functions on tensors, in the JAX package's layouts."""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.ref import rmsnorm_ref, rotate, two_rows, upcast
from ..kernels.ref import rope_freqs as rope_frequencies
from .params import ParamSpec, Template


# ---------------------------------------------------------------------------
# the matrix product
# ---------------------------------------------------------------------------

#: on the card a blocked product runs in blocks of this many rows
ROW_BLOCK = 32

#: set (``rows_padded``): a product of fewer than ROW_BLOCK rows runs as
#: one of ROW_BLOCK rows; ``"all"``: every product runs in such blocks
_ROWS_PADDED = contextvars.ContextVar("rows_padded", default=False)


@contextlib.contextmanager
def rows_padded(on=True):
    """In the block (this thread's context only), every ``linear`` of
    fewer than ROW_BLOCK rows runs on the card as one product of
    ROW_BLOCK rows, the rows padded with zeros, so that a decode tick's
    rows (1, 4 or 20) round as a batch's.  A tensor-parallel rank takes
    it: at some per-rank shapes cuBLAS picks its kernel by the row count
    in bf16 (qwen3_32b's q product at tp 2 and its gate/up at tp 4 round
    rows 1-8 apart from 16's: ``chip_smoke.py`` phase ``gemm_width``,
    ROADMAP Hazard 4).  Prefill chunks keep their row counts, the same in
    a served run and in its reference.  ``on="all"`` runs every product
    in blocks of ROW_BLOCK rows, as ``blocked`` does: a rank's encoder
    over a batch's frames (``generate``) then rounds each row as
    alone."""
    token = _ROWS_PADDED.set(on)
    try:
        yield
    finally:
        _ROWS_PADDED.reset(token)


def products_padded() -> bool:
    """Whether this context is in a ``rows_padded`` block."""
    return bool(_ROWS_PADDED.get())


def linear(x: torch.Tensor, w: torch.Tensor,
           blocked: bool = False) -> torch.Tensor:
    """``x @ w`` for x [..., K] and a 2-D weight w [K, N]: every matrix
    product of the model goes through here, so the width rule lives in
    one place.

    Serving holds a row's tokens bitwise equal whether it decodes alone
    (``generate``, one row) or in a continuous batch (one row per slot),
    so a row's product must not depend on how many rows it travels with
    (ROADMAP Hazard 4).  On the CPU, rows of a product of two or more
    rows do not, but a single row takes another path and rounds
    differently: a single row is multiplied as two (a copy) and the
    first kept.  On the card cuBLAS picks its kernel by the row count:
    for the attention and FFN products bf16 rows at 1-32 rows agree
    (``chip_smoke.py`` phase ``gemm_width``), but not those of mLSTM's
    gate product (N = 4) from 20 rows, nor f32 ones.  ``blocked`` (the
    recurrent mixers' products, whose rows feed a state that must come
    out bitwise alike for any batch, chunk or verify width) runs the
    rows on the card in blocks of ROW_BLOCK, the last padded with
    zeros: every such product has one shape, whose rows do not depend
    on each other or on their place in the block."""
    K, N = w.shape
    rows = x.reshape(-1, K)
    M = rows.shape[0]
    padded = _ROWS_PADDED.get()
    blocked = blocked or padded == "all" or (M < ROW_BLOCK and padded)
    if rows.device.type == "cpu":
        y = (two_rows(rows, 0) @ w)[:1] if M == 1 else rows @ w
    elif not blocked:
        y = rows @ w
    else:
        pad = -M % ROW_BLOCK
        if pad:
            rows = F.pad(rows, (0, 0, 0, pad))
        if M + pad == ROW_BLOCK:
            y = rows @ w
        else:
            y = rows.new_empty((M + pad, N))
            for i in range(0, M + pad, ROW_BLOCK):
                torch.mm(rows[i:i + ROW_BLOCK], w,
                         out=y[i:i + ROW_BLOCK])
        y = y[:M]
    return y.view(*x.shape[:-1], N)


def each_row(fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of the ``xs`` one row at a time (each ``x``
    sliced to ``[1, ...]`` along dim 0), concatenated: for a reduction or
    a batched product of per-row state, whose kernel on the card may
    choose its order by the batch's shape.  Each call sees the shapes of
    a batch of one, whatever the batch, so a row's bits are the same
    alone and in any batch."""
    if xs[0].shape[0] == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[b:b + 1] for x in xs))
                      for b in range(xs[0].shape[0])])


def pointwise(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``, with each element's bits
    independent of the tensor's size.  The CPU kernels of exp, log and
    the like run whole vector registers, then the tensor's last few
    elements one at a time, which rounds them differently; a tensor of
    short rows ([B, H] gates) would then round a row by the number of
    rows beside it.  On the CPU each row of the last axis is padded to a
    multiple of 32 elements (two registers of the widest lane count),
    so every element takes the vector path at the same lane; on the
    card every element runs the same code, and ``fn`` runs as it is."""
    n = x.shape[-1]
    if x.device.type != "cpu" or n % 32 == 0:
        return fn(x)
    return fn(F.pad(x, (0, -n % 32)))[..., :n]


@contextlib.contextmanager
def no_tf32(device: torch.device):
    """f32 products on the card in true f32 for the block, whatever the
    caller set: TF32 is turned off, through the API the caller's
    setting came by (torch refuses a mix of its two), and restored
    after.  Touches nothing when TF32 is already off."""
    m = torch.backends.cuda.matmul
    prec = getattr(m, "fp32_precision", None) if device.type == "cuda" \
        else "ieee"
    if prec is None:                    # a torch without the newer API
        name, prev, off, on = "allow_tf32", True, False, m.allow_tf32
    else:
        name, prev, off = "fp32_precision", prec, "ieee"
        on = prec == "tf32" or (prec == "none" and getattr(
            torch.backends, "fp32_precision", "ieee") == "tf32")
    if on:
        setattr(m, name, off)
    try:
        yield
    finally:
        if on:
            setattr(m, name, prev)


def remat(fn: Callable, *args):
    """``fn(*args)`` under an activation checkpoint where autograd
    records (the JAX ``jax.checkpoint``): the backward recomputes what
    ``fn`` would have saved.  Without grad it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def scan(body: Callable, carry, n: int, name: str):
    """``carry, out = body(t, carry)`` for t in range(n): a token loop
    (the JAX ``lax.scan``).  Returns the last carry and the list of the
    ``n`` outputs.  On tensors it is this Python loop, op for op; under
    the cost analysis's op counter (``launch/op_cost.py``) a loop of more
    than 3 steps is priced once and scaled by its trip count
    (``OpCounter.scan``), which raises, naming the loop (``name``), if
    the carry's shapes or dtypes change from step to step.  Only a carry
    on ``meta`` tensors, which hold no values, is scaled."""
    from ..launch import op_cost
    counter = op_cost.active()
    if counter is not None and counter.scale_loops and n > 3 and all(
            t.device.type == "meta" for t in pytree.tree_leaves(carry)
            if isinstance(t, torch.Tensor)):
        return counter.scan(body, carry, n, name)
    outs = []
    for t in range(n):
        carry, out = body(t, carry)
        outs.append(out)
    return carry, outs


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_template(d: int, axis: str = "embed") -> Template:
    return {"scale": ParamSpec((d,), (axis,), init="ones")}


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
        "w_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d), ("mlp", "embed")),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, params["w_gate"])
    u = linear(x, params["w_up"])
    h = F.silu(upcast(g)).to(x.dtype) * u
    return linear(h, params["w_down"])


def mesh_mlp(params, x: torch.Tensor, d_ff: int, line) -> torch.Tensor:
    """The SwiGLU MLP on a training rank: where the rules cut its ``mlp``
    columns over ``line`` (the model line), x enters the column-parallel
    region (``line_enter``) and the rank's partial output of ``w_down``
    is summed over the line (``line_sum``); else it is computed whole."""
    from ..sharding.group import line_enter, line_sum
    if params["w_down"].shape[0] == d_ff:
        return mlp_apply(params, x)
    return line_sum(mlp_apply(params, line_enter(x, line)), line)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def embed_template(vocab: int, d: int) -> Template:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"),
                                   init="scaled", scale=0.02)}


def embed_apply(params, tokens: torch.Tensor, dtype,
                tp=None) -> torch.Tensor:
    """The tokens' embeddings.  Under a tensor-parallel rank group
    ``tp`` (``sharding/group.py``) the embedding is this rank's slice of
    the vocabulary, rows ``[rank * V/tp, (rank + 1) * V/tp)``: each rank
    looks the ids up in its slice, writes zeros for the others, and the
    ranks' sum is exact (one non-zero term)."""
    emb = params["embedding"]
    if tp is None:
        return emb[tokens].to(dtype)
    rows = emb.shape[0]
    local = tokens - tp.rank * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    x = torch.where(inside, emb[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return tp.all_reduce(x.to(dtype))


def mesh_embed(emb: torch.Tensor, tokens: torch.Tensor, dtype,
               line) -> torch.Tensor:
    """The tokens' embeddings on a training rank from ``emb``, its rows
    of the vocabulary where the rules cut them over ``line`` (the model
    line): its ids looked up, zeros for the others, summed over the line
    under autograd (exact; each rank's gradient lands on its rows);
    ``line`` None: the whole vocabulary."""
    from ..sharding.group import line_sum
    rows = emb.shape[0]
    if line is None or line.size == 1:
        return emb[tokens].to(dtype)
    local = tokens - line.index * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    x = torch.where(inside, emb[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return line_sum(x.to(dtype), line)


def lm_head_template(d: int, vocab: int) -> Template:
    return {"w": ParamSpec((d, vocab), ("embed", "vocab"))}


def lm_head_apply(params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, params["w"])
