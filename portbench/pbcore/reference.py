"""The plain reference: the configuration's forward pass in float32 with
plain PyTorch operations, no cache, no batching and no kernel.

It imports nothing of the program.  It reads the benchmark's weights
(``weights.py``) by their paths and computes, layer by layer: the
embedding; per layer an RMSNorm, causal multi-head attention with
rotate-half RoPE (grouped K/V), the output projection and the residual,
an RMSNorm and a SwiGLU FFN or a dropless top-k MoE FFN (softmax router
over the real experts, the k largest, ties to the lower index, gates
renormalised), the residual; the final RMSNorm and the tied logits over
the real vocabulary.  Departures from the published models are the
configuration file's ``reduced`` and ``assumed`` (the muP scalings, the
program's capacity drops).

``quant="fp8"`` is the control: every product with a weight (not the
router's, not attention's scores) takes both operands rounded to fp8
e4m3, activations scaled per token and weights per output column, the
step below the bf16 that the configurations state.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

P = "blocks.l0."
#: query rows of one attention block (bounds the scores' memory)
Q_BLOCK = 1024


@contextlib.contextmanager
def true_f32():
    """f32 products in true f32 on the card: TF32 off for the block."""
    m = torch.backends.cuda.matmul
    prec = getattr(m, "fp32_precision", None)
    if prec is not None:
        prev = prec
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = prev
        return
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` mapped to 448), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The forward pass of configuration ``spec`` on weights ``w``."""

    def __init__(self, spec: Dict, w: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.spec, self.w, self.quant = spec, w, quant
        self.V = spec["vocab_size"]
        self.E = spec.get("num_local_experts", 0)
        #: after ``logits`` of a MoE configuration: at each position, the
        #: least margin over the layers between the router logits of the
        #: k-th and the (k+1)-th expert (how near a token's top-k choice
        #: came to another set of experts)
        self.router_margin: Optional[torch.Tensor] = None

    def _f32(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        t = self.w[name if layer is None else P + name]
        if layer is not None:
            t = t[layer]
        return t.to(torch.float32)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [M, K] @ w [K, N] in f32, or with fp8 operands."""
        if self.quant == "fp8":
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.spec["rms_norm_eps"]) * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [S, n, hd] rotated at positions ``pos`` [S] (rotate-half)."""
        hd = x.shape[-1]
        inv = 1.0 / (self.spec["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device)
            / hd))
        ang = (pos.to(torch.float64)[:, None] * inv)[:, None, :]
        cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, h: torch.Tensor, l: int, pos: torch.Tensor):
        s = self.spec
        S = h.shape[0]
        H, KV, hd = (s["num_attention_heads"], s["num_key_value_heads"],
                     s["head_dim"])
        wq = self._f32("mixer.wq", l).reshape(-1, H * hd)
        wk = self._f32("mixer.wk", l).reshape(-1, KV * hd)
        wv = self._f32("mixer.wv", l).reshape(-1, KV * hd)
        q = self.rope(self.linear(h, wq).view(S, H, hd), pos)
        k = self.rope(self.linear(h, wk).view(S, KV, hd), pos)
        v = self.linear(h, wv).view(S, KV, hd)
        G = H // KV
        k = k.repeat_interleave(G, dim=1).transpose(0, 1)   # [H, S, hd]
        v = v.repeat_interleave(G, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty_like(q)
        for a in range(0, S, Q_BLOCK):
            b = min(S, a + Q_BLOCK)
            sc = q[:, a:b] @ k[:, :b].transpose(1, 2) / hd ** 0.5
            keep = torch.arange(b, device=h.device)[None, :] <= \
                torch.arange(a, b, device=h.device)[:, None]
            sc = sc.masked_fill(~keep, float("-inf"))
            out[:, a:b] = torch.softmax(sc, -1) @ v[:, :b]
        out = out.transpose(0, 1).reshape(S, H * hd)
        return self.linear(out, self._f32("mixer.wo", l).reshape(H * hd, -1))

    def swiglu(self, h, wg, wu, wd):
        return self.linear(torch.nn.functional.silu(self.linear(h, wg))
                           * self.linear(h, wu), wd)

    def ffn(self, h: torch.Tensor, l: int) -> torch.Tensor:
        if not self.E:
            return self.swiglu(h, self._f32("ffn.w_gate", l),
                               self._f32("ffn.w_up", l),
                               self._f32("ffn.w_down", l))
        k = self.spec["num_experts_per_tok"]
        router = self._f32("ffn.router", l)[:, :self.E]
        scores = h @ router
        top = scores.topk(k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        self.router_margin = margin if self.router_margin is None else \
            torch.minimum(self.router_margin, margin)
        probs = torch.softmax(scores, -1)
        gates, idx = torch.sort(probs, dim=-1, descending=True,
                                stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        wg, wu, wd = (self.w[P + "ffn." + n][l]
                      for n in ("w_gate", "w_up", "w_down"))
        for e in range(self.E):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self.swiglu(h[rows], wg[e].float(), wu[e].float(),
                            wd[e].float())
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
        return out

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """The logits [S - first, V] of the positions ``first`` .. S - 1 of
        the token sequence ``tokens`` [S] (the next token's scores)."""
        self.router_margin = None
        with true_f32():
            emb = self.w["embed.embedding"]
            x = emb[tokens.long()].float()
            pos = torch.arange(x.shape[0], device=x.device)
            for l in range(self.spec["num_hidden_layers"]):
                x = x + self.attention(
                    self.norm(x, self._f32("norm1.scale", l)), l, pos)
                x = x + self.ffn(self.norm(x, self._f32("norm2.scale", l)), l)
            x = self.norm(x[first:], self._f32("final_norm.scale"))
            return self.linear(x, emb[:self.V].float().t())


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor):
    """The gap by which each served token's reference logit lies below
    the reference's best, at each position of ``ref_logits`` [n, V], for
    the served ``tokens`` [n]: a float64 array [n]."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return (best - got).double().cpu().numpy()
