"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes a kernel or a whole step needs, from shapes alone.

The bounds count what the algorithm needs for the call: each input byte
read once and each output byte written once, an attention kernel only
the keys its queries see, four operations per (query row, visible key,
head) and head_dim.  They are this benchmark's own copies, so a change
to the program cannot move them.
"""
from __future__ import annotations

from typing import Iterable, Sequence

#: NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    return 100.0 * bound_s(flops, nbytes) / seconds


def visible_pairs(S: int, q_offset: int = 0) -> int:
    """Keys seen in all by S causal query rows at ``q_offset + s``."""
    lo, hi = q_offset + 1, q_offset + S
    return (lo + hi) * S // 2


def flash_attention_cost(B: int, S: int, T: int, H: int, KV: int, hd: int,
                         q_offset: int = 0, es: int = 2):
    """K3, causal: (flops, bytes) of q [B,S,H,hd] over k/v [B,T,KV,hd]."""
    q = B * S * H * hd * es
    kv = B * T * KV * hd * es
    flops = 4 * hd * H * B * visible_pairs(S, q_offset)
    return flops, 2 * q + 2 * kv


def flash_decode_cost(positions: Sequence[int], H: int, KV: int, hd: int,
                      table_width: int, Sq: int = 1, es: int = 2):
    """K2 (paged, fused RoPE and tail write): (flops, bytes) of one call
    over rows at ``positions``: each row's keys up to its window read
    once, q and the output, the new K/V, the block tables and the
    positions."""
    B = len(positions)
    keys = [int(p) + 1 for p in positions]
    kv = 2 * sum(n + Sq - 1 for n in keys) * KV * hd * es
    q = B * Sq * H * hd * es
    new = B * Sq * KV * hd * es
    io = 2 * (q + new) + B * table_width * 4 + B * 4
    flops = 4 * hd * H * sum(n + s for n in keys for s in range(Sq))
    return flops, kv + io


def moe_ffn_cost(N: int, d: int, ff: int, k: int, E: int, experts_hit: int,
                 es: int = 2):
    """One MoE FFN layer over N tokens: (flops, bytes).  The router's
    weights and the weights of the experts the tokens reach, each read
    once, and the activations in and out; the router's product and k
    SwiGLU experts a token."""
    flops = 2 * N * d * E + 2 * N * k * 3 * d * ff
    nbytes = (d * E + experts_hit * 3 * d * ff) * es + 2 * N * d * es
    return flops, nbytes


def matmul_params(cfg: dict) -> int:
    """Weights multiplied per token (active): the attention projections,
    the FFN (the router and k experts for a MoE layer) and the logits
    over the real vocabulary."""
    d, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    attn = d * H * hd * 2 + d * KV * hd * 2
    if cfg.get("num_local_experts"):
        ffn = d * cfg["num_local_experts"] + \
            cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def attention_flops(cfg: dict, contexts: Iterable[int]) -> float:
    """Attention's products, forward: 4 x head_dim a (head, visible key)
    in every layer, for query tokens that see ``contexts`` keys."""
    per_key = 4 * cfg["head_dim"] * cfg["num_attention_heads"] * \
        cfg["num_hidden_layers"]
    return per_key * float(sum(contexts))


def serve_flops(cfg: dict, tokens: int, key_sum: int) -> float:
    """A forward over ``tokens`` tokens that see ``key_sum`` keys in all."""
    return 2.0 * matmul_params(cfg) * tokens + attention_flops(cfg, [key_sum])


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step: 6 x the weights multiplied x tokens, and three
    times the forward attention (no recomputation counted)."""
    tokens = batch * seq
    return 6.0 * matmul_params(cfg) * tokens + \
        3 * attention_flops(cfg, [batch * visible_pairs(seq)])
