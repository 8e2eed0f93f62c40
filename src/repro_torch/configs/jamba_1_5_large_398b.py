"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Layer pattern: one attention layer per 8 (the rest Mamba); MoE FFN every
second layer, dense otherwise [arXiv:2403.19887].
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    dense_d_ff=24576,
    vocab_size=65536,
    block_pattern=("attn",) + ("mamba",) * 7,   # 1:7 attn:mamba
    ffn_pattern=("dense", "moe"),               # MoE every other layer
    num_experts=16,
    num_experts_per_tok=2,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    ssm_chunk=128,
    rope_theta=1_000_000.0,
    optimizer="adafactor",                      # 398B: factored 2nd moment
    source="arXiv:2403.19887 (Jamba-1.5)",
)
