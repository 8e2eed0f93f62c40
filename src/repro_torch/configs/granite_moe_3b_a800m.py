"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base scaled per the
assigned numbers].
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    ffn_pattern=("moe",),
    num_experts=40,
    num_experts_per_tok=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
