"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048 (per expert; first 3 layers dense with
d_ff=18432) vocab=129280.  MLA: q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128 [arXiv:2412.19437].
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,      # MLA replaces GQA; kept for the record
    head_dim=128,
    d_ff=2048,
    dense_d_ff=18432,
    vocab_size=129280,
    ffn_pattern=("moe",),
    first_k_dense=3,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    optimizer="adafactor",   # 671B: factored 2nd moment
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
