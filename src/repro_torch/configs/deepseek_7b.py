"""deepseek-7b [dense] — llama-architecture MHA.

30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400
[arXiv:2401.02954].  long_500k decode runs the sliding-window variant
(window 8192) — see DESIGN.md §4.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954 (DeepSeek LLM 7B)",
)
