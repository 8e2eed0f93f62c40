"""minicpm-2b [dense] — llama-like with WSD LR schedule.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753
[arXiv:2404.06395].  The WSD (warmup-stable-decay) schedule lives in
the JAX package's optim.schedules and is selected by ``lr_schedule="wsd"``.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    lr_schedule="wsd",
    source="arXiv:2404.06395 (MiniCPM)",
)
