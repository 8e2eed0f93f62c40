"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

48L d_model=2048 4H (GQA kv=4 — used as the mLSTM/sLSTM head count)
d_ff=0 (xLSTM blocks carry integral up/down projections; no separate FFN)
vocab=50304.  Block ratio 7:1 mLSTM:sLSTM per the xLSTM[7:1] 1.3B model
[arXiv:2405.04517].
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    slstm_num_heads=4,
    mlstm_chunk=256,
    source="arXiv:2405.04517 (xLSTM[7:1] 1.3B)",
)
