"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct].  The ViT/CLIP image encoder +
projector is a STUB: ``input_specs`` supplies 576 precomputed patch
embeddings per image, prepended to the text tokens.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision_stub",
    num_prefix_embeddings=576,   # 24x24 CLIP patches per image
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
