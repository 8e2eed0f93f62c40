"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.

24L (decoder) + 24 encoder layers, d_model=1024 16H d_ff=8192 vocab=256206
[arXiv:2308.11596].  The mel-spectrogram + conformer feature frontend is a
STUB per the brief: ``input_specs`` supplies precomputed frame embeddings
[B, S, d_model]; this config is the text decoder + speech encoder
transformer backbone.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    frontend="audio_stub",
    source="arXiv:2308.11596 (SeamlessM4T v2 large)",
)
