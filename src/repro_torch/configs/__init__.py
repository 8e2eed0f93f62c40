"""Architecture configs of the port (``--arch <id>``).

All ten assigned architectures are ported: the dense GQA/MHA decoders,
the MoE decoder (granite_moe_3b_a800m), the recurrent xLSTM stack
(xlstm_1_3b), the hybrid Mamba + attention + MoE stack
(jamba_1_5_large_398b), the MLA + MoE decoder with a dense head and
multi-token prediction (deepseek_v3_671b), the encoder-decoder over stub
frame embeddings (seamless_m4t_large_v2) and the decoder behind stub
patch embeddings (phi_3_vision_4_2b).
``get_config(name)`` resolves an id; ``ALL_ARCHS`` lists the ten
assigned ids.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ALL_ARCHS = [
    "jamba_1_5_large_398b",
    "granite_moe_3b_a800m",
    "xlstm_1_3b",
    "deepseek_7b",
    "seamless_m4t_large_v2",
    "qwen3_32b",
    "minicpm_2b",
    "deepseek_v3_671b",
    "phi_3_vision_4_2b",
    "stablelm_12b",
]

_ALIASES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-7b": "deepseek_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen3-32b": "qwen3_32b",
    "minicpm-2b": "minicpm_2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "stablelm-12b": "stablelm_12b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ALIASES)} (or module ids {ALL_ARCHS})")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG
