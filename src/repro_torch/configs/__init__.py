"""Architecture configs of the port (``--arch <id>``).

The dense GQA/MHA decoders and the MoE decoder (granite_moe_3b_a800m)
are ported; every other assigned architecture raises, naming the
ROADMAP item that will port it.
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

#: where each architecture that is not ported yet will be ported
NOT_YET_PORTED = {
    "xlstm_1_3b": "ROADMAP Queue 1 item 7 (recurrent stacks)",
    "jamba_1_5_large_398b": "ROADMAP Queue 1 item 7 (hybrid stacks)",
    "deepseek_v3_671b": "ROADMAP Queue 1 item 8 (MLA)",
    "seamless_m4t_large_v2": "ROADMAP Queue 1 item 9 (encoder-decoder)",
    "phi_3_vision_4_2b": "ROADMAP Queue 1 item 9 (modality stubs)",
}

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
    if mod_name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch: "
            f"{NOT_YET_PORTED[mod_name]}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG
