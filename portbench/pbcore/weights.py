"""Random weights from the seed, made by the benchmark and handed to both
the program and the reference.

They are drawn on the device with one ``torch.Generator``, one call per
leaf, every layer of a leaf at once, in the dtype they are served in,
under the parameter paths of the program's state dict (an attention +
FFN stack of one repeating layer, stacked over the layers).  The
program's padded rows (vocabulary rounded up, pad experts) are drawn
too; the reference reads only the real ones.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _draw(gen, shape, std, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def make_weights(spec: Dict, seed: int, device, *, vocab_rows: int,
                 expert_rows: int = 0) -> Dict[str, torch.Tensor]:
    """The weights of configuration ``spec`` (a ``configs/*.json``) from
    ``seed``: ``vocab_rows`` embedding rows and, for a MoE FFN,
    ``expert_rows`` experts (the program's padded counts)."""
    dt = DTYPES[spec["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d = spec["num_hidden_layers"], spec["hidden_size"]
    H, KV, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    ff = spec["intermediate_size"]
    p = "blocks.l0."

    def draw(shape, std):
        return _draw(gen, shape, std, dt, device)

    def norm(shape):
        return draw(shape, 0.1).add_(1.0)

    w = {"embed.embedding": draw((vocab_rows, d), 0.02),
         "final_norm.scale": norm((d,)),
         p + "norm1.scale": norm((L, d)),
         p + "mixer.wq": draw((L, d, H, hd), d ** -0.5),
         p + "mixer.wk": draw((L, d, KV, hd), d ** -0.5),
         p + "mixer.wv": draw((L, d, KV, hd), d ** -0.5),
         p + "mixer.wo": draw((L, H, hd, d), (H * hd) ** -0.5),
         p + "norm2.scale": norm((L, d))}
    if spec.get("num_local_experts"):
        E = expert_rows
        w[p + "ffn.router"] = draw((L, d, E), d ** -0.5)
        w[p + "ffn.w_gate"] = draw((L, E, d, ff), d ** -0.5)
        w[p + "ffn.w_up"] = draw((L, E, d, ff), d ** -0.5)
        w[p + "ffn.w_down"] = draw((L, E, ff, d), ff ** -0.5)
    else:
        w[p + "ffn.w_gate"] = draw((L, d, ff), d ** -0.5)
        w[p + "ffn.w_up"] = draw((L, d, ff), d ** -0.5)
        w[p + "ffn.w_down"] = draw((L, ff, d), ff ** -0.5)
    return w


def param_count(spec: Dict) -> int:
    """The configuration's parameters (real vocabulary and experts)."""
    L, d = spec["num_hidden_layers"], spec["hidden_size"]
    H, KV, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    ff = spec["intermediate_size"]
    E = spec.get("num_local_experts", 0)
    ffn = E * (d + 3 * d * ff) if E else 3 * d * ff
    per = 2 * d + 2 * d * H * hd + 2 * d * KV * hd + ffn
    return L * per + d + spec["vocab_size"] * d

