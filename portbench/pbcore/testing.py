"""Tiny configurations and mixes for the CPU tests: the program's
architectures at a few thousand parameters, served on the CPU."""
import copy

DENSE = {"arch": "minicpm_2b", "dtype": "bfloat16",
         "num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
         "intermediate_size": 128, "vocab_size": 512, "rms_norm_eps": 1e-5,
         "rope_theta": 10000.0, "tie_word_embeddings": True}
MOE = dict(DENSE, arch="granite_moe_3b_a800m", num_key_value_heads=2,
           num_local_experts=8, num_experts_per_tok=2)
MIX = {"kind": "serve", "clients": 4, "slots": 4, "block_size": 16,
       "chunk": 32, "prefix_sharing": True, "max_len": 256,
       "system_prompts": 2, "system_len": 32,
       "user_len": {"dist": "lognormal", "median": 32, "sigma": 0.8,
                    "min": 8, "max": 128},
       "new_tokens": {"dist": "uniform", "min": 4, "max": 16},
       "pool": 32, "sample": 3}


def spec(moe: bool = False, **kw):
    return dict(copy.deepcopy(MOE if moe else DENSE), **kw)


def mix(**kw):
    return dict(copy.deepcopy(MIX), **kw)
