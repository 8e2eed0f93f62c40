"""Architecture configuration.

One :class:`ArchConfig` per assigned architecture (see
``repro_torch.configs``).
``reduced()`` produces the CPU-smoke-test variant (≤2 layers, d_model≤512,
≤4 experts) of the same family, exercising the identical code path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads

    # ---- block pattern ---------------------------------------------------
    # repeating per-layer pattern of block kinds; cycled over num_layers.
    # kinds: "attn", "mamba", "mlstm", "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    # repeating FFN pattern: "dense" | "moe"; cycled over num_layers.
    ffn_pattern: Tuple[str, ...] = ("dense",)
    # layers at the front forced dense (deepseek-v3: first 3 layers dense)
    first_k_dense: int = 0
    dense_d_ff: int = 0        # d_ff for dense layers when ffn is mixed

    # ---- MoE ----------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    expert_pad_multiple: int = 16   # pad experts so EP divides the mesh

    # ---- attention -------------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0    # 0 = full attention
    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM (mamba) ---------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0       # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 256

    # ---- xLSTM ----------------------------------------------------------
    slstm_num_heads: int = 4
    mlstm_chunk: int = 256

    # ---- encoder-decoder -------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # ---- modality frontend stub (audio/vlm) ------------------------------
    frontend: str = ""         # "" | "vision_stub" | "audio_stub"
    num_prefix_embeddings: int = 0   # patch/frame embeddings per sample

    # ---- heads / training -------------------------------------------------
    mtp_depth: int = 0         # deepseek-v3 multi-token prediction
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # WSD (warmup-stable-decay, minicpm) vs cosine
    lr_schedule: str = "cosine"
    optimizer: str = "adamw"    # "adamw" | "adafactor" (the ≥100B giants)

    # citation for the numbers above
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank",
                               -(-self.d_model // 16))
        if self.dense_d_ff == 0:
            object.__setattr__(self, "dense_d_ff", self.d_ff)

    # ---- derived -----------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        p = self.ffn_pattern
        out = []
        for i in range(self.num_layers):
            if i < self.first_k_dense or self.num_experts == 0:
                out.append("dense")
            else:
                out.append(p[i % len(p)])
        return tuple(out)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the logits dim shards over the model axis
        (and MXU lanes).  Padded logit columns are masked to -inf in
        ``transformer._logits``; token ids never reach the pad region."""
        mult = 2048 if self.vocab_size >= 2048 else 128
        return -(-self.vocab_size // mult) * mult

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow linearly in full-attention KV:
        SSM/hybrid natively, or attention with a sliding window."""
        kinds = set(self.layer_kinds())
        if kinds <= {"mamba", "mlstm", "slstm"}:
            return True
        return self.sliding_window > 0

    # ---- parameter count (analytic, for roofline MODEL_FLOPS) -----------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        counts = {"embed": self.vocab_size * d,
                  "lm_head": 0 if self.tie_embeddings else self.vocab_size * d,
                  "final_norm": d}
        total_block = 0
        active_block = 0
        for kind, ffn in zip(self.layer_kinds(), self.ffn_kinds()):
            blk = d  # pre-norm
            if kind == "attn":
                if self.use_mla:
                    qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
                    blk += d * self.q_lora_rank
                    blk += self.q_lora_rank * nq * qk_head
                    blk += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    blk += self.kv_lora_rank * nq * (self.qk_nope_head_dim
                                                     + self.v_head_dim)
                    blk += nq * self.v_head_dim * d
                    blk += self.q_lora_rank + self.kv_lora_rank  # norms
                else:
                    blk += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                    if self.qk_norm:
                        blk += 2 * hd
            elif kind == "mamba":
                di, ds = self.d_inner, self.ssm_state_dim
                blk += d * 2 * di                  # in_proj
                blk += di * self.ssm_conv_width    # depthwise conv
                blk += di * (self.ssm_dt_rank + 2 * ds)  # x_proj
                blk += self.ssm_dt_rank * di + di  # dt_proj
                blk += di * ds + di                # A_log, D
                blk += di * d                      # out_proj
            elif kind == "mlstm":
                di = self.d_model * 2
                blk += d * (3 * di + 2 * self.num_heads * 0)  # q,k,v proj
                blk += 3 * d * di + di * d + 2 * di            # qkv,out,gates
            elif kind == "slstm":
                blk += 4 * d * d * 2 + 4 * d                   # gates (x&h)
            blk += d  # post/ffn norm
            ffn_active = 0
            if ffn == "moe":
                per_exp = 3 * d * self.d_ff
                blk += d * self.num_experts  # router
                blk += self.num_experts * per_exp
                blk += self.num_shared_experts * 3 * d * self.d_ff
                ffn_active = ((self.num_experts_per_tok +
                               self.num_shared_experts) * per_exp
                              + d * self.num_experts)
            else:
                dff = self.dense_d_ff if (self.num_experts and ffn == "dense") \
                    else self.d_ff
                if kind in ("mlstm", "slstm") and self.d_ff == 0:
                    dff = 0  # xLSTM blocks have integral FFNs
                blk += 3 * d * dff
                ffn_active = 3 * d * dff
            total_block += blk
            active_block += (blk - (self.num_experts * 3 * d * self.d_ff
                                    if ffn == "moe" else 0)) + \
                (ffn_active if ffn == "moe" else 0)
        counts["blocks"] = total_block
        if self.is_encoder_decoder:
            # encoder: self-attn + ffn; decoder adds cross-attn
            enc = self.num_encoder_layers * (
                4 * d * nq * hd + 3 * d * self.d_ff + 2 * d)
            dec_cross = self.num_layers * (4 * d * nq * hd + d)
            counts["encoder"] = enc
            counts["cross_attn"] = dec_cross
            total_block += enc + dec_cross
            active_block += enc + dec_cross
        total = sum(counts.values())
        active = (counts["embed"] + counts["lm_head"] + counts["final_norm"]
                  + active_block)
        return {"total": total, "active": active, **counts}

    # ---- reduced smoke variant -------------------------------------------
    def reduced(self) -> "ArchConfig":
        nl = min(self.num_layers, 2)
        if len(self.block_pattern) > 1 or len(self.ffn_pattern) > 1:
            nl = 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            dense_d_ff=min(self.dense_d_ff, 512) if self.dense_d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            expert_pad_multiple=2,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 32),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=32 if self.use_mla else 0,
            qk_rope_head_dim=16 if self.use_mla else 0,
            v_head_dim=32 if self.use_mla else 0,
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
            ssm_chunk=32,
            mlstm_chunk=32,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            slstm_num_heads=2,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
