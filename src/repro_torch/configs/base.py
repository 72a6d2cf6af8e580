"""Architecture config schema + input-shape definitions.

A copy of the reference's schema (plain dataclasses, no JAX): every
architecture is one `ArchConfig` in its own module beside this one; the
four input shapes are global (`SHAPES`).  Reduced configs (same family,
tiny dims) drive the CPU tests; the full ones run on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "sort"     # "sort" | "cdf" (paper §4 integration)
    moe_every: int = 1             # MoE FFN on layers where i % moe_every == 0
    moe_aux_weight: float = 0.01

    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0

    # ssm
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0         # 0 -> ceil(d_model/16)
    mamba_d_inner: int = 0         # 0 -> 2*d_model
    xlstm_proj_factor: int = 2
    xlstm_slstm_every: int = 8     # 1 sLSTM per N blocks

    # enc-dec
    num_encoder_layers: int = 0
    frontend: str = ""             # "patch" (vlm) | "frame" (audio)
    frontend_dim: int = 0          # precomputed embedding dim fed by input_specs
    frontend_tokens: int = 0       # patches per image / frames per utterance

    # numerics / training
    rope_theta: float = 1e6
    dtype: str = "bfloat16"
    remat: bool = True
    # "full": nothing saveable (max recompute); "block_io": save the
    # post-collective block outputs so the rematted forward never
    # re-runs its TP all-reduces (§Perf: −1/3 AR volume for ~2(B,S,D)
    # bf16 per layer of memory)
    remat_policy: str = "full"
    attn_chunk: int = 512
    tie_embeddings: bool = True

    # sharding hints (consumed by distributed/sharding.py)
    fsdp_params: bool = False      # additionally shard big weights over data
    dp_over_model: bool = False    # model axis joins DP; weights FSDP over it
    vocab_pad_to: int = 16         # pad vocab to a multiple (model-axis shards)

    # which shapes this arch supports (spec: long_500k only sub-quadratic)
    supports_long_context: bool = False
    decoder_only: bool = True

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, -(-self.d_model // 16))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec-mandated skips, recorded (not silently dropped)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full attention is quadratic at 524288 ctx (per spec)"
    if shape.kind == "decode" and not cfg.decoder_only and cfg.num_layers == 0:
        return False, "encoder-only arch has no decode step"
    return True, ""
