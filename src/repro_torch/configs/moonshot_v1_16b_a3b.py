"""moonshot-v1-16b-a3b: kimi/moonlight 64e top-6 MoE
[hf:moonshotai/Moonlight-16B-A3B]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
)

REDUCED = ArchConfig(
    name="moonshot-v1-16b-a3b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=64,
    attn_chunk=32,
)
