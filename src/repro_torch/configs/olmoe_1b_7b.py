"""olmoe-1b-7b: 64 experts top-8 MoE [arXiv:2409.02060; hf].

Uses the paper-integrated CDF dispatch (learned Hash-Model slot
placement, §4) as its default MoE dispatch.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    moe_dispatch="cdf",
)

REDUCED = ArchConfig(
    name="olmoe-1b-7b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=64,
    moe_dispatch="cdf",
    attn_chunk=32,
)
