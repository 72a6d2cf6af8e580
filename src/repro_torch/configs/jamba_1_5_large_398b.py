"""jamba-1.5-large-398b: Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

72 layers = 9 superblocks of (7 mamba + 1 attention); MoE FFN on even
positions (16 experts, top-2, expert d_ff 24576), dense SwiGLU on odd.
Mamba majority -> sub-quadratic -> supports long_500k.  398B total
params; fsdp_params shards expert weights over data too.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    attn_period=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    supports_long_context=True,
    fsdp_params=True,
)

REDUCED = ArchConfig(
    name="jamba-1.5-large-398b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    moe_d_ff=128,
    moe_every=2,
    attn_period=2,
    mamba_d_state=8,
    mamba_d_conv=4,
    supports_long_context=True,
    attn_chunk=32,
)
