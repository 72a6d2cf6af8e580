"""mistral-large-123b: dense GQA [hf:mistralai/Mistral-Large-Instruct-2407].

123B bf16 params = 246 GB -> 15.4 GB/chip at TP=16 alone; fsdp_params
additionally shards the big matrices over the data axis (FSDP+TP).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    fsdp_params=True,
)

REDUCED = ArchConfig(
    name="mistral-large-123b-reduced",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    attn_chunk=32,
)
