"""mistral-nemo-12b: dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,           # nemo uses head_dim 128 (not d_model/heads)
    rope_theta=1e6,
)

REDUCED = ArchConfig(
    name="mistral-nemo-12b-reduced",
    family="dense",
    num_layers=2,
    d_model=80,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    attn_chunk=32,
)
