"""llava-next-mistral-7b: VLM, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone is the mistral-7b transformer; the vision tower is a STUB —
input_specs feeds 576 precomputed CLIP-style patch embeddings (dim
1024) which a 2-layer MLP projector lifts to d_model.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="patch",
    frontend_dim=1024,
    frontend_tokens=576,
)

REDUCED = ArchConfig(
    name="llava-next-mistral-7b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    frontend="patch",
    frontend_dim=32,
    frontend_tokens=16,
    attn_chunk=32,
)
