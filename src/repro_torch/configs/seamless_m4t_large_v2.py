"""seamless-m4t-large-v2: enc-dec, multimodal [arXiv:2308.11596; hf].

24 encoder + 24 decoder layers; the speech frontend is a STUB —
input_specs feeds precomputed 80-dim filterbank frames which a linear
frontend lifts to d_model.  vocab 256206 is padded to 256208 so the
16-way model axis divides it (recorded in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="frame",
    frontend_dim=80,
)

REDUCED = ArchConfig(
    name="seamless-m4t-large-v2-reduced",
    family="audio",
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    frontend="frame",
    frontend_dim=16,
    attn_chunk=32,
)
