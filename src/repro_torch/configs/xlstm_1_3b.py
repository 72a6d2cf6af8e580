"""xlstm-1.3b: sLSTM + mLSTM blocks [arXiv:2405.04517].

48 blocks, 7:1 mLSTM:sLSTM interleave, proj factor 2, qk dim = v dim/2.
O(1) decode state -> supports long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                  # xLSTM blocks carry their own up/down proj
    vocab_size=50304,
    xlstm_proj_factor=2,
    xlstm_slstm_every=8,
    supports_long_context=True,
)

REDUCED = ArchConfig(
    name="xlstm-1.3b-reduced",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    xlstm_proj_factor=2,
    xlstm_slstm_every=2,
    supports_long_context=True,
)
