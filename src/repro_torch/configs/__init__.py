"""Architecture registry: --arch <id> resolves here."""

from repro_torch.configs import (
    jamba_1_5_large_398b,
    llava_next_mistral_7b,
    mistral_large_123b,
    mistral_nemo_12b,
    moonshot_v1_16b_a3b,
    olmoe_1b_7b,
    seamless_m4t_large_v2,
    xlstm_1_3b,
    yi_6b,
    yi_9b,
)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_supported

_MODULES = {
    "yi-9b": yi_9b,
    "yi-6b": yi_6b,
    "mistral-large-123b": mistral_large_123b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "xlstm-1.3b": xlstm_1_3b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}

ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}
REDUCED = {name: m.REDUCED for name, m in _MODULES.items()}


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    table = REDUCED if reduced else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]
