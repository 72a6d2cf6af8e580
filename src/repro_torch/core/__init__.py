"""Learned index structures — the paper's range index (§2-3) in torch.

Public API:
  Range index (§2-3):  make_keyset, RMIConfig, build_rmi, compile_lookup
  Search (§3.4):       core.search strategies
"""

from repro_torch.core.keys import KeySet, make_keyset
from repro_torch.core.rmi import (
    RMIConfig,
    RMIndex,
    build_rmi,
    compile_lookup,
    refit_rmi,
    rmi_lookup,
    rmi_predict,
    stage0_segments,
)

__all__ = [
    "KeySet", "make_keyset",
    "RMIConfig", "RMIndex", "build_rmi", "compile_lookup", "refit_rmi",
    "rmi_lookup", "rmi_predict", "stage0_segments",
]
