"""Learned index structures — the paper's range index (§2-3), point
index (§4) and existence index baseline (§5) in torch.

Public API:
  Range index (§2-3):  make_keyset, RMIConfig, build_rmi, compile_lookup
  Search (§3.4):       core.search strategies
  Point index (§4):    build_model_hashmap, build_random_hashmap
  Existence (§5):      build_bloom, compile_bloom_probe
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
from repro_torch.core.bloom import BloomFilter, build_bloom, compile_bloom_probe
from repro_torch.core.learned_hash import (
    HashMap,
    build_hashmap,
    build_model_hashmap,
    build_random_hashmap,
    compile_hash_lookup,
    model_hash_slots,
    random_hash_u32,
    random_hash_u64,
)

__all__ = [
    "KeySet", "make_keyset",
    "RMIConfig", "RMIndex", "build_rmi", "compile_lookup", "refit_rmi",
    "rmi_lookup", "rmi_predict", "stage0_segments",
    "BloomFilter", "build_bloom", "compile_bloom_probe",
    "HashMap", "build_hashmap", "build_model_hashmap", "build_random_hashmap",
    "compile_hash_lookup", "model_hash_slots", "random_hash_u32", "random_hash_u64",
]
