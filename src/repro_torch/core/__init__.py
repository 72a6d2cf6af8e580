"""Learned index structures — the paper's contribution, in torch.

Public API:
  Range index (§2-3):  make_keyset, RMIConfig, build_rmi, compile_lookup
  Baseline:            build_btree, compile_btree_lookup
  Search (§3.4):       core.search strategies
  Strings (§3.5):      tokenize, compile_string_lookup
  Point index (§4):    build_model_hashmap, build_random_hashmap
  Existence (§5):      build_bloom, compile_bloom_probe, build_learned_bloom
  Synthesis (§3.1):    lif.synthesize
"""

from repro_torch.core.keys import (
    KeySet,
    VectorKeySet,
    make_keyset,
    make_vector_keyset,
)
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
from repro_torch.core.btree import BTreeIndex, build_btree, compile_btree_lookup
from repro_torch.core.bloom import BloomFilter, build_bloom, compile_bloom_probe
from repro_torch.core.learned_bloom import (
    GRUSpec,
    LearnedBloom,
    build_learned_bloom,
)
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
from repro_torch.core.lif import IndexSpec, synthesize
from repro_torch.core.strings import compile_string_lookup, tokenize

__all__ = [
    "KeySet", "VectorKeySet", "make_keyset", "make_vector_keyset",
    "RMIConfig", "RMIndex", "build_rmi", "compile_lookup", "refit_rmi",
    "rmi_lookup", "rmi_predict", "stage0_segments",
    "BTreeIndex", "build_btree", "compile_btree_lookup",
    "BloomFilter", "build_bloom", "compile_bloom_probe", "GRUSpec",
    "LearnedBloom", "build_learned_bloom",
    "HashMap", "build_hashmap", "build_model_hashmap", "build_random_hashmap",
    "compile_hash_lookup", "model_hash_slots", "random_hash_u32", "random_hash_u64",
    "IndexSpec", "synthesize", "compile_string_lookup", "tokenize",
]
