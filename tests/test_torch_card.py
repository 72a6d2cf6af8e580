"""Kernels on the card against their plain twins, with nothing of JAX,
so they run where the card is:

    python -m pytest -m cuda tests/test_torch_card.py

* B8 (`bloom_probe_cuda`): four queries a thread, the ragged tail
  (batches that are not a multiple of four), a query view that is not
  16-byte aligned (keys and answers one by one), ``k`` = 0,
  ``num_bits`` = 1 and 2**31 + 96 (where ``h1 + i*h2`` wraps), bit for
  bit against `ref.bloom_probe_reference`.
* C17 (ROADMAP queue C): +inf on a flat leaf through B1, B2 and B4 on
  the card, bit for bit against the plain twins, at n + 1 single-shard
  and n sharded.

Without a card every test here skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RMIConfig, build_rmi, make_keyset  # noqa: E402
from repro_torch.core.rmi import LEAF_FIELDS  # noqa: E402
from repro_torch.index_service.delta import combine_for_device  # noqa: E402
from repro_torch.kernels import bloom_probe, ops, ref, rmi_lookup  # noqa: E402
from repro_torch.kernels.ref import mix32  # noqa: E402

BLOOM_SHAPES = ((1, 3), (64, 0), (1 << 14, 3), (1 << 16, 7), (1 << 18, 10),
                ((1 << 31) + 96, 7))
BATCHES = (1, 3, 4, 5, 777, 1 << 16, (1 << 16) + 3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _member_words(members: torch.Tensor, num_bits: int, k: int) -> torch.Tensor:
    """int32 words with every probe bit of ``members`` (int64 values
    below 2**32) set under the kernel's own double hashing."""
    h1, h2 = mix32(members, 1), mix32(members, 2) | 1
    bits = torch.unique(torch.cat([((h1 + i * h2) & 0xFFFFFFFF) % num_bits
                                   for i in range(k)] or [members[:0]]))
    words = torch.zeros(-(-num_bits // 32), dtype=torch.int64, device=members.device)
    words.index_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bits,k", BLOOM_SHAPES)
def test_bloom_kernel_matches_twin_on_card(num_bits, k):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(num_bits % 1009 + k)
    members = torch.randint(0, 1 << 32, (500,), generator=g, dtype=torch.int64).to(dev)
    words = _member_words(members, num_bits, k)
    others = torch.randint(0, 1 << 32, (1 << 17,), generator=g, dtype=torch.int64).to(dev)
    edges = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], device=dev)
    pool = torch.cat([members, others, edges])
    for batch in BATCHES:
        qs = pool[torch.randint(0, pool.numel(), (batch + 1,), generator=g).to(dev)]
        q = torch.where(qs >= 1 << 31, qs - (1 << 32), qs).to(torch.int32)
        for view in (q[:batch], q[1:]):   # aligned, then one element in
            before = bloom_probe.LAUNCHES["bloom_probe_cuda"]
            got = bloom_probe.bloom_probe_cuda(view, words, num_bits=num_bits, k=k)
            assert bloom_probe.LAUNCHES["bloom_probe_cuda"] == before + 1
            want = ref.bloom_probe_reference(view, words, num_bits=num_bits, k=k)
            assert torch.equal(got, want), (batch, view.data_ptr() % 16)
    m = torch.where(members >= 1 << 31, members - (1 << 32), members).to(torch.int32)
    assert bloom_probe.bloom_probe_cuda(m, words, num_bits=num_bits, k=k).all()


@pytest.mark.cuda
def test_c17_infinite_query_on_a_flat_leaf_on_card():
    dev = _card()
    raw = np.concatenate([np.arange(8.0), 100.0 + np.arange(8) * 1e-9])
    ks = make_keyset(raw)
    idx = build_rmi(ks, RMIConfig(num_leaves=2, stage0_hidden=(), stage0_train_steps=0),
                    device=dev)
    assert idx.leaf_w[1] == 0.0
    n = ks.n
    q = torch.tensor([np.inf, 1e30, 1.0, -np.inf, np.nan, 0.5], dtype=torch.float32,
                     device=dev)
    tree = idx.as_tree(dev)
    args = (q, tree["s0"], *(tree[k] for k in LEAF_FIELDS),
            torch.as_tensor(ks.norm, device=dev))
    kw = dict(hidden=(), n=n, num_leaves=2, max_window=idx.max_window)
    base = rmi_lookup.rmi_lookup_cuda(*args, **kw)
    assert torch.equal(base, ref.rmi_lookup_reference(*args, **kw))
    assert base[:3].tolist() == [n + 1, n + 1, 8] and base[3] == 0
    dk, dp = (torch.as_tensor(a, device=dev)
              for a in combine_for_device(None, None, ks.normalize))
    got = rmi_lookup.rmi_merged_lookup_cuda(*args, dk, dp, **kw)
    want = ref.rmi_merged_lookup_reference(*args, dk, dp, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0], base)
    st = ops.stack_shard_arrays([idx, idx], [ks.norm, ks.norm], dev)
    sargs = (torch.stack([q, q]), st["stage0"], *(st[k] for k in LEAF_FIELDS), st["keys"],
             torch.stack([dk, dk]), torch.stack([dp, dp]), st["shard_n"], st["shard_m"],
             st["shard_ratio"])
    skw = dict(hidden=(), max_window=st["max_window"])
    got = rmi_lookup.rmi_sharded_merged_lookup_cuda(*sargs, **skw)
    want = ref.rmi_sharded_merged_lookup_reference(*sargs, **skw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0][:, :3].tolist() == [[n, n, 8]] * 2
