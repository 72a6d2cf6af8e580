"""The port's §4 hash-model index and §5 Bloom filter against the
reference: `build_bloom` words and host probes, the Bloom probe's plain
twin against `bloom_probe_pallas` (interpret mode) and the reference's
XLA version, the hash-map builds, and the hash probe against the
reference's op on present, absent, float32-equal, NaN and out-of-span
queries — all exact (the outputs are bools and integers).

The reference's CPU build contracts ``q*w + b`` into one FMA, the port
rounds multiply and add separately (ROADMAP queue C entry 2); with n/4
leaves a stored key whose slot that rounding decides lands in another
slot.  The tests hold the port to the unfused formula everywhere and
allow the reference to differ only where fused and unfused rounding
differ.  The `cuda`-marked test holds both kernels against their twins
on the card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bloom as ref_bloom  # noqa: E402
from repro.core import learned_hash as ref_hash  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.bloom_probe import bloom_probe_pallas  # noqa: E402
from repro.kernels.hash_probe import hash_probe_pallas  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import bloom, learned_hash  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels import bloom_probe, hash_probe, ops, ref  # noqa: E402

N = 3_000
DISTS = ("gen_maps", "gen_lognormal", "gen_weblogs")
RATIOS = (0.75, 1.0, 1.25)
BLOOM_CASES = [(1 << 14, 3), (1 << 16, 7), (1 << 18, 10), ((1 << 31) + 64, 5)]


# --------------------------------------------------------------------------
# Bloom filter: host build and probes
# --------------------------------------------------------------------------

def _keys(kind, rng, n=2_000):
    if kind == "float":
        return rng.uniform(-180.0, 180.0, n)
    if kind == "int":
        return rng.integers(-(1 << 40), 1 << 40, n)
    if kind == "uint64":
        return rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    return np.array([f"https://example.org/{rng.integers(1 << 30)}/π{i}" for i in range(n // 8)])


@pytest.mark.parametrize("kind", ["float", "int", "uint64", "string"])
def test_build_bloom_contains_and_add_match_reference(kind):
    rng = np.random.default_rng(len(kind))
    keys = _keys(kind, rng)
    absent = _keys(kind, np.random.default_rng(99))
    for kw in (dict(fpr=0.01), dict(num_bits=4_000, num_hashes=5)):
        pb, rb = bloom.build_bloom(keys, **kw), ref_bloom.build_bloom(keys, **kw)
        assert (pb.num_bits, pb.num_hashes, pb.size_bytes) == (rb.num_bits, rb.num_hashes,
                                                               rb.size_bytes)
        assert pb.words.dtype == rb.words.dtype and np.array_equal(pb.words, rb.words)
        assert pb.contains(keys).all()
        q = np.concatenate([keys, absent])
        assert np.array_equal(pb.contains(q), rb.contains(q))
        pb.add(absent[:50])
        rb.add(absent[:50])
        assert np.array_equal(pb.words, rb.words)
        assert np.array_equal(pb.contains(q), rb.contains(q)) and pb.contains(absent[:50]).all()
    assert bloom.optimal_bits_per_key(0.01) == ref_bloom.optimal_bits_per_key(0.01)
    assert bloom.optimal_num_hashes(9.585) == ref_bloom.optimal_num_hashes(9.585)


def _mix32(h, seed):
    """The kernels' uint32 hash in NumPy (uint32 products wrap)."""
    h = h.astype(np.uint32) ^ np.uint32(seed * 0x9E3779B9 & 0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x7FEB352D)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x846CA68B)
    h ^= h >> np.uint32(16)
    return h


def _family_words(keys_u32, num_bits, k):
    """Words with every probe bit of ``keys_u32`` set under the kernels'
    own double hashing, ``h1 + i*h2`` wrapping at 2**32."""
    words = np.zeros(-(-num_bits // 32), np.uint32)
    h1, h2 = _mix32(keys_u32, 1), _mix32(keys_u32, 2) | np.uint32(1)
    for i in range(k):
        bit = (h1 + np.uint32(i) * h2) % np.uint32(num_bits)
        np.bitwise_or.at(words, (bit >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (bit & np.uint32(31)))
    return words


@functools.lru_cache(maxsize=None)
def _bloom_case(num_bits, k):
    rng = np.random.default_rng(num_bits % 1009 + k)
    members = rng.integers(0, 1 << 32, 400, dtype=np.uint32)
    words = _family_words(members, num_bits, k)
    q = np.concatenate([members, rng.integers(0, 1 << 32, 2_600, dtype=np.uint32),
                        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    return words, q, members.size


@pytest.mark.parametrize("num_bits,k", BLOOM_CASES)
def test_bloom_twin_matches_reference_kernel(num_bits, k):
    words, q, n_members = _bloom_case(num_bits, k)
    want = np.asarray(bloom_probe_pallas(jnp.asarray(q), jnp.asarray(words),
                                         num_bits=num_bits, k=k))
    assert np.array_equal(want, np.asarray(jax_ref.bloom_probe_reference(
        jnp.asarray(q), jnp.asarray(words), num_bits=num_bits, k=k)))
    bf = bloom.BloomFilter(num_bits=num_bits, num_hashes=k, words=words)
    got = ops.bloom_probe_op(bf, q, device="cpu")
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # the kernel family's own contract: every member present
    assert got[:n_members].all()
    # int32 bit patterns and uint32 tensors give the same answers
    t = torch.from_numpy(q)
    assert torch.equal(bloom.compile_bloom_probe(bf)(t), got)
    assert torch.equal(bloom_probe.bloom_probe_cuda(
        t.view(torch.int32), bloom.words_tensor(bf, "cpu"), num_bits=num_bits, k=k), got)


def test_bloom_probe_refuses_what_the_kernel_cannot_take():
    w = torch.zeros(4, dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_bits"):
        bloom_probe.bloom_probe_cuda(q, w, num_bits=2**32, k=3)
    with pytest.raises(ValueError, match="words must hold"):
        bloom_probe.bloom_probe_cuda(q, w, num_bits=129, k=3)


def test_kernel_hash_family_is_not_the_filters_own_like_the_reference():
    """ROADMAP queue C entry 11: `build_bloom` sets bits with `_mix64` of
    the uint64 key, the probe kernel tests bits of `_mix32` of a uint32
    fold, so a filter `build_bloom` made gives false negatives through
    `bloom_probe_op` — in both packages, bit for bit."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 31, 5_000).astype(np.uint64)  # fold is exact
    pb, rb = bloom.build_bloom(keys, fpr=0.01), ref_bloom.build_bloom(keys, fpr=0.01)
    assert (pb.num_bits, pb.num_hashes) == (47_936, 7)
    assert pb.contains(keys).all() and rb.contains(keys).all()
    folded = keys.astype(np.uint32)
    got = ops.bloom_probe_op(pb, folded, device="cpu").numpy()
    want = np.asarray(ref_ops.bloom_probe_op(rb, folded))
    assert np.array_equal(got, want)
    assert int(got.sum()) == 47   # 0.94% of stored keys found


# --------------------------------------------------------------------------
# hash-model index: builds
# --------------------------------------------------------------------------

def _slot_formula(idx, q, num_slots, fused):
    """The model hash's slots of normalized finite queries ``q`` in
    NumPy: multiply and add rounded separately (the port, the CUDA
    kernel), or as one FMA (the reference's XLA build on the CPU)."""
    f32 = np.float32
    w = np.float32(idx.stage0_params["w0"].reshape(()))
    b = np.float32(idx.stage0_params["b0"].reshape(()))

    def madd(a, x, c):
        if fused:
            return (a.astype(np.float64) * x.astype(np.float64) + c).astype(f32)
        return (a * x).astype(f32) + c

    p0 = madd(np.full(q.shape, w), q, b)
    leaf = np.clip(np.floor(p0 * f32(idx.num_leaves / idx.n)).astype(np.int64),
                   0, idx.num_leaves - 1)
    pos = np.clip(madd(idx.leaf_w[leaf], q, idx.leaf_b[leaf]), f32(0), f32(idx.n - 1))
    slots = (pos * f32(num_slots / idx.n)).astype(np.int64)
    return np.clip(slots, 0, num_slots - 1)


@functools.lru_cache(maxsize=None)
def _maps(dist, ratio, n=N):
    raw = getattr(datasets, dist)(n, seed=5)
    s = int(raw.size * ratio)
    port = learned_hash.build_model_hashmap(raw, s, device="cpu")
    refm = ref_hash.build_model_hashmap(raw, s)
    return raw, s, port, refm


HM_FIELDS = ("slot_key", "slot_next", "ovf_key", "ovf_next")


def _same_map(a, b):
    return (all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True) for f in HM_FIELDS)
            and (a.num_slots, a.max_chain, a.num_conflicts, a.num_empty)
            == (b.num_slots, b.max_chain, b.num_conflicts, b.num_empty))


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("dist", DISTS)
def test_hashmap_builds_match_reference(dist, ratio):
    raw, s, (hm, idx, ks), (rhm, ridx, rks) = _maps(dist, ratio)
    assert np.array_equal(ks.norm, rks.norm)
    for k in ("w0", "b0"):
        assert np.array_equal(idx.stage0_params[k], ridx.stage0_params[k])
    for k in ("leaf_w", "leaf_b"):
        assert np.array_equal(getattr(idx, k), getattr(ridx, k))
    assert idx.num_leaves == max(16, ks.n // 4)
    slots = learned_hash.model_hash_slots(idx, ks, raw, s, device="cpu")
    ref_slots = ref_hash.model_hash_slots(ridx, rks, raw, s)
    unfused = _slot_formula(idx, ks.norm, s, fused=False)
    fused = _slot_formula(idx, ks.norm, s, fused=True)
    assert np.array_equal(slots, unfused)
    assert not ((slots != ref_slots) & (fused == unfused)).any()
    # `build_hashmap` is the reference's: equal maps from equal slots
    assert _same_map(learned_hash.build_hashmap(raw, ref_slots, s), rhm)
    assert _same_map(hm, ref_hash.build_hashmap(raw, slots, s))
    if np.array_equal(slots, ref_slots):
        assert _same_map(hm, rhm)
    assert _same_map(learned_hash.build_random_hashmap(raw, s),
                     ref_hash.build_random_hashmap(raw, s))
    assert hm.load_stats == rhm.load_stats or not np.array_equal(slots, ref_slots)


def test_random_hash_u32_matches_reference():
    rng = np.random.default_rng(3)
    k = np.concatenate([rng.integers(0, 1 << 32, 4_000, dtype=np.uint32),
                        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    for s in (1, 7, 1_000, 65_536, (1 << 31) - 1):
        got = learned_hash.random_hash_u32(torch.from_numpy(k.astype(np.int64)), s)
        want = np.asarray(ref_hash.random_hash_u32_jax(jnp.asarray(k), s))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# hash-model index: the probe
# --------------------------------------------------------------------------

def _fma_decides(idx, qn, num_slots):
    """Queries whose slot differs between fused and unfused rounding."""
    out = np.zeros(qn.shape, bool)
    fin = np.isfinite(qn)
    out[fin] = (_slot_formula(idx, qn[fin], num_slots, fused=True)
                != _slot_formula(idx, qn[fin], num_slots, fused=False))
    return out


def _probe_queries(raw, rng):
    stored = raw[rng.choice(raw.size, 600)]
    absent = np.setdiff1d(rng.uniform(raw[0], raw[-1], 600), raw)
    span = raw[-1] - raw[0]
    # NaN, infinite and far out-of-span queries, then two just past the
    # span's ends (the upper one rounds onto the last key in float32)
    edges = np.array([np.nan, np.inf, -np.inf, raw[0] - span, raw[-1] + span,
                      -1e300, 1e300, raw[0] - 1e-9 * span, raw[-1] + 1e-9 * span])
    return stored, absent, edges


def _f32_twins(raw, ks):
    """Raw keys absent from ``raw`` whose float32 normalization equals a
    stored key's (the next float64 above it, where that collides)."""
    up = np.nextafter(raw, np.inf)
    hit = (ks.normalize(up) == ks.norm) & ~np.isin(up, raw)
    return up[hit]


@pytest.mark.parametrize("dist", DISTS)
def test_hash_probe_matches_reference(dist):
    raw, s, (hm, idx, ks), (rhm, ridx, rks) = _maps(dist, 1.0)
    rng = np.random.default_rng(8)
    stored, absent, edges = _probe_queries(raw, rng)
    twins = _f32_twins(raw, ks)[:100]
    q = np.concatenate([stored, absent, twins, edges])
    # the port's own map: every stored key found, no absent one
    got = ops.hash_probe_op(hm, idx, ks, q, device="cpu").numpy()
    assert got[:stored.size].all() and not got[stored.size:stored.size + absent.size].any()
    assert got[stored.size + absent.size:][:twins.size].all()   # queue C entry 12
    assert got[-edges.size:].tolist() == [False] * 8 + [True]
    # a reference-built map carried across, against the reference's op
    pm = (convert.hashmap_from_reference(rhm), convert.index_from_reference(ridx),
          convert.keyset_from_reference(rks))
    got = ops.hash_probe_op(*pm, q, device="cpu").numpy()
    want = np.asarray(ref_ops.hash_probe_op(rhm, ridx, rks, q))
    fma = _fma_decides(idx, ks.normalize(q), s)
    assert np.array_equal(got[~fma], want[~fma])
    assert want[:stored.size].all()


@pytest.mark.parametrize("dist", DISTS)
def test_hash_twin_matches_pallas_kernel_on_the_same_tables(dist):
    raw, s, (hm, idx, ks), _ = _maps(dist, 1.25)
    rng = np.random.default_rng(9)
    stored, absent, edges = _probe_queries(raw, rng)
    q = ks.normalize(np.concatenate([stored, absent, _f32_twins(raw, ks)[:50], edges]))
    tabs = ops.hash_probe_tensors(hm, idx, ks, "cpu")
    trips = max(0, hm.max_chain - 1)
    kw = dict(n=idx.n, num_leaves=idx.num_leaves, num_slots=s)
    got = ref.hash_probe_reference(torch.as_tensor(q), *tabs, trips=trips, **kw).numpy()
    s0 = tabs[0].numpy()
    jarrs = [jnp.asarray(a.numpy()) for a in tabs[1:]]
    want = np.asarray(hash_probe_pallas(
        jnp.asarray(q), jnp.asarray(s0[:1].reshape(1, 1)), jnp.asarray(s0[1:]), *jarrs,
        trips=trips, **kw))
    # where XLA's FMA picks another slot the two read different slots
    fma = _fma_decides(idx, q, s)
    assert np.array_equal(got[~fma], want[~fma])
    assert got[:stored.size].all() and got[-edges.size:].tolist() == [False] * 8 + [True]
    # fewer trips than the longest chain can only lose hits
    short = ref.hash_probe_reference(torch.as_tensor(q), *tabs, trips=0, **kw).numpy()
    assert not (short & ~got).any()


def test_hash_probe_with_no_overflow_and_zero_trips():
    raw = datasets.gen_maps(400, seed=3)
    s = 1 << 20   # so sparse that every key has its own slot
    hm, idx, ks = learned_hash.build_model_hashmap(raw, s, device="cpu")
    rhm, ridx, rks = ref_hash.build_model_hashmap(raw, s)
    assert hm.max_chain == 1 and hm.ovf_key.size == 1 and hm.ovf_next.tolist() == [-1]
    q = np.concatenate([raw, raw + 1e-3, [np.nan]])
    got = ops.hash_probe_op(hm, idx, ks, q, device="cpu").numpy()
    assert got[:raw.size].all() and not got[raw.size:].any()
    want = np.asarray(ref_ops.hash_probe_op(rhm, ridx, rks, q))
    assert np.array_equal(got, want)


def test_compile_hash_lookup_walks_chains_in_the_float64_frame():
    raw, s, (hm, idx, ks), (rhm, _, _) = _maps("gen_lognormal", 0.75)
    rnd = learned_hash.build_random_hashmap(raw, s)
    rng = np.random.default_rng(4)
    stored, absent, _ = _probe_queries(raw, rng)
    q = np.concatenate([stored, absent])
    slots = learned_hash.random_hash_u64(q.view(np.uint64), s)
    fn = learned_hash.compile_hash_lookup(
        rnd, lambda rq: torch.as_tensor(slots), device="cpu")
    got = fn(torch.as_tensor(q)).numpy()
    assert got[:stored.size].all() and not got[stored.size:].any()
    rfn = ref_hash.compile_hash_lookup(
        ref_hash.build_random_hashmap(raw, s), lambda rq: jnp.asarray(slots))
    assert np.array_equal(got, np.asarray(rfn(jnp.asarray(q))))


def test_hash_probe_refuses_what_the_kernel_cannot_take():
    z = torch.zeros(4)
    zi = torch.zeros(4, dtype=torch.int32)
    args = (z, torch.zeros(3), z, z, z, zi, z, zi)
    if torch.cuda.is_available():
        args = tuple(a.cuda() for a in args)
    else:  # the checks run before the launch; a meta tensor never launches
        args = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="linear stage-0"):
        hash_probe.hash_probe_cuda(*args, n=4, num_leaves=4, num_slots=4, trips=0)


@pytest.mark.slow
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("dist", DISTS)
def test_hash_builds_and_probe_at_50k(dist, ratio):
    raw, s, (hm, idx, ks), (rhm, ridx, rks) = _maps(dist, ratio, n=50_000)
    slots = learned_hash.model_hash_slots(idx, ks, raw, s, device="cpu")
    assert np.array_equal(slots, _slot_formula(idx, ks.norm, s, fused=False))
    assert _same_map(hm, ref_hash.build_hashmap(raw, slots, s))
    assert ops.hash_probe_op(hm, idx, ks, raw, device="cpu").all()


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS)
def test_probe_kernels_match_twins_on_card(dist):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    raw, s, (hm, idx, ks), _ = _maps(dist, 1.0)
    stored, absent, edges = _probe_queries(raw, np.random.default_rng(1))
    q = np.concatenate([stored, absent, _f32_twins(raw, ks), edges])
    tabs = ops.hash_probe_tensors(hm, idx, ks, dev)
    kw = dict(n=idx.n, num_leaves=idx.num_leaves, num_slots=s, trips=max(0, hm.max_chain - 1))
    qt = torch.as_tensor(ks.normalize(q), device=dev)
    before = hash_probe.LAUNCHES["hash_probe_cuda"]
    got = hash_probe.hash_probe_cuda(qt, *tabs, **kw)
    assert hash_probe.LAUNCHES["hash_probe_cuda"] == before + 1
    assert torch.equal(got, ref.hash_probe_reference(qt, *tabs, **kw))
    assert torch.equal(got.cpu(), ops.hash_probe_op(hm, idx, ks, q, device="cpu"))
    for num_bits, k in BLOOM_CASES:
        words, bq, _ = _bloom_case(num_bits, k)
        w = torch.from_numpy(words.view(np.int32)).to(dev)
        qb = torch.from_numpy(bq.view(np.int32)).to(dev)
        kern = bloom_probe.bloom_probe_cuda(qb, w, num_bits=num_bits, k=k)
        assert torch.equal(kern, ref.bloom_probe_reference(qb, w, num_bits=num_bits, k=k))
