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
* The kernel failover on the card: an injected ``kernel.dispatch``
  reroutes B1 (the `cuda_fused` service) and B4 (the `sharded_fused`
  service) onto their plain twins with bit-identical answers, and a
  library that fails to build makes the op raise with nothing rerouted.
* The paper's other structures, plain torch on the card against the
  same calls on the CPU: the string index (every stored string exact
  under the three strategies, ranks equal to the CPU's), the B-Tree
  (equal to ``np.searchsorted``), the learned Bloom's GRU logits, and
  the pipeline's document lookup (equal to the oracle).
* The MoE FFN (`models/moe.py`, plain torch): the dispatch on the card
  equal to the CPU's bit for bit, `moe_ffn` in bf16 repeating bit for bit
  and near its float32 products under the same dispatch, and the reduced
  olmoe-1b-7b's loss and gradients on the card against the CPU.
* The recurrent families (`models/hybrid.py`, `models/xlstm_model.py`,
  plain torch but for jamba's attention through B9): the reduced jamba
  and xlstm served and trained on the card against the CPU.
* The vlm and audio families (`models/vlm.py`, `models/encdec.py`): B9
  at cross-attention shapes (Sq != Sk, full mask) against its twin, and
  the reduced llava and seamless served and trained on the card against
  the CPU.
* The attention gradient (B9's backward kernel): against
  `ref.mha_backward_reference` on a small matrix (bf16, the tensor-core
  kernels, also within 1e-3 relative L2), bit-identical on a repeat
  launch, and one reduced yi-6b train step on the card (both
  attention kernels, D = 16 zero-padded to 32) against the same step on
  the CPU.

Without a card every test here skips, except
`test_build_failure_raises_before_the_failover`,
`test_launch_error_on_card_raises_and_nothing_reroutes` and
`test_injected_fault_on_card_still_reroutes`, which hold the failover's
card rules on the CPU with a stand-in for the card tensor: a build
failure or a launch error raises, and only an injected fault reroutes.
"""

import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import faults  # noqa: E402
from repro_torch.core import RMIConfig, build_rmi, make_keyset  # noqa: E402
from repro_torch.core.rmi import LEAF_FIELDS  # noqa: E402
from repro_torch.data import gen_maps  # noqa: E402
from repro_torch.index_service import (  # noqa: E402
    IndexService,
    ServiceConfig,
    ShardedIndexService,
)
from repro_torch.index_service.delta import combine_for_device  # noqa: E402
from repro_torch.kernels import bloom_probe, nvcc, ops, ref, rmi_lookup  # noqa: E402
from repro_torch.kernels.ref import mix32  # noqa: E402
from repro_torch.obs.metrics import default_registry  # noqa: E402

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


# ---- the kernel failover ------------------------------------------------------

def _service(kind, dev):
    base = gen_maps(20_000, seed=4)
    if kind == "single":
        svc = IndexService(base, ServiceConfig(strategy="cuda_fused", delta_capacity=4096),
                           device=dev)
    else:
        svc = ShardedIndexService(base, ServiceConfig(
            num_shards=4, strategy="sharded_fused", delta_capacity=4096), device=dev)
    rng = np.random.default_rng(1)
    svc.insert(np.setdiff1d(rng.uniform(base[0], base[-1], 600), base))
    svc.delete(rng.choice(base, 300, replace=False))
    q = np.concatenate([rng.choice(base, 3000), rng.uniform(base[0], base[-1], 1000)])
    return svc, q


def _failure_counts():
    reg = default_registry()
    return [int(reg.counter(k).value) for k in (
        "kernel_failover", "kernel_failover.errors", "kernel_failover.recoveries")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,launch", [("single", "rmi_merged_lookup_cuda"),
                                         ("sharded", "rmi_sharded_merged_lookup_cuda")])
def test_injected_fault_reroutes_on_card_bit_identical(kind, launch):
    dev = _card()
    ops.reset_failover()
    svc, q = _service(kind, dev)
    want = svc.get(q), svc.lookup_batch(q)
    before = _failure_counts()
    n0 = rmi_lookup.LAUNCHES[launch]
    with faults.inject(faults.FaultSchedule({"kernel.dispatch": 2})):
        got = svc.get(q), svc.lookup_batch(q)
    assert rmi_lookup.LAUNCHES[launch] == n0  # both reads ran on the twin
    assert [a - b for a, b in zip(_failure_counts(), before)] == [1, 2, 0]
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    assert any(r["disabled"] for r in ops.failover_summary().values())
    for _ in range(ops.FAILOVER_REPROBE_EVERY):
        assert torch.equal(svc.lookup_batch(q), want[1])
    assert rmi_lookup.LAUNCHES[launch] > n0  # the re-probe brought the kernel back
    assert [a - b for a, b in zip(_failure_counts(), before)] == [1, 2, 1]
    assert not any(r["disabled"] for r in ops.failover_summary().values())
    ops.reset_failover()


def _failing_build(source, flags=nvcc.NVCC_FLAGS):
    raise subprocess.CalledProcessError(1, ["nvcc", str(source)], "", "error: stand-in")


RULE_A_ENTRIES = (
    "snapshot_merged_cuda_fused", "snapshot_merged_cuda", "snapshot_merged_sharded_fused",
    "snapshot_base_cuda", "rmi_merged_lookup_op", "rmi_scan_range_op", "rmi_scan_page_op",
    "rmi_sharded_routed_lookup_op", "rmi_sharded_scan_page_op",
)


def _rule_a_call(entry):
    """One entry of a wrapped kernel, on CPU tensors: the five ops and
    the snapshot's merged and base closures."""
    from repro_torch.index_service.scan import device_scan_plan
    base = gen_maps(4_000, seed=9)
    single = IndexService(base, ServiceConfig(strategy="cuda_fused"), device="cpu")
    sharded = ShardedIndexService(base, ServiceConfig(num_shards=3, strategy="sharded_fused"),
                                  device="cpu")
    snap = single._mgr.current()
    q = torch.as_tensor(snap.keys.norm[::5].copy())
    dk, dp = (torch.as_tensor(a) for a in combine_for_device(None, None, snap.keys.normalize))
    plan = (torch.tensor([0, 64], dtype=torch.int32),
            *(torch.as_tensor(a) for a in device_scan_plan(single._pin(), snap.keys.normalize)),
            torch.tensor([100], dtype=torch.int32))
    return {
        "snapshot_merged_cuda_fused": lambda: single.get(base[:64]),
        "snapshot_merged_cuda": lambda: snap.merged_lookup_fn("cuda")(q, dk, dp),
        "snapshot_merged_sharded_fused": lambda: snap.merged_lookup_fn("sharded_fused")(
            q, dk, dp),
        "snapshot_base_cuda": lambda: snap.base_lookup_fn("cuda_fused")(q),
        "rmi_merged_lookup_op": lambda: ops.rmi_merged_lookup_op(
            snap.index, snap.keys.norm, q, dk, dp),
        "rmi_scan_range_op": lambda: single.scan_batch(base[10], base[900], 64),
        "rmi_scan_page_op": lambda: snap.scan_page_fn("cuda_fused", 64)(*plan),
        "rmi_sharded_routed_lookup_op": lambda: sharded.get(base[:64]),
        "rmi_sharded_scan_page_op": lambda: sharded.scan_batch(base[10], base[900], 64),
    }[entry]


@pytest.mark.parametrize("entry", RULE_A_ENTRIES)
def test_build_failure_raises_before_the_failover(entry, monkeypatch):
    """On the CPU, with every tensor standing in for a card tensor: a
    library that does not build raises from the op, is never retried or
    rerouted, and `failover_summary()` stays empty."""
    call = _rule_a_call(entry)
    ops.reset_failover()
    before = _failure_counts()
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(nvcc, "_LIBS", {})
    monkeypatch.setattr(nvcc, "build", _failing_build)
    with faults.inject(faults.FaultSchedule({})) as sched:
        with pytest.raises(subprocess.CalledProcessError):
            call()
    assert sched.probes.get("kernel.dispatch", 0) == 0
    assert ops.failover_summary() == {}
    assert _failure_counts() == before


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return bool(np.array_equal(a, b))


@pytest.mark.parametrize("entry", RULE_A_ENTRIES)
def test_launch_error_on_card_raises_and_nothing_reroutes(entry, monkeypatch):
    """On the CPU, with every tensor standing in for a card tensor and
    the library loaded: an error of the kernel that is not an injected
    fault (a launch error, a refused input) raises from the op on its
    first attempt, is not counted as a failover, and reroutes nothing."""
    call = _rule_a_call(entry)
    ops.reset_failover()
    before = _failure_counts()
    real = faults.maybe
    attempts = []

    def launch_error(name, exc=faults.InjectedFault):
        if name == "kernel.dispatch":
            attempts.append(name)
            raise RuntimeError("stand-in launch error")
        return real(name, exc)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(nvcc, "load", lambda *a, **k: None)
    monkeypatch.setattr(faults, "maybe", launch_error)
    with pytest.raises(RuntimeError, match="stand-in launch error") as err:
        call()
    assert not isinstance(err.value, faults.InjectedFault)
    assert len(attempts) == 1   # no retry
    assert not any(r["disabled"] for r in ops.failover_summary().values())
    assert _failure_counts() == before


@pytest.mark.parametrize("entry", RULE_A_ENTRIES)
def test_injected_fault_on_card_still_reroutes(entry, monkeypatch):
    """The same stand-in for the card: two injected ``kernel.dispatch``
    faults retry once and then reroute onto the twin, with the answer
    unchanged."""
    call = _rule_a_call(entry)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(nvcc, "load", lambda *a, **k: None)
    want = call()
    ops.reset_failover()
    before = _failure_counts()
    with faults.inject(faults.FaultSchedule({"kernel.dispatch": 2})):
        got = call()
    assert _same(got, want)
    assert [a - b for a, b in zip(_failure_counts(), before)] == [1, 2, 0]
    assert any(r["disabled"] for r in ops.failover_summary().values())
    ops.reset_failover()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_build_failure_raises_on_card_and_nothing_reroutes(kind, monkeypatch):
    dev = _card()
    svc, q = _service(kind, dev)
    ops.reset_failover()
    monkeypatch.setattr(nvcc, "_LIBS", {})
    monkeypatch.setattr(nvcc, "build", _failing_build)
    for read in (lambda: svc.get(q), lambda: svc.lookup_batch(q),
                 lambda: svc.scan_batch(q.min(), q.max(), 256)):
        with pytest.raises(subprocess.CalledProcessError):
            read()
    assert ops.failover_summary() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(), (8,)])
def test_string_lookup_on_card_equals_the_cpu(hidden):
    from repro_torch.core import compile_string_lookup, make_vector_keyset, tokenize
    from repro_torch.data import gen_webdocs
    dev = _card()
    vks = make_vector_keyset(tokenize(gen_webdocs(5_000), 16))
    idx = build_rmi(vks, RMIConfig(num_leaves=64, stage0_hidden=hidden,
                                   stage0_train_steps=60), device="cpu")
    absent = tokenize([f"{c}zz/999999x" for c in "abcdefghijklmnopqrstuvwxyz"], 16)
    q = np.concatenate([vks.raw, absent])
    for strategy in ("binary", "biased", "quaternary"):
        on_card = compile_string_lookup(idx, vks, strategy, device=dev)(
            torch.as_tensor(q, device=dev)).cpu().numpy()
        on_cpu = compile_string_lookup(idx, vks, strategy, device="cpu")(
            torch.as_tensor(q)).numpy()
        assert np.array_equal(on_card, on_cpu), strategy
        assert np.array_equal(on_card[:vks.n], np.arange(vks.n)), strategy


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 64, 256])
def test_btree_on_card_matches_searchsorted(page):
    from repro_torch.core import build_btree, compile_btree_lookup
    dev = _card()
    rng = np.random.default_rng(page)
    keys = np.sort(np.repeat(rng.uniform(0, 1, 20_000).astype(np.float32),
                             rng.integers(1, 6, 20_000)))
    q = np.concatenate([keys, rng.uniform(-0.1, 1.1, 1 << 16).astype(np.float32)])
    got = compile_btree_lookup(build_btree(keys, page), keys, device=dev)(
        torch.as_tensor(q, device=dev)).cpu().numpy()
    assert np.array_equal(got, np.searchsorted(keys, q))


@pytest.mark.cuda
def test_gru_logits_on_card_match_the_cpu():
    from repro_torch.core import GRUSpec, tokenize
    from repro_torch.core import learned_bloom
    from repro_torch.data import gen_urls
    dev = _card()
    keys, nonkeys = gen_urls(500, 1_500)
    toks = torch.as_tensor(tokenize(keys + nonkeys, 32).astype(np.int32))
    params = learned_bloom.gru_init(GRUSpec(), torch.Generator().manual_seed(0), "cpu")
    on_cpu = learned_bloom.gru_logits(params, toks)
    on_card = learned_bloom.gru_logits({k: v.to(dev) for k, v in params.items()},
                                       toks.to(dev)).cpu()
    torch.testing.assert_close(on_card, on_cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_document_lookup_on_card_equals_the_oracle():
    from repro_torch.data.pipeline import make_synthetic_corpus
    dev = _card()
    corpus = make_synthetic_corpus(10_000_000, seed=0, device=dev)
    offsets = np.random.default_rng(5).integers(0, 10_000_000, 1 << 20)
    want = np.searchsorted(corpus.doc_starts, offsets, side="right") - 1
    assert np.array_equal(corpus.lookup_documents(offsets), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_attention_backward_kernel_matches_twin_and_repeats_bit_for_bit(dtype, tol):
    from repro_torch.kernels import flash_attention as fa
    _card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dtype)
    for b, hq, hkv, s, d in ((1, 4, 2, 77, 32), (2, 8, 2, 130, 64), (1, 8, 1, 64, 128)):
        for causal in (True, False):
            q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dt)
                       for h in (hq, hkv, hkv))
            out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
            d_out = torch.randn(out.shape, generator=g, device=dev).to(dt)
            got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=causal)
            want = ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=causal)
            torch.cuda.synchronize()
            for x, y, w in zip(got, again, want):
                assert x.dtype == dt and torch.equal(x, y)
                err = float((x.float() - w.float()).abs().max())
                assert err <= tol * float(w.float().abs().max()), (b, hq, hkv, s, d, causal)
                if dtype == "bfloat16":
                    # P and dS split into bf16 halves: within 1e-3 relative L2
                    rel = float((x.float() - w.float()).norm() / w.float().norm())
                    assert rel <= 1e-3, (b, hq, hkv, s, d, causal, rel)


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_the_cpu():
    """The reduced yi-6b (float32, TF32 off) on the card, through both
    attention kernels, against the CPU's plain loop: the loss within
    1e-5 relative and every gradient within 1e-4 x its leaf's max; one
    `make_train_step` step launches the forward kernel twice a layer
    (forward and remat recompute) and the backward kernel once."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("yi-6b", reduced=True), dtype="float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    out = {}
    for name in ("cpu", "cuda"):
        api = get_model(cfg, name)
        params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        params = tree_map(lambda t: t.to(name), params)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=name),
                 "labels": torch.as_tensor(toks[:, 1:], device=name)}
        loss, _, grads = loss_and_grads(api.loss, params, batch)
        step = make_train_step(api.loss, OptimizerConfig(lr=1e-3, warmup_steps=1))
        fa.reset_launch_counts()
        step(params, adamw_init(params), batch)
        out[name] = (float(loss), [g.cpu() for g in tree_leaves(grads)], dict(fa.LAUNCHES))
    assert out["cuda"][2] == {"flash_attention_cuda": 2 * cfg.num_layers,
                              "flash_attention_bwd_cuda": cfg.num_layers}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for x, y in zip(out["cuda"][1], out["cpu"][1]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


# ---------------------------------------------------------------------------
# the MoE FFN (models/moe.py): plain torch, deterministic on the card
# ---------------------------------------------------------------------------

def _moe_inputs(t, e, k, d, dev, seed=0):
    """(x bf16 (T, D), float32 scores, bf16 gate, expert ids) on ``dev``,
    the ids and gate by the port's `_top_k`."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t, d), generator=g).to(torch.bfloat16)
    scores = torch.softmax(torch.randn((t, e), generator=g) * 2, dim=-1)
    gate, eidx = moe._top_k(scores, k)
    gate = (gate / gate.sum(-1, keepdim=True)).to(torch.bfloat16)
    return [a.to(dev) for a in (x, scores, gate, eidx)]


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["sort", "cdf"])
def test_moe_dispatch_on_card_equals_the_cpu_bit_for_bit(dispatch):
    """`_dispatch_one_group` at olmoe's routing (E 64, top-8) over 4,096
    tokens, capacity factor 1.0 (each expert holds its mean load, so the
    busier ones drop): buffers, destinations, tokens and gates on the
    card equal the CPU's."""
    from repro_torch.models import moe
    dev = _card()
    t, e, k = 4096, 64, 8
    capacity = max(1, int(t * k / e * 1.0))
    out = {}
    for where in ("cpu", dev):
        args = _moe_inputs(t, e, k, 256, where)
        out[str(where)] = [a.cpu() for a in moe._dispatch_one_group(
            *args, num_experts=e, capacity=capacity, dispatch=dispatch)]
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert torch.equal(got, want)
    assert bool((out["cpu"][3] == 0).any())   # some entries drop


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["sort", "cdf"])
def test_moe_ffn_on_card_repeats_bit_for_bit(dispatch):
    """`moe_ffn` in bf16 on the card twice, the second time with any host
    synchronisation an error: the same output bits and aux; within 2e-2 x
    max of the float32 expert products and combine under the same
    dispatch."""
    from repro_torch.models import moe
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    d, e, f = 512, 16, 256
    x = torch.randn((2, 512, d), generator=g).to(torch.bfloat16).to(dev)
    ws = [(torch.randn(s, generator=g) / s[-2] ** 0.5).to(torch.bfloat16).to(dev)
          for s in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    kw = dict(experts_per_token=4, capacity_factor=1.25, dispatch=dispatch)
    y1, a1 = moe.moe_ffn(x, *ws, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # no read-back to the host inside
    try:
        y2, a2 = moe.moe_ffn(x, *ws, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y1, y2)
    assert all(torch.equal(a1[n], a2[n]) for n in a1)
    xt = x.reshape(-1, d)
    scores = moe._scores(xt, ws[0])
    gate, eidx = moe._gates(scores, 4, xt.dtype)
    capacity = max(1, int(xt.shape[0] * 4 / e * 1.25))
    buf, dest, st, sg = moe._dispatch_one_group(xt, scores, gate, eidx, num_experts=e,
                                                capacity=capacity, dispatch=dispatch)
    y32 = moe._experts(buf[None].float(), *(w.float() for w in ws[1:]))[0]
    y32 = moe._combine_one(y32.reshape(e * capacity, d), dest, st, sg.float(), xt.shape[0])
    assert float((y1.reshape(-1, d).float() - y32).abs().max()) <= 2e-2 * float(y32.abs().max())


@pytest.mark.cuda
def test_reduced_moe_gradient_on_card_matches_the_cpu():
    """The reduced olmoe-1b-7b (float32, TF32 off) on the card against the
    CPU: the loss within 1e-5 relative, the aux loss within 1e-6 and every
    gradient within 1e-4 x its leaf's max."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b", reduced=True), dtype="float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    out = {}
    for name in ("cpu", "cuda"):
        api = get_model(cfg, name)
        params = tree_map(lambda t: t.to(name),
                          get_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=name),
                 "labels": torch.as_tensor(toks[:, 1:], device=name)}
        loss, metrics, grads = loss_and_grads(api.loss, params, batch)
        out[name] = (float(loss), float(metrics["aux"]), [g.cpu() for g in tree_leaves(grads)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-6 * abs(out["cpu"][1])
    for x, y in zip(out["cuda"][2], out["cpu"][2]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


# ---------------------------------------------------------------------------
# the recurrent families (models/hybrid.py, models/xlstm_model.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_reduced_recurrent_model_on_card_matches_the_cpu(arch):
    """The reduced jamba and xlstm (float32, TF32 off) on the card against
    the CPU: prefill's logits and 6 decode steps' within 1e-4 x max, the
    loss within 1e-5 relative and every gradient within 1e-4 x its
    leaf's max; jamba's attention layers launch B9 once a prefill and
    twice (remat) forward and once backward a training step."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    attn_layers = cfg.num_layers // cfg.attn_period if cfg.family == "hybrid" else 0
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    base = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    out = {}
    for name in ("cpu", "cuda"):
        api = get_model(cfg, name)
        params = tree_map(lambda t: t.to(name), base)
        t = torch.as_tensor(toks, device=name)
        fa.reset_launch_counts()
        logits = [api.prefill(params, {"tokens": t[:, :24]})[0]]
        cache = api.init_cache(2, 8)
        for i in range(6):
            step, cache = api.decode(params, cache, t[:, i])
            logits.append(step)
        prefill_launches = fa.LAUNCHES["flash_attention_cuda"]
        fa.reset_launch_counts()
        loss, _, grads = loss_and_grads(api.loss, params, {"tokens": t[:, :-1],
                                                          "labels": t[:, 1:]})
        out[name] = ([x.cpu() for x in logits], float(loss),
                     [g.cpu() for g in tree_leaves(grads)], prefill_launches, dict(fa.LAUNCHES))
    assert out["cuda"][3] == attn_layers
    assert out["cuda"][4] == {"flash_attention_cuda": 2 * attn_layers,
                              "flash_attention_bwd_cuda": attn_layers}
    for x, y in zip(out["cuda"][0], out["cpu"][0]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1])
    for x, y in zip(out["cuda"][2], out["cpu"][2]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


# ---------------------------------------------------------------------------
# cross-attention (B9 at Sq != Sk) and the vlm and audio families
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_attention_kernel_at_sq_ne_sk_matches_twin_on_card(dtype, tol):
    """B9's forward at cross-attention shapes (full mask, Sq != Sk):
    seamless's cross shape, a ragged one, Sq > Sk, D = 32 and 128, one
    query, within the reference's tolerance of the plain twin, the
    log-sum-exp within 1e-5; causal at Sq != Sk raises before anything
    launches."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(13)
    dt = getattr(torch, dtype)
    for b, hq, hkv, sq, sk, d in ((2, 16, 16, 256, 3072, 64), (2, 4, 2, 77, 300, 64),
                                  (1, 8, 2, 1000, 130, 64), (1, 4, 1, 33, 65, 32),
                                  (1, 8, 2, 129, 63, 128), (2, 4, 4, 1, 500, 64)):
        q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
                for _ in range(2))
        fa.reset_launch_counts()
        got, lse = fa.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
        assert fa.LAUNCHES["flash_attention_cuda"] == 1
        want, want_lse = ref.mha_reference_lse(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == dt
        assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), (b, hq, sq, sk, d)
        assert torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        fa.flash_attention_cuda(q, k, v, causal=True)
    assert fa.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_bwd_cuda": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_attention_backward_kernel_at_sq_ne_sk_matches_twin_on_card(dtype, tol):
    """B9's backward at cross-attention shapes (full mask, Sq != Sk):
    seamless's cross shape, a ragged one (77 queries over 1,000 keys),
    GQA with Sq > Sk, D = 32 and 128, one query, against
    `ref.mha_backward_reference` (bf16 also within 1e-3 relative L2),
    bit-identical on a repeat launch; through `FlashAttention` one
    forward and one backward launch."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(29)
    dt = getattr(torch, dtype)
    for b, hq, hkv, sq, sk, d in ((2, 16, 16, 256, 3072, 64), (1, 4, 2, 77, 1000, 64),
                                  (2, 8, 2, 1000, 130, 128), (1, 4, 1, 33, 65, 32),
                                  (2, 4, 4, 1, 500, 64)):
        q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dt)
                for _ in range(2))
        with torch.no_grad():
            out, lse = fa.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
        d_out = torch.randn(out.shape, generator=g, device=dev).to(dt)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=False)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, d_out, causal=False)
        want = ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=False)
        torch.cuda.synchronize()
        shape = (b, hq, hkv, sq, sk, d)
        for x, y, w, like in zip(got, again, want, (q, k, v)):
            assert x.dtype == dt and x.shape == like.shape and torch.equal(x, y), shape
            err = float((x.float() - w.float()).abs().max())
            assert err <= tol * float(w.float().abs().max()), (shape, err)
            if dtype == "bfloat16":
                rel = float((x.float() - w.float()).norm() / w.float().norm())
                assert rel <= 1e-3, (shape, rel)
        fa.reset_launch_counts()
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        fa.flash_attention_cuda(qg, kg, vg, causal=False).backward(d_out)
        assert fa.LAUNCHES == {"flash_attention_cuda": 1, "flash_attention_bwd_cuda": 1}
        for x, w in zip((qg.grad, kg.grad, vg.grad), got):
            assert torch.equal(x, w), shape


def _multimodal_inputs(cfg, rng, b, s, where):
    """The reduced vlm's patches or the audio family's frames (unit
    normal, float32) beside ``s`` text tokens."""
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)), dtype=torch.int32,
                           device=where)
    if cfg.family == "vlm":
        extra = {"patches": rng.standard_normal((b, cfg.frontend_tokens, cfg.frontend_dim))}
    else:
        extra = {"frames": rng.standard_normal((b, s, cfg.frontend_dim))}
    return toks, {k: torch.as_tensor(a, dtype=torch.float32, device=where)
                  for k, a in extra.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "seamless-m4t-large-v2"])
def test_reduced_multimodal_model_on_card_matches_the_cpu(arch):
    """The reduced llava and seamless (float32, TF32 off) on the card
    against the CPU: prefill's logits and 6 decode steps' within 1e-4 x
    max, the loss within 1e-5 relative and every gradient within 1e-4 x
    its leaf's max (seamless at equal source and target lengths, as the
    registry's train spec); B9 launches once an attention a prefill
    (seamless: encoder, decoder self and cross), twice (remat) forward
    and once backward a training step, and no plain attention."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model, transformer
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    attn = cfg.num_layers + (cfg.num_encoder_layers + cfg.num_layers
                             if cfg.family == "audio" else 0)
    base = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    out = {}
    for name in ("cpu", "cuda"):
        api = get_model(cfg, name)
        params = tree_map(lambda t: t.to(name), base)
        toks, extra = _multimodal_inputs(cfg, np.random.default_rng(0), 2, 24, name)
        fa.reset_launch_counts()
        logits, cache = api.prefill(params, {"tokens": toks[:, :24], **extra})
        prefill_launches = fa.LAUNCHES["flash_attention_cuda"]
        full = transformer.extend_cache(cache, cache["len"] + 8)
        steps = [logits]
        for i in range(6):
            step, full = api.decode(params, full, toks[:, i])
            steps.append(step)
        fa.reset_launch_counts()
        loss, _, grads = loss_and_grads(api.loss, params, {"tokens": toks[:, :-1],
                                                          "labels": toks[:, 1:], **extra})
        out[name] = ([x.cpu() for x in steps], float(loss), [g.cpu() for g in tree_leaves(grads)],
                     prefill_launches, dict(fa.LAUNCHES))
    assert out["cuda"][3] == attn
    assert out["cuda"][4] == {"flash_attention_cuda": 2 * attn, "flash_attention_bwd_cuda": attn}
    for x, y in zip(out["cuda"][0], out["cpu"][0]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1])
    for x, y in zip(out["cuda"][2], out["cpu"][2]):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
