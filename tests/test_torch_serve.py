"""The port's serving path against the reference: the engine scenarios of
`tests/test_serve_engine.py` (backpressure without a slot leak, page
growth, stalls and truncation, the learning prefix screen) run through
both engines on the same op stream with a stub model, with the same
`Request` results, counters and page accounting; the reduced yi-6b in
float32 through both engines, token for token; and `PagedKVAllocator`
alloc/free streams through both packages with equal `translate`
(binary and the kernel strategies' plain twins against the reference's
interpret-mode kernels), `scan`, `scan_batch` and `request_pages`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.bloom import build_bloom as jax_build_bloom  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve.kvcache import PagedKVAllocator as JaxAllocator  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.bloom import build_bloom  # noqa: E402
from repro_torch.index_service import REFERENCE_STRATEGY  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine, kvcache  # noqa: E402

VOCAB = 32
COUNTERS = ("engine.admitted", "engine.deferred", "engine.kv_grow_pages",
            "engine.kv_stalls", "engine.truncations", "engine.prefix_cache_hits")


class _JaxStub:
    """The reference tests' lockstep model: next token = token + 1."""

    def init_cache(self, slots, max_len):
        return jnp.zeros((slots, 4), jnp.float32)

    def decode(self, params, cache, tokens):
        return jax.nn.one_hot((tokens + 1) % VOCAB, VOCAB), cache


class _TorchStub:
    device = torch.device("cpu")

    def init_cache(self, slots, max_len):
        return torch.zeros((slots, 4))

    def decode(self, params, cache, tokens):
        return torch.nn.functional.one_hot((tokens.long() + 1) % VOCAB, VOCAB).float(), cache


PACKAGES = {
    "jax": (jax_engine, _JaxStub, JaxRegistry, jax_build_bloom, {"w": jnp.zeros(1)}),
    "torch": (engine, _TorchStub, MetricsRegistry, build_bloom, {"w": torch.zeros(1)}),
}


def _make(pkg, **kw):
    mod, stub, registry, _, params = PACKAGES[pkg]
    kw.setdefault("metrics", registry(f"test.{pkg}"))
    return mod.ServeEngine(stub(), params=params, **kw)


def _req(pkg, uid, prompt_len=4, max_new=8, prompt=None):
    prompt = prompt if prompt is not None else [(uid + i) % 16 for i in range(prompt_len)]
    return PACKAGES[pkg][0].Request(uid=uid, prompt=list(prompt), max_new_tokens=max_new)


def _summary(eng, done):
    return {
        "done": [(r.uid, list(map(int, r.generated)), r.truncated, r.slot, r.done)
                 for r in done],
        "counters": {c: eng.metrics.counter(c).value for c in COUNTERS},
        "allocated": eng.kv.num_allocated,
        "free_slots": sorted(eng._free_slots),
        "active": sorted(eng._active),
        "prefix_hits": eng.prefix_cache_hits,
    }


def _admit_out_of_pages(pkg):
    eng = _make(pkg, batch_slots=2, max_len=32, page_size=4, kv_pages=1)
    trace = [eng.admit(_req(pkg, 0, prompt_len=8)), sorted(eng._free_slots)]
    trace.append(eng.admit(_req(pkg, 1, prompt_len=3)))
    return trace, _summary(eng, [])


def _backpressure(pkg):
    eng = _make(pkg, batch_slots=4, max_len=64, page_size=4, kv_pages=6)
    done = eng.run([_req(pkg, i, prompt_len=6, max_new=6) for i in range(10)])
    return None, _summary(eng, done)


def _page_growth(pkg):
    eng = _make(pkg, batch_slots=1, max_len=128, page_size=4)
    req = _req(pkg, 0, prompt_len=2, max_new=17)
    trace = [eng.admit(req), eng.kv.request_capacity(0)]
    done = []
    while not req.done:
        done += eng.tick()
        trace.append((len(req.generated), eng.kv.request_capacity(0), eng.kv.num_allocated))
    return trace, _summary(eng, done)


def _churn_with_stalls(pkg):
    eng = _make(pkg, batch_slots=4, max_len=64, page_size=4, kv_pages=6)
    done = eng.run([_req(pkg, i, prompt_len=3 + (i % 4), max_new=10) for i in range(12)])
    return [len(eng.kv._free), len(eng.kv._table), len(eng.kv._per_req)], _summary(eng, done)


def _prefix_screen_learns(pkg):
    bloom = PACKAGES[pkg][3](np.array([f"seed-{i:03d}" for i in range(64)]), fpr=1e-4)
    prompts = [[(7 * i + j) % 16 for j in range(6)] for i in range(4)]
    eng = _make(pkg, batch_slots=4, max_len=64, page_size=8, prefix_bloom=bloom)
    done = eng.run([_req(pkg, i, max_new=4, prompt=p) for i, p in enumerate(prompts)])
    first = eng.prefix_cache_hits
    done += eng.run([_req(pkg, 100 + i, max_new=4, prompt=p) for i, p in enumerate(prompts)])
    return [first], _summary(eng, done)


SCENARIOS = {
    "admit_out_of_pages": _admit_out_of_pages,
    "backpressure": _backpressure,
    "page_growth": _page_growth,
    "churn_with_stalls": _churn_with_stalls,
    "prefix_screen_learns": _prefix_screen_learns,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenarios_match_reference(name):
    want = SCENARIOS[name]("jax")
    got = SCENARIOS[name]("torch")
    assert got == want
    summary = got[1]
    assert summary["allocated"] == 0 or name == "admit_out_of_pages"
    if name == "churn_with_stalls":
        # the scarcity bit in both engines, so the scenario pins something
        c = summary["counters"]
        assert c["engine.kv_stalls"] + c["engine.deferred"] > 0
        assert len(summary["done"]) == 12


def test_prefix_key_matches_reference():
    for prompt in ([], [1, 2, 3], list(range(40))):
        assert engine.prefix_key(prompt) == jax_engine.prefix_key(prompt)


def test_reduced_model_generates_the_reference_tokens():
    """The reduced yi-6b in float32, the reference's parameters carried
    across: both engines generate the same tokens for every request."""
    jcfg = dataclasses.replace(jax_get_arch("yi-6b", reduced=True), dtype="float32")
    cfg = dataclasses.replace(get_arch("yi-6b", reduced=True), dtype="float32")
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, rng.integers(4, 12))]
               for _ in range(6)]
    out = {}
    for pkg, api, p in (("jax", japi, jparams), ("torch", get_model(cfg, "cpu"), params)):
        mod = PACKAGES[pkg][0]
        eng = mod.ServeEngine(api, p, batch_slots=4, max_len=64,
                              metrics=PACKAGES[pkg][2](f"test.lm.{pkg}"))
        done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=6)
                        for i, pr in enumerate(prompts)])
        out[pkg] = sorted((r.uid, list(map(int, r.generated))) for r in done)
        assert eng.kv.num_allocated == 0
    assert len(out["torch"]) == 6
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the paged KV allocator
# ---------------------------------------------------------------------------

def _alloc_stream(alloc, rng):
    """Allocations and frees in a seeded order: bootstrap, an index
    build, then churn that stages into the delta and compacts."""
    live = []
    for uid in range(12):
        alloc.alloc(uid, int(rng.integers(1, 80)))
        live.append(uid)
    alloc.rebuild_index()
    for uid in range(12, 40):
        alloc.alloc(uid, int(rng.integers(1, 60)))
        live.append(uid)
        if rng.random() < 0.4:
            victim = live.pop(int(rng.integers(0, len(live))))
            alloc.free(victim)
        if rng.random() < 0.3:
            grow = live[int(rng.integers(0, len(live)))]
            alloc.alloc(grow, int(rng.integers(1, 40)))
    return live


def _live_pairs(alloc):
    rid = np.array([r for r, pages in sorted(alloc._per_req.items()) for _ in pages])
    lp = np.array([i for _, pages in sorted(alloc._per_req.items())
                   for i in range(len(pages))])
    return rid.astype(np.int64), lp.astype(np.int64)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_allocator_streams_match_reference(num_shards):
    kw = dict(num_pages=1024, page_size=16, delta_capacity=32, num_shards=num_shards)
    jal = JaxAllocator(**kw)
    tal = kvcache.PagedKVAllocator(**kw, device="cpu")
    jlive = _alloc_stream(jal, np.random.default_rng(7))
    tlive = _alloc_stream(tal, np.random.default_rng(7))
    assert tlive == jlive
    assert tal._per_req == jal._per_req and tal._table == jal._table
    assert tal.num_allocated == jal.num_allocated and tal.num_free == jal.num_free
    rid, lp = _live_pairs(tal)
    want = jal.translate_binary(rid, lp)
    np.testing.assert_array_equal(tal.translate_binary(rid, lp), want)
    for strategy in ("binary", "cuda", "cuda_fused", "sharded_fused"):
        tal.strategy = strategy
        np.testing.assert_array_equal(tal.translate(rid, lp), want, err_msg=strategy)
    jal.strategy = REFERENCE_STRATEGY["cuda_fused"]
    np.testing.assert_array_equal(jal.translate(rid, lp), want)

    lo, hi = float(rid.min() * kvcache.MAX_PAGES_PER_REQ), float(rid.max() * 4096 + 50)
    jpages = list(jal.scan(lo, hi, 64))
    tpages = list(tal.scan(lo, hi, 64))
    assert len(tpages) == len(jpages)
    for a, b in zip(tpages, jpages):
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.vals, b.vals)
        np.testing.assert_array_equal(a.live_mask, b.live_mask)
    for uid in tlive:
        assert list(tal.request_pages(uid)) == list(jal.request_pages(uid)) \
            == tal._per_req[uid]


@pytest.mark.parametrize("strategy", ["binary", "sharded_fused"])
def test_allocator_scan_batch_matches_reference(strategy):
    kw = dict(num_pages=1024, page_size=16, delta_capacity=32, num_shards=2)
    jal = JaxAllocator(**kw, strategy=REFERENCE_STRATEGY[strategy])
    tal = kvcache.PagedKVAllocator(**kw, strategy=strategy, device="cpu")
    _alloc_stream(jal, np.random.default_rng(3))
    _alloc_stream(tal, np.random.default_rng(3))
    lo, hi = 4096.0 * 2, 4096.0 * 30 + 7
    jk, jv, jm = (np.asarray(a) for a in jal.scan_batch(lo, hi, 32))
    tk, tv, tm = (t.numpy() for t in tal.scan_batch(lo, hi, 32))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tk[tm], jk[jm])
    np.testing.assert_array_equal(tv[tm], jv[jm])
    np.testing.assert_array_equal(tal.scan_normalize(np.array([lo, hi])),
                                  jal.scan_normalize(np.array([lo, hi])))
    # the device rows are the host scan's rows
    host = [p for p in tal.scan(lo, hi, 32)]
    keys = np.concatenate([p.keys[p.live_mask] for p in host])
    np.testing.assert_array_equal(tk[tm], tal.scan_normalize(keys))


def test_allocator_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kvcache.PagedKVAllocator(num_pages=8, page_size=4)
    with pytest.raises(ValueError, match="unknown lookup strategy"):
        kvcache.PagedKVAllocator(num_pages=8, page_size=4, strategy="pallas", device="cpu")


def test_recycled_slot_attends_to_its_previous_occupant_like_the_reference():
    """The lockstep engine keeps one cache length for all slots and does
    not clear a slot it recycles: a request served after another in the
    same slot decodes at the later positions over the earlier request's
    KV entries, so it generates other tokens than when served alone.
    Both packages do so, token for token (ROADMAP queue C)."""
    jcfg = dataclasses.replace(jax_get_arch("yi-6b", reduced=True), dtype="float32")
    cfg = dataclasses.replace(get_arch("yi-6b", reduced=True), dtype="float32")
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    first, second = [3, 17, 250, 9, 41], [77, 5, 130, 8]
    gens = {}
    for pkg, api, p in (("jax", japi, jparams), ("torch", get_model(cfg, "cpu"), params)):
        mod = PACKAGES[pkg][0]

        def serve(prompts, api=api, p=p, mod=mod, pkg=pkg):
            eng = mod.ServeEngine(api, p, batch_slots=1, max_len=64,
                                  metrics=PACKAGES[pkg][2](f"test.slot.{pkg}"))
            done = eng.run([mod.Request(uid=i, prompt=list(pr), max_new_tokens=8)
                            for i, pr in enumerate(prompts)])
            return [list(map(int, r.generated)) for r in sorted(done, key=lambda r: r.uid)]

        gens[pkg] = (serve([first, second])[1], serve([second])[0])
    assert gens["torch"] == gens["jax"]
    after, alone = gens["torch"]
    assert after != alone
