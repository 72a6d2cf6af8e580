"""The paper's other structures in the port against the reference: the
B-Tree baseline (exact for stored and absent queries, ROADMAP queue
C 21 pinned), LIF synthesis (a linear grid gives the reference's
candidates and pick; a mixed grid keeps its budget), the data pipeline's
document lookup (exact against the oracle; queue C 20 pinned), and the
paper's configuration grid."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import learned_index as ref_configs  # noqa: E402
from repro.core import btree as ref_btree  # noqa: E402
from repro.core import keys as ref_keys  # noqa: E402
from repro.core import lif as ref_lif  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402

from repro_torch.configs import learned_index  # noqa: E402
from repro_torch.core import (  # noqa: E402
    IndexSpec,
    build_btree,
    compile_btree_lookup,
    make_keyset,
    synthesize,
)
from repro_torch.core import btree  # noqa: E402
from repro_torch.data import gen_lognormal, gen_maps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small torch ops here (a GRU step, a stage-0 step, a
    search trip) run on one thread: the suite's workers share the
    cores, and torch's thread pool in every worker would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _queries(ks, rng, absent=4_000):
    return np.concatenate([
        ks.norm,
        rng.uniform(-0.1, 1.1, absent).astype(np.float32),
        (ks.norm[:-1] + np.diff(ks.norm) / 2).astype(np.float32),  # between keys
        np.array([np.inf, -np.inf, 0.0, 1.0], np.float32),
    ])


@pytest.mark.parametrize("gen", [gen_lognormal, gen_maps])
@pytest.mark.parametrize("page", [16, 64, 256])
def test_btree_matches_searchsorted_and_reference(gen, page):
    ks = make_keyset(gen(12_000))
    q = _queries(ks, np.random.default_rng(3))
    bt = build_btree(ks.norm, page_size=page)
    rbt = ref_btree.build_btree(ks.norm, page_size=page)
    assert bt.depth == rbt.depth and bt.size_bytes == rbt.size_bytes
    assert bt.fixed_error == rbt.fixed_error
    assert btree.btree_traversal_ops(bt) == ref_btree.btree_traversal_ops(rbt)
    for a, b in zip(bt.levels, rbt.levels):
        assert np.array_equal(a, b)
    got = compile_btree_lookup(bt, ks.norm, device="cpu")(torch.as_tensor(q)).numpy()
    assert np.array_equal(got, np.searchsorted(ks.norm, q, side="left"))
    ref = np.asarray(ref_btree.compile_btree_lookup(rbt, ks.norm)(jnp.asarray(q)))
    assert np.array_equal(got, ref)


def test_c21_btree_finds_the_lower_bound_of_a_tie_across_a_page():
    """ROADMAP queue C 21 (reference fault, fixed in the port): 32 keys,
    page 16, four equal keys at positions 14-17.  The reference's
    descent counts separators <= q, takes page 1 for q = 0.5 and answers
    16; the lower bound is 14."""
    keys = np.sort(np.concatenate([
        np.arange(14) / 100, np.full(4, 0.5), 0.6 + np.arange(14) / 100])).astype(np.float32)
    q = np.array([0.5], np.float32)
    ref = np.asarray(ref_btree.compile_btree_lookup(
        ref_btree.build_btree(keys, 16), keys)(jnp.asarray(q)))
    got = compile_btree_lookup(build_btree(keys, 16), keys, device="cpu")(torch.as_tensor(q))
    assert ref.tolist() == [16]
    assert got.tolist() == [14] == np.searchsorted(keys, q).tolist()


def test_btree_on_many_float32_ties():
    """Keys whose float32 values repeat in runs of every length around
    every page boundary, stored and absent queries."""
    rng = np.random.default_rng(9)
    keys = np.sort(np.repeat(rng.uniform(0, 1, 700).astype(np.float32),
                             rng.integers(1, 40, 700)))
    q = np.concatenate([keys, rng.uniform(-0.1, 1.1, 2_000).astype(np.float32)])
    for page in (16, 64, 256):
        got = compile_btree_lookup(build_btree(keys, page), keys, device="cpu")(
            torch.as_tensor(q)).numpy()
        assert np.array_equal(got, np.searchsorted(keys, q)), page


def test_lif_linear_grid_gives_the_references_candidates_and_pick():
    raw = gen_maps(10_000)
    ks, rks = make_keyset(raw), ref_keys.make_keyset(raw)
    grid = {"num_leaves": (64, 256, 1024), "stage0_hidden": ((),)}
    idx, lookup, cands = synthesize(ks, IndexSpec(max_size_bytes=5_000), grid,
                                    train_steps=40, device="cpu")
    ridx, _, rcands = ref_lif.synthesize(rks, ref_lif.IndexSpec(max_size_bytes=5_000),
                                         grid, train_steps=40)
    assert len(cands) == len(rcands) == 3
    for c, r in zip(cands, rcands):
        assert c.config.num_leaves == r.config.num_leaves
        assert (c.score, c.size_bytes, c.avg_window, c.max_window, c.model_flops) == \
            (r.score, r.size_bytes, r.avg_window, r.max_window, r.model_flops)
    assert idx.num_leaves == ridx.num_leaves and idx.model_size_bytes == ridx.model_size_bytes
    got = lookup(torch.as_tensor(ks.norm)).numpy()
    assert np.array_equal(got, np.searchsorted(ks.norm, ks.norm))


def test_lif_mixed_grid_respects_its_budget():
    ks = make_keyset(gen_maps(10_000))
    grid = {"num_leaves": (256, 1024), "stage0_hidden": ((), (8,))}
    idx, lookup, cands = synthesize(ks, IndexSpec(max_size_bytes=50_000), grid,
                                    train_steps=40, device="cpu")
    assert len(cands) == 4 and idx.model_size_bytes <= 50_000
    assert min(c.score for c in cands if c.size_bytes <= 50_000) == \
        next(c.score for c in cands if c.index is idx)
    sample = np.random.default_rng(0).choice(ks.n, 500)
    got = lookup(torch.as_tensor(ks.norm[sample])).numpy()
    assert np.array_equal(got, np.searchsorted(ks.norm, ks.norm[sample]))


def _oracle(corpus, offsets):
    return np.searchsorted(corpus.doc_starts, offsets, side="right") - 1


@pytest.mark.parametrize("tokens,offset,ref_doc,doc", [
    (50_000, 16_815, 0, 21),            # the smallest corpus found to fail
    (10_000_000, 3_139_430, 0, 3_323),
])
def test_c20_reference_document_lookup_is_wrong_the_ports_is_right(tokens, offset,
                                                                   ref_doc, doc):
    """ROADMAP queue C 20 (reference fault, fixed in the port): the
    reference's ±1 repair around the RMI's guess assumes the window
    covers an offset that is no stored key."""
    corpus = pipeline.make_synthetic_corpus(tokens, seed=0, device="cpu")
    ref = ref_pipeline.make_synthetic_corpus(tokens, seed=0)
    off = np.array([offset])
    assert np.array_equal(corpus.doc_starts, ref.doc_starts)
    assert ref.lookup_documents(off).tolist() == [ref_doc]
    assert corpus.lookup_documents(off).tolist() == [doc] == _oracle(corpus, off).tolist()


@pytest.mark.parametrize("tokens", [10_000_000, 1_000_000_000])
def test_lookup_documents_equals_the_oracle_on_1m_offsets(tokens):
    corpus = pipeline.make_synthetic_corpus(tokens, seed=0, device="cpu")
    offsets = np.random.default_rng(5).integers(0, tokens, 1 << 20)
    assert np.array_equal(corpus.lookup_documents(offsets), _oracle(corpus, offsets))


def test_gallop_is_exact_whatever_the_guess():
    rng = np.random.default_rng(4)
    starts = np.unique(rng.integers(0, 10_000, 300))
    starts[0] = 0
    off = rng.integers(-5, 10_100, 5_000)
    want = np.clip(np.searchsorted(starts, off, side="right") - 1, 0, None)
    st = torch.as_tensor(starts)
    for guess in (np.zeros_like(off), np.full_like(off, starts.size - 1),
                  rng.integers(-50, starts.size + 50, off.size)):
        got = pipeline.gallop_last_le(st, torch.as_tensor(off), torch.as_tensor(guess))
        assert np.array_equal(got.numpy(), want)


def test_tokens_and_batches_equal_the_reference_where_its_documents_are_right():
    corpus = pipeline.make_synthetic_corpus(10_000_000, seed=0, device="cpu")
    ref = ref_pipeline.make_synthetic_corpus(10_000_000, seed=0)
    offsets = np.random.default_rng(5).integers(0, 10_000_000 - 40, 20_000)
    ref_docs = ref.lookup_documents(offsets)
    right = ref_docs == _oracle(corpus, offsets)
    assert (~right).any() and right.mean() > 0.99
    got, want = corpus.tokens_at(offsets, 33), ref.tokens_at(offsets, 33)
    assert np.array_equal(got[right], want[right])
    assert not np.array_equal(got[~right], want[~right])
    pipe = pipeline.DataPipeline(corpus, global_batch=16, seq_len=32, shard_index=1,
                                 num_shards=2)
    rpipe = ref_pipeline.DataPipeline(ref, global_batch=16, seq_len=32, shard_index=1,
                                      num_shards=2)
    for step in range(3):
        a, b = pipe.batch_at(step), rpipe.batch_at(step)
        assert a["tokens"].shape == (8, 32)
        assert np.array_equal(a["tokens"], b["tokens"]) and np.array_equal(a["labels"],
                                                                           b["labels"])


def test_paper_configs_match_reference():
    assert learned_index.BTREE_PAGE_SIZES == ref_configs.BTREE_PAGE_SIZES
    assert learned_index.RMI_GRID.keys() == ref_configs.RMI_GRID.keys()
    for k, cfg in learned_index.RMI_GRID.items():
        assert vars(cfg) == vars(ref_configs.RMI_GRID[k]), k
