"""String keys (§3.5) in the port against the reference: tokenization,
packed words and the unsigned lexicographic compare; the fixed-trip
lexicographic search against the reference and `bisect`; the float32
normalization of every byte value; vector RMIs (linear ones array for
array equal to the reference's), every stored string at its exact
position under the three strategies, with port-built and carried-across
indexes; the Webdocs and URL generators; and ROADMAP queue C 19 (the
plain `compile_lookup` over vector keys searches the first byte only,
as in the reference)."""

import bisect

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import keys as ref_keys  # noqa: E402
from repro.core import rmi as ref_rmi  # noqa: E402
from repro.core import strings as ref_strings  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    RMIConfig,
    build_rmi,
    compile_lookup,
    compile_string_lookup,
    make_vector_keyset,
    tokenize,
)
from repro_torch.core import strings  # noqa: E402
from repro_torch.data import datasets  # noqa: E402

STRATEGIES = ("binary", "biased", "quaternary")
MAX_LEN = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small torch ops here (a GRU step, a stage-0 step, a
    search trip) run on one thread: the suite's workers share the
    cores, and torch's thread pool in every worker would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

ascii_text = st.text(
    alphabet=st.characters(min_codepoint=32, max_codepoint=126),
    min_size=0, max_size=12,
)


@settings(max_examples=12, deadline=None)
@given(st.lists(ascii_text, min_size=2, max_size=30, unique=True))
def test_property_tokens_words_and_compare_match_reference(strs):
    max_len = 12
    s = sorted(strs)
    toks = tokenize(s, max_len)
    assert np.array_equal(toks, ref_strings.tokenize(s, max_len))
    packed = strings.pack_words(toks)
    assert np.array_equal(packed, ref_strings.pack_words(toks))
    assert np.array_equal(strings.pack_words_torch(torch.as_tensor(toks)).numpy(), packed)
    assert np.array_equal(
        strings.pack_words_jax(torch.as_tensor(toks)).numpy(),
        np.asarray(ref_strings.pack_words_jax(jnp.asarray(toks))))
    # every ordered pair, both ways: the port's compare, the reference's
    # and the byte-truncated string order agree
    i, j = np.meshgrid(np.arange(len(s)), np.arange(len(s)), indexing="ij")
    a, b = packed[i.ravel()], packed[j.ravel()]
    got = strings.lex_less(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.asarray(ref_strings.lex_less(jnp.asarray(a), jnp.asarray(b)))
    trunc = [x.encode()[:max_len] for x in s]
    want = np.array([trunc[x] < trunc[y] for x, y in zip(i.ravel(), j.ravel())])
    assert np.array_equal(got, ref) and np.array_equal(got, want)


def test_compare_is_unsigned_on_high_bytes():
    """Bytes >= 0x80 make the int32 carrier negative; the compare must
    still order them above every ASCII byte."""
    toks = np.array([[0x7F, 0, 0, 0], [0x80, 0, 0, 0], [0xFF, 0xFF, 0xFF, 0xFF]], np.float64)
    p = torch.as_tensor(strings.pack_words(toks))
    assert (p[1:, 0] < 0).all()
    assert strings.lex_less(p[:2], p[1:]).tolist() == [True, True]
    assert strings.lex_less(p[1:], p[:2]).tolist() == [False, False]


def test_lower_bound_lex_matches_reference_and_bisect():
    docs = datasets.gen_webdocs(3_000)
    packed = strings.pack_words(tokenize(docs, MAX_LEN))
    rng = np.random.default_rng(0)
    sample = rng.choice(len(docs), 400)
    absent = sorted({d[:-1] + "~" for d in rng.choice(docs, 200)} - set(docs))
    q = np.concatenate([packed[sample], strings.pack_words(tokenize(absent, MAX_LEN))])
    n = len(docs)
    for window in (n, 3 * n):
        lo = np.zeros(len(q), np.int32)
        hi = np.full(len(q), n, np.int32)
        got = strings.lower_bound_lex(torch.as_tensor(packed), torch.as_tensor(q),
                                      torch.as_tensor(lo), torch.as_tensor(hi), window).numpy()
        ref = np.asarray(ref_strings.lower_bound_lex(
            jnp.asarray(packed), jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi), window))
        assert np.array_equal(got, ref)
        trunc = [d.encode()[:MAX_LEN] for d in docs]
        want = [bisect.bisect_left(trunc, x.encode()[:MAX_LEN])
                for x in [docs[k] for k in sample] + absent]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("scale", [255.0, 122.0, 1.0])
def test_every_byte_value_normalizes_to_the_references_float32(scale):
    tok = np.arange(256, dtype=np.float64)[:, None].repeat(2, axis=1)
    got = strings.normalize_tokens(torch.as_tensor(tok), scale).numpy()
    # the reference's on-device normalization in compile_string_lookup
    want = np.asarray((jnp.asarray(tok) / scale).astype(jnp.float32))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # ... and the build's float64 divide rounded to float32 (both packages)
    vks = ref_keys.VectorKeySet(raw=tok, norm=np.zeros(1), scale=scale)
    assert np.array_equal(got, vks.normalize(tok))


@pytest.fixture(scope="module")
def webdocs():
    docs = datasets.gen_webdocs(5_000)
    tok = tokenize(docs, MAX_LEN)
    return make_vector_keyset(tok), ref_keys.make_vector_keyset(tok)


def _cfg(mod, hidden):
    return mod.RMIConfig(num_leaves=64, stage0_hidden=hidden, stage0_train_steps=60)


def test_linear_vector_index_equals_the_references(webdocs):
    vks, rvks = webdocs
    assert np.array_equal(vks.norm, rvks.norm) and vks.scale == rvks.scale
    idx = build_rmi(vks, _cfg(ref_rmi, ()), device="cpu")
    ref = ref_rmi.build_rmi(rvks, _cfg(ref_rmi, ()))
    assert idx.in_dim == ref.in_dim == MAX_LEN
    for k in ("w0", "b0"):
        assert np.array_equal(idx.stage0_params[k], ref.stage0_params[k]), k
    for k in ("leaf_w", "leaf_b", "err_lo", "err_hi", "seg_lo", "seg_hi", "is_btree"):
        assert np.array_equal(getattr(idx, k), getattr(ref, k)), k
    # σ comes from residuals whose positions `leaf_dot` sums in another
    # order than np.sum: a position differs by up to one float32 spacing,
    # which σ's E[r²] - mean² cancellation can amplify a few times (the
    # searches use int(σ) only)
    ulp = float(np.spacing(np.float32(vks.n)))
    np.testing.assert_allclose(idx.sigma, ref.sigma, rtol=0, atol=4 * ulp)
    assert idx.max_window == ref.max_window
    assert idx.model_size_bytes == ref.model_size_bytes


@pytest.mark.parametrize("hidden", [(), (8,)])
def test_every_stored_string_is_exact_under_every_strategy(webdocs, hidden):
    vks, rvks = webdocs
    idx = build_rmi(vks, _cfg(ref_rmi, hidden), device="cpu")
    carried = convert.index_from_reference(ref_rmi.build_rmi(rvks, _cfg(ref_rmi, hidden)))
    carried_keys = convert.vector_keyset_from_reference(rvks)
    q = torch.as_tensor(vks.raw)
    want = np.arange(vks.n)
    for strategy in STRATEGIES:
        got = compile_string_lookup(idx, vks, strategy, device="cpu")(q).numpy()
        assert np.array_equal(got, want), strategy
        got = compile_string_lookup(carried, carried_keys, strategy, device="cpu")(q).numpy()
        assert np.array_equal(got, want), ("carried", strategy)


def test_string_lookup_matches_reference_on_absent_strings(webdocs):
    """Absent strings lie outside the window guarantee: both packages
    return the same ranks from the same (carried) linear index."""
    vks, rvks = webdocs
    ref = ref_rmi.build_rmi(rvks, _cfg(ref_rmi, ()))
    idx = convert.index_from_reference(ref)
    docs = datasets.gen_webdocs(5_000)
    rng = np.random.default_rng(2)
    absent = sorted({d[:-2] + "zz" for d in rng.choice(docs, 300)} - set(docs))
    tok = tokenize(absent, MAX_LEN)
    for strategy in STRATEGIES:
        got = compile_string_lookup(idx, vks, strategy, device="cpu")(torch.as_tensor(tok))
        want = np.asarray(ref_strings.compile_string_lookup(ref, rvks, strategy)(
            jnp.asarray(tok)))
        assert np.array_equal(got.numpy(), want), strategy


def test_c19_plain_lookup_over_vector_keys_searches_the_first_byte(webdocs):
    """ROADMAP queue C 19 (reference behaviour, mirrored): `compile_lookup`
    over a VectorKeySet searches the first column only, so on Webdocs it
    puts few stored strings at their position; the port gives the
    reference's ranks from the same linear index, and
    `compile_string_lookup` gives the exact ones."""
    vks, rvks = webdocs
    ref = ref_rmi.build_rmi(rvks, _cfg(ref_rmi, ()))
    idx = convert.index_from_reference(ref)
    got = compile_lookup(idx, vks, device="cpu")(torch.as_tensor(vks.norm)).numpy()
    want = np.asarray(ref_rmi.compile_lookup(ref, rvks)(jnp.asarray(rvks.norm)))
    assert np.array_equal(got, want)
    exact = np.arange(vks.n)
    assert (got == exact).mean() < 0.05
    strings_got = compile_string_lookup(idx, vks, device="cpu")(torch.as_tensor(vks.raw))
    assert np.array_equal(strings_got.numpy(), exact)


@pytest.mark.parametrize("seed", [0, 3])
def test_string_generators_match_reference(seed):
    assert datasets.gen_webdocs(800, seed=seed) == ref_datasets.gen_webdocs(800, seed=seed)
    assert datasets.gen_urls(300, 900, seed=seed) == ref_datasets.gen_urls(300, 900, seed=seed)


@pytest.mark.slow
@pytest.mark.parametrize("hidden", [(), (8,), (16, 16)])
def test_stored_strings_exact_at_larger_scale(hidden):
    docs = datasets.gen_webdocs(40_000, seed=1)
    vks = make_vector_keyset(tokenize(docs, 24))
    idx = build_rmi(vks, RMIConfig(num_leaves=512, stage0_hidden=hidden,
                                   stage0_train_steps=200), device="cpu")
    for strategy in STRATEGIES:
        got = compile_string_lookup(idx, vks, strategy, device="cpu")(torch.as_tensor(vks.raw))
        assert np.array_equal(got.numpy(), np.arange(vks.n)), strategy
