"""The §5.1 learned Bloom filter in the port against the reference: the
hand-written GRU cell gives the reference's logits from converted
parameters, a small filter trained by the port keeps the
zero-false-negative contract and its FPR budget and absorbs late keys,
a reference-trained classifier carried across builds the reference's
filter, and the serving launcher's ``--prefix-bloom`` runs on the
host."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import learned_bloom as ref_lb  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import GRUSpec, LearnedBloom, build_learned_bloom, tokenize  # noqa: E402
from repro_torch.core import learned_bloom  # noqa: E402
from repro_torch.core.bloom import string_hash_u64  # noqa: E402
from repro_torch.data import gen_urls  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# float32 logits through 16-32 recurrent steps, matmuls summed in
# another order than XLA's: the reference's own kernel tolerance
LOGIT_ATOL = 1e-5
SMALL = dict(width=8, embed=8, max_len=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small torch ops here (a GRU step, a stage-0 step, a
    search trip) run on one thread: the suite's workers share the
    cores, and torch's thread pool in every worker would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def urls():
    return gen_urls(500, 1_500)


@pytest.mark.parametrize("spec_kw", [SMALL, {}], ids=["small", "paper"])
def test_logits_of_converted_reference_params_match(urls, spec_kw):
    rspec = ref_lb.GRUSpec(**spec_kw)
    spec = GRUSpec(**spec_kw)
    assert (spec.num_params, spec.size_bytes) == (rspec.num_params, rspec.size_bytes)
    keys, nonkeys = urls
    toks = tokenize(keys[:300] + nonkeys[:300], spec.max_len).astype(np.int32)
    params = jax.tree.map(np.asarray, ref_lb.gru_init(rspec, jax.random.PRNGKey(3)))
    # weights and biases moved off the initial draw, as training moves them
    rng = np.random.default_rng(3)
    params = {k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
              for k, v in params.items()}
    want = np.asarray(ref_lb.gru_logits({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(toks)))
    port = learned_bloom.params_on(convert.gru_params_from_reference(params), "cpu")
    got = learned_bloom.gru_logits(port, torch.as_tensor(toks)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_gru_is_not_torch_nn_gru():
    """The reference's cell applies r before the hidden matmul and holds
    h over padding; `nn.GRU` with the same weights gives other logits."""
    spec = GRUSpec(**SMALL)
    p = learned_bloom.gru_init(spec, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor([[104, 116, 116, 112, 0, 0, 0, 0]])
    e, w = spec.embed, spec.width
    gru = torch.nn.GRU(e, w, batch_first=True, bias=True)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.cat([p["wr"][:e], p["wz"][:e], p["wh"][:e]], 1).T)
        gru.weight_hh_l0.copy_(torch.cat([p["wr"][e:], p["wz"][e:], p["wh"][e:]], 1).T)
        gru.bias_ih_l0.copy_(torch.cat([p["br"], p["bz"], p["bh"]]))
        gru.bias_hh_l0.zero_()
        out, _ = gru(p["emb"][toks])
        nn_logit = (out[:, -1] @ p["wo"] + p["bo"])[:, 0]
    assert not torch.allclose(nn_logit, learned_bloom.gru_logits(p, toks), atol=1e-4)


def test_small_learned_bloom_contract_and_add(urls):
    keys, nonkeys = urls
    lb = build_learned_bloom(keys, nonkeys, target_fpr=0.01, spec=GRUSpec(**SMALL),
                             train_steps=150, device="cpu")
    assert isinstance(lb, LearnedBloom)
    assert lb.contains(keys).all(), "learned bloom broke the no-FN contract"
    assert lb.measured_fpr <= 0.05
    assert lb.size_bytes == lb.spec.size_bytes + lb.overflow.size_bytes
    # one string at a time gives the batch's answers (padded batches)
    assert all(lb.contains([k])[0] for k in keys[:20])
    late = [f"http://late-{i}.example/x" for i in range(50)]
    lb.add(late)
    assert lb.contains(late).all() and lb.contains(keys).all()
    assert np.array_equal(learned_bloom._string_hash_u64(late), string_hash_u64(late))
    assert np.array_equal(string_hash_u64(late), ref_lb._string_hash_u64(late))


def test_training_is_seeded(urls):
    keys, nonkeys = urls
    pos = tokenize(keys, 16).astype(np.int32)
    neg = tokenize(nonkeys, 16).astype(np.int32)
    spec = GRUSpec(**SMALL)
    a = learned_bloom.gru_train(spec, pos, neg, steps=5, seed=1, device="cpu")
    b = learned_bloom.gru_train(spec, pos, neg, steps=5, seed=1, device="cpu")
    c = learned_bloom.gru_train(spec, pos, neg, steps=5, seed=2, device="cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["wz"], c["wz"])


def test_carried_reference_classifier_builds_the_references_filter(urls):
    """The same trained GRU on both sides: the same τ's neighbourhood,
    FNR, held-out FPR and overflow filter."""
    keys, nonkeys = urls
    rspec = ref_lb.GRUSpec(**SMALL)
    params = ref_lb.gru_train(rspec, tokenize(keys, 16).astype(np.int32),
                              tokenize(nonkeys, 16).astype(np.int32), steps=40)
    ref = ref_lb.build_learned_bloom(keys, nonkeys, spec=rspec, params=params)
    lb = build_learned_bloom(keys, nonkeys, spec=GRUSpec(**SMALL),
                             params=convert.gru_params_from_reference(params), device="cpu")
    assert abs(lb.tau - ref.tau) <= 1e-5
    assert (lb.fnr, lb.measured_fpr) == (ref.fnr, ref.measured_fpr)
    assert lb.overflow.num_bits == ref.overflow.num_bits
    assert np.array_equal(lb.overflow.words, ref.overflow.words)
    assert lb.contains(keys).all()


def test_launcher_prefix_bloom_runs_on_the_host(capsys):
    """The reference test's argv (tests/test_system.py), on the CPU."""
    out = serve.main(["--arch", "yi-6b", "--reduced", "--requests", "3", "--max-new", "4",
                      "--batch-slots", "3", "--max-len", "32", "--prefix-bloom",
                      "--device", "cpu"])
    assert out["completed"] == 3 and out["tokens"] == 12 and out["kv_pages_in_use"] == 0
    assert '"completed": 3' in capsys.readouterr().out


@pytest.mark.slow
def test_learned_bloom_contract_at_the_references_scale():
    keys, nonkeys = gen_urls(2_000, 6_000)
    lb = build_learned_bloom(keys, nonkeys, target_fpr=0.01,
                             spec=GRUSpec(width=8, embed=8, max_len=24), train_steps=200,
                             device="cpu")
    assert lb.contains(keys).all()
    assert lb.measured_fpr <= 0.05
