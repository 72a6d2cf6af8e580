"""The port's attention against the reference: the flash kernel's plain
twin (`ref.mha_reference`) and the CPU `ops.attention_op` against the
reference's `flash_attention` (Pallas, interpret mode) and its
`ref.mha_reference`, on the reference's four test shapes and ragged
ones, at the reference's tolerances (2e-5 in float32, 2e-2 in
bfloat16); the model's `chunked_attention` (padding, query offset,
non-causal), `decode_attention` and `update_kv_cache` against the
reference's.  The `cuda`-marked test holds the kernel against its twin
on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

SHAPES = [(1, 4, 2, 128, 32), (2, 8, 8, 128, 64), (1, 8, 1, 256, 64), (2, 4, 4, 64, 128)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape, dtype, seed=0):
    """The same inputs for both packages: numpy normals rounded to
    ``dtype`` once, then handed to each."""
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype]) for j in jx]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _f32(t):
    return t.float().numpy()


# one dtype/causal combination per shape in tier 1, the rest under slow
_TIER1 = {(0, "float32", True), (1, "bfloat16", True), (2, "float32", False),
          (3, "bfloat16", False)}
CASES = [
    pytest.param(shape, dtype, causal,
                 marks=() if (i, dtype, causal) in _TIER1 else pytest.mark.slow,
                 id=f"{'x'.join(map(str, shape))}-{dtype}-{'causal' if causal else 'full'}")
    for i, shape in enumerate(SHAPES)
    for dtype in ("float32", "bfloat16") for causal in (True, False)
]


@pytest.mark.parametrize("shape,dtype,causal", CASES)
def test_plain_twin_and_op_match_reference_kernel(shape, dtype, causal):
    (jq, jk, jv), (q, k, v) = _qkv(shape, dtype)
    want_kernel = flash_attention(jq, jk, jv, causal=causal, blk_q=64, blk_k=64)
    want_ref = jax_ref.mha_reference(jq, jk, jv, causal=causal)
    got = ref.mha_reference(q, k, v, causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    _close(_f32(got), want_kernel, tol)
    _close(_f32(got), want_ref, tol)
    _close(_f32(ops.attention_op(q, k, v, causal=causal)), want_kernel, tol)


@pytest.mark.parametrize("s", [48, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_sequence_matches_reference_kernel(s, dtype):
    """S that does not divide 64 or 128: the reference's kernel runs with
    one block of S rows, the port's op (the kernel on the card) takes
    any S."""
    (jq, jk, jv), (q, k, v) = _qkv((1, 4, 2, s, 32), dtype, seed=s)
    for causal in (True, False):
        want = flash_attention(jq, jk, jv, causal=causal, blk_q=128, blk_k=128)
        got = ops.attention_op(q, k, v, causal=causal)
        _close(_f32(got), want, TOL[dtype])
        _close(_f32(fa.flash_attention_cuda(q, k, v, causal=causal)), want, TOL[dtype])


def test_attention_op_dispatches_plain_on_the_cpu_and_builds_nothing():
    from repro_torch.kernels import nvcc
    fa.reset_launch_counts()
    ops.reset_dispatch_stats()
    _, (q, k, v) = _qkv((1, 4, 2, 16, 32), "float32")
    ops.attention_op(q, k, v)
    ops.attention_op(q, k, v, use_kernel=False)
    rows = [r for r in ops.dispatch_summary()["rows"] if r["op"] == "attention"]
    assert [(r["path"], r["count"]) for r in rows] == [("plain", 2)]
    assert fa.LAUNCHES == {"flash_attention_cuda": 0}
    assert all(source != fa.SOURCE for source, _ in nvcc._LIBS)


@pytest.mark.parametrize("sq,sk,chunk,q_offset,causal", [
    (24, 24, 8, 0, True),       # chunks divide
    (20, 20, 8, 0, True),       # kv padded to a chunk multiple
    (20, 20, 8, 0, False),      # padded, non-causal
    (6, 30, 8, 24, True),       # queries at the end of a longer context
    (16, 16, 64, 0, True),      # one chunk larger than the sequence
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(sq, sk, chunk, q_offset, causal, dtype):
    rng = np.random.default_rng(sq * 100 + sk)
    qa = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    ka, va = (rng.standard_normal((2, 2, sk, 16)).astype(np.float32) for _ in range(2))
    jx = [jnp.asarray(a, JNP[dtype]) for a in (qa, ka, va)]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype]) for j in jx]
    want = jax_attn.chunked_attention(*jx, causal=causal, chunk=chunk, q_offset=q_offset)
    got = attention.chunked_attention(*tx, causal=causal, chunk=chunk, q_offset=q_offset)
    assert got.dtype == TORCH[dtype]
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(_f32(got), want, tol)


def test_chunked_attention_on_the_card_refuses_what_the_kernel_cannot_compute():
    """The kernel computes square attention from position 0: a query
    offset or Sq != Sk raises before anything launches (a stand-in that
    reports a CUDA device: only the device and the shapes are read)."""
    q = torch.empty((1, 2, 4, 32), device="meta")
    k = torch.empty((1, 2, 8, 32), device="meta")

    class _Card:
        def __init__(self, t):
            self.t = t
            self.shape = t.shape
            self.device = torch.device("cuda")

    with pytest.raises(ValueError, match="square attention"):
        attention.chunked_attention(_Card(q), _Card(k), _Card(k))
    with pytest.raises(ValueError, match="square attention"):
        attention.chunked_attention(_Card(q), _Card(q), _Card(q), q_offset=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [1, 9, 16])
def test_decode_attention_matches_reference(dtype, cache_len):
    rng = np.random.default_rng(cache_len)
    qa = rng.standard_normal((3, 8, 1, 32)).astype(np.float32)
    ka, va = (rng.standard_normal((3, 2, 16, 32)).astype(np.float32) for _ in range(2))
    jx = [jnp.asarray(a, JNP[dtype]) for a in (qa, ka, va)]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype]) for j in jx]
    want = jax_attn.decode_attention(*jx, jnp.int32(cache_len))
    got = attention.decode_attention(*tx, cache_len)
    assert got.dtype == TORCH[dtype] and got.shape == (3, 8, 1, 32)
    _close(_f32(got), want, 1e-5 if dtype == "float32" else 2e-2)
    # a per-row length, as a tensor
    lens = np.array([1, cache_len, 16], np.int32)
    want = jax_attn.decode_attention(*jx, jnp.asarray(lens))
    got = attention.decode_attention(*tx, torch.as_tensor(lens))
    _close(_f32(got), want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("pos", [0, 5, 15, 40])
def test_update_kv_cache_matches_reference_in_place(pos):
    """One entry written at ``pos`` (clamped to the last slot past the
    end, as the reference's dynamic_update_slice clamps), in place."""
    rng = np.random.default_rng(pos)
    kc, vc = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((2, 2, 1, 8)).astype(np.float32) for _ in range(2))
    jk, jv = jax_attn.update_kv_cache(*(jnp.asarray(a, jnp.bfloat16) for a in (kc, vc)),
                                      jnp.asarray(kn), jnp.asarray(vn), pos)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kc, vc))
    ok, ov = attention.update_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), pos)
    assert ok is tk and ov is tv
    np.testing.assert_array_equal(_f32(tk), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(_f32(tv), np.asarray(jv, np.float32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    meta = dict(device="meta")
    q = torch.empty((1, 4, 8, 48), **meta)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.empty((1, 6, 8, 32), **meta)
    k = torch.empty((1, 4, 8, 32), **meta)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention_cuda(q, k, k)
    q = torch.empty((1, 4, 8, 32), dtype=torch.float16, **meta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.empty((1, 4, 8, 32), **meta)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


def test_kernel_source_names_what_it_replaces_and_builds_with_contraction():
    from repro_torch.kernels import nvcc
    src = fa.SOURCE.read_text()
    assert "src/repro/kernels/flash_attention.py:83" in src
    assert "-1e30f" in src and "1e-30f" in src
    assert "-fmad=false" not in fa.FLAGS and "-fmad=false" in nvcc.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in " ".join(fa.FLAGS)
    assert fa.library_path().name.startswith("flash_attention-")
    assert fa.library_path() != nvcc.library_path(fa.SOURCE)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    for shape in SHAPES + [(2, 4, 2, 48, 128), (1, 8, 2, 1000, 64), (1, 8, 2, 1, 64)]:
        for dtype in ("float32", "bfloat16"):
            _, (q, k, v) = _qkv(shape, dtype)
            q, k, v = (t.to(dev) for t in (q, k, v))
            for causal in (True, False):
                got = fa.flash_attention_cuda(q, k, v, causal=causal)
                want = ref.mha_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                tol = TOL[dtype]
                assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
