"""The port's attention against the reference: the flash kernel's plain
twin (`ref.mha_reference`) and the CPU `ops.attention_op` against the
reference's `flash_attention` (Pallas, interpret mode) and its
`ref.mha_reference`, on the reference's four test shapes and ragged
ones, at the reference's tolerances (2e-5 in float32, 2e-2 in
bfloat16); the model's `chunked_attention` (padding, query offset,
non-causal), `decode_attention` and `update_kv_cache` against the
reference's.  The kernel's numerics (bf16 tensor-core products with P
split into two bf16 halves) are emulated in plain torch and held to the
bound `chip_smoke.py` holds the card to.  The `cuda`-marked tests hold
the kernel against its twin on the card and check that it refuses
inputs that require grad (it has no backward).
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
    # the bf16 instances: both products on the tensor cores, tiles by TMA
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "cp.async.bulk.tensor.3d" in src and "cuTensorMapEncodeTiled" in src
    assert "-fmad=false" not in fa.FLAGS and "-fmad=false" in nvcc.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in " ".join(fa.FLAGS)
    assert fa.library_path().name.startswith("flash_attention-")
    assert fa.library_path() != nvcc.library_path(fa.SOURCE)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    for shape in SHAPES + [(2, 4, 2, 48, 128), (1, 8, 2, 1000, 64), (1, 8, 2, 1, 64),
                           (1, 32, 4, 1000, 128)]:
        for dtype in ("float32", "bfloat16"):
            _, (q, k, v) = _qkv(shape, dtype)
            q, k, v = (t.to(dev) for t in (q, k, v))
            for causal in (True, False):
                got = fa.flash_attention_cuda(q, k, v, causal=causal)
                want = ref.mha_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                tol = TOL[dtype]
                assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)


# chip_smoke.py's layer-0 bound: one bf16 rounding of the float32 twin
LAYER0_RTOL, LAYER0_ATOL = 5e-3, 1e-5


def _emulate_tensor_core_kernel(q, k, v, *, split, bk=64):
    """The bf16 kernel's rounding points in plain torch: bf16 operands,
    float32 scores and accumulation (a product of two bf16 values is
    exact in float32), an online softmax over tiles of ``bk`` keys, P
    fed to the P.V product as bf16(P) plus, with ``split``,
    bf16(P - bf16(P)); the output rounded to bf16 once."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kr, vr = (torch.repeat_interleave(t, group, 1).float() for t in (k, v))
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, bk):
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr[:, :, k0:k0 + bk])
        sc = sc * np.float32(1.0 / np.sqrt(d))
        sc = torch.where(torch.arange(k0, min(k0 + bk, s))[None, :] > rows,
                         torch.tensor(-1e30), sc)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        hi = p.to(torch.bfloat16).float()
        pv = hi + (p - hi).to(torch.bfloat16).float() if split else hi
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", pv, vr[:, :, k0:k0 + bk])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False], ids=["p-split-hi-lo", "p-single-bf16"])
def test_tensor_core_numerics_stay_within_one_bf16_rounding(split):
    """The split P keeps every output within one bf16 rounding of the
    float32 twin on the same (exactly widened) inputs; a single bf16 P
    (the textbook kernel) rounds each probability to 8 bits and does not."""
    _, (q, k, v) = _qkv((1, 4, 2, 256, 64), "bfloat16", seed=3)
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    got = _emulate_tensor_core_kernel(q, k, v, split=split).float()
    out = int((~torch.isclose(got, want, atol=LAYER0_ATOL, rtol=LAYER0_RTOL)).sum())
    if split:
        assert out == 0
    else:
        assert out > 0.05 * got.numel()


def test_chunked_attention_on_the_cpu_stays_differentiable():
    """C16: the card path has no backward and refuses grad; the CPU path
    is the reference's loop and gives q, k and v the reference's
    gradients."""
    import jax

    rng = np.random.default_rng(16)
    arrs = [rng.standard_normal((1, h, 20, 16)).astype(np.float32) for h in (4, 2, 2)]
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    (attention.chunked_attention(q, k, v, chunk=8) ** 2).sum().backward()

    def loss(qa, ka, va):
        return jnp.sum(jax_attn.chunked_attention(qa, ka, va, causal=True, chunk=8) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    for t, w in zip((q, k, v), want):
        assert t.grad is not None
        _close(t.grad.numpy(), w, 1e-4)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_refuses_an_input_that_requires_grad_before_launching(which):
    """C16 on a stand-in device (meta): under grad mode an input that
    requires grad raises before anything is built or launched."""
    args = {n: torch.empty((1, 4 if n == "q" else 2, 8, 32), device="meta") for n in "qkv"}
    args[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_cuda(args["q"], args["k"], args["v"])


@pytest.mark.cuda
def test_card_attention_refuses_grad_and_runs_under_no_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    _, qkv = _qkv((1, 4, 2, 64, 32), "bfloat16")
    qkv = [t.to(dev) for t in qkv]
    calls = (fa.flash_attention_cuda, attention.chunked_attention)
    for fn in calls:
        for which in range(3):
            args = list(qkv)
            args[which] = args[which].clone().requires_grad_(True)
            with pytest.raises(RuntimeError, match="no backward"):
                fn(*args)
            with torch.no_grad():
                out = fn(*args)
            torch.cuda.synchronize()
            want = ref.mha_reference(*qkv)
            assert not out.requires_grad
            assert torch.allclose(out.float(), want.float(), atol=2e-2, rtol=2e-2)
