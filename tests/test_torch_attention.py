"""The port's attention against the reference: the flash kernel's plain
twin (`ref.mha_reference`) and the CPU `ops.attention_op` against the
reference's `flash_attention` (Pallas, interpret mode) and its
`ref.mha_reference`, on the reference's four test shapes and ragged
ones, and at cross-attention shapes (Sq != Sk, full mask), at the
reference's tolerances (2e-5 in float32, 2e-2 in bfloat16); what the
card refuses (ROADMAP queue C 13: causal Sq != Sk, a query offset, a
gradient at Sq != Sk); the model's `chunked_attention` (padding, query offset,
non-causal), `decode_attention` and `update_kv_cache` against the
reference's.  The kernel's numerics (bf16 tensor-core products with P
split into two bf16 halves) are emulated in plain torch and held to the
bound `chip_smoke.py` holds the card to.  The gradient: the autograd
Function (`flash_attention.FlashAttention`) that `ops.attention_op` and
the wrapper take under grad, on the CPU its plain forward and
`ref.mha_backward_reference`, against `jax.vjp` of the reference's
`chunked_attention` and `mha_reference`, and the plain backward against
torch autograd through the plain forward.  The `cuda`-marked tests hold
both kernels against their twins on the card.
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
    assert fa.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_bwd_cuda": 0}
    assert all(source not in (fa.SOURCE, fa.BWD_SOURCE) for source, _ in nvcc._LIBS)


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


def test_chunked_attention_on_the_card_refuses_what_the_kernel_cannot_compute(monkeypatch):
    """ROADMAP queue C 13, narrowed: on the card the kernel takes causal
    attention with Sq == Sk and full attention with any Sq and Sk (the
    audio family's cross-attention), both from position 0.  A full call
    at Sq != Sk reaches `ops.attention_op`; a query offset, or causal
    with Sq != Sk, raises before anything launches (a stand-in that
    reports a CUDA device: only the device and the shapes are read).  A
    grad-requiring call at Sq != Sk raises in the autograd Function
    before the forward launches: the backward kernel takes one length."""
    q = torch.empty((1, 2, 4, 32), device="meta")
    k = torch.empty((1, 2, 8, 32), device="meta")

    class _Card:
        def __init__(self, t):
            self.t = t
            self.shape = t.shape
            self.device = torch.device("cuda")

    calls = []
    monkeypatch.setattr(attention.kernels_ops, "attention_op",
                        lambda q, k, v, causal: calls.append((q.shape, k.shape, causal)) or q)
    attention.chunked_attention(_Card(q), _Card(k), _Card(k), causal=False)
    assert calls == [(q.shape, k.shape, False)]
    with pytest.raises(ValueError, match="causal only with Sq == Sk"):
        attention.chunked_attention(_Card(q), _Card(k), _Card(k))
    with pytest.raises(ValueError, match="from position 0"):
        attention.chunked_attention(_Card(q), _Card(q), _Card(q), q_offset=3)
    with pytest.raises(ValueError, match="from position 0"):
        attention.chunked_attention(_Card(q), _Card(k), _Card(k), causal=False, q_offset=3)
    assert len(calls) == 1
    # the wrapper on a non-CPU tensor: causal Sq != Sk, and grad at
    # Sq != Sk, raise before anything is built or launched
    from repro_torch.kernels import nvcc
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        fa.flash_attention_cuda(q, k, k, causal=True)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="backward kernel takes Sq == Sk only"):
        fa.flash_attention_cuda(qg, k, k, causal=False)
    with pytest.raises(ValueError, match="backward kernel takes Sq == Sk only"):
        fa.flash_attention_bwd_cuda(q, k, k, q, torch.empty((1, 2, 4), device="meta"), q,
                                    causal=False)
    assert fa.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_bwd_cuda": 0}
    assert all(source not in (fa.SOURCE, fa.BWD_SOURCE) for source, _ in nvcc._LIBS)


@pytest.mark.parametrize("sq,sk,group", [(40, 72, 2), (77, 300, 4), (130, 40, 1), (1, 9, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_twin_at_sq_ne_sk_matches_reference(sq, sk, group, dtype):
    """Cross-attention shapes (Sq != Sk, full mask): the plain twin, its
    log-sum-exp and the CPU op against the reference's `mha_reference`
    and `chunked_attention` (ragged chunks), at the reference's
    tolerances; causal at Sq != Sk raises in the twin."""
    rng = np.random.default_rng(sq * 1000 + sk)
    qa = rng.standard_normal((2, 2 * group, sq, 32)).astype(np.float32)
    ka, va = (rng.standard_normal((2, 2, sk, 32)).astype(np.float32) for _ in range(2))
    jx = [jnp.asarray(a, JNP[dtype]) for a in (qa, ka, va)]
    q, k, v = (torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype]) for j in jx)
    tol = TOL[dtype]
    want = jax_ref.mha_reference(*jx, causal=False)
    got = ref.mha_reference(q, k, v, causal=False)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    _close(_f32(got), want, tol)
    _close(_f32(ops.attention_op(q, k, v, causal=False)), want, tol)
    _close(_f32(fa.flash_attention_cuda(q, k, v, causal=False)), want, tol)
    _close(_f32(attention.chunked_attention(q, k, v, causal=False, chunk=32)),
           jax_attn.chunked_attention(*jx, causal=False, chunk=32), tol)
    out, lse = ref.mha_reference_lse(q, k, v, causal=False)
    assert tuple(lse.shape) == (2, 2 * group, sq)
    s_ = np.einsum("bhqd,bhkd->bhqk", _f32(q), np.repeat(_f32(k), group, axis=1)) / np.sqrt(32)
    want_lse = np.log(np.exp(s_ - s_.max(-1, keepdims=True)).sum(-1)) + s_.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        ref.mha_reference(q, k, v, causal=True)


def test_plain_backward_at_sq_ne_sk_matches_reference_vjp():
    """The autograd Function on the CPU at Sq != Sk (its plain forward
    and `ref.mha_backward_reference`, which sums dK and dV over Sk rows)
    against `jax.vjp` of the reference's `chunked_attention`, float32,
    1e-5 x max."""
    import jax

    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal((2, h, s, 32)).astype(np.float32)
            for h, s in ((4, 40), (2, 72), (2, 72))]
    g = rng.standard_normal((2, 4, 40, 32)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = torch.autograd.grad(fa.flash_attention_cuda(*leaves, causal=False), leaves,
                              torch.from_numpy(g))
    _, vjp = jax.vjp(lambda q, k, v: jax_attn.chunked_attention(q, k, v, causal=False,
                                                               chunk=32),
                     *(jnp.asarray(a) for a in arrs))
    for t, w in zip(got, vjp(jnp.asarray(g))):
        assert t.shape == w.shape
        _close(t.numpy() / float(np.abs(w).max()), np.asarray(w) / float(np.abs(w).max()),
               1e-5)


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
    k = torch.empty((1, 2, 6, 16), **meta)
    with pytest.raises(ValueError, match=r"\(B, Hkv, Sk, D\)"):
        fa.flash_attention_cuda(q, k, k, causal=False)
    with pytest.raises(ValueError, match="causal attention needs Sq == Sk"):
        fa.flash_attention_cuda(q, q[:, :, :5], q[:, :, :5])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


def test_kernel_source_names_what_it_replaces_and_builds_with_contraction():
    from repro_torch.kernels import nvcc
    src = fa.SOURCE.read_text()
    assert "src/repro/kernels/flash_attention.py:83" in src
    assert "-1e30f" in src and "1e-30f" in src
    # the bf16 instances: both products on the tensor cores, tiles by TMA
    # (the Hopper pieces live in sm90.cuh, which the backward shares)
    assert '#include "sm90.cuh"' in src
    src += "".join(h.read_text() for h in nvcc._included_headers(fa.SOURCE))
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


def _emulate_tensor_core_backward(q, k, v, out, lse, d_out, *, causal, split):
    """The bf16 backward kernels' rounding points in plain torch: bf16
    operands, float32 products and sums (a product of two bf16 values is
    exact in float32), P and dS fed to the dV, dK and dQ products as
    bf16(x) plus, with ``split``, bf16(x - bf16(x)) (dS from P's two
    halves, as the dK/dV kernel forms it); dK and dV per query head, then
    summed over each group; every output rounded to bf16 once."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d))
    kr, vr = (torch.repeat_interleave(t, group, 1).float() for t in (k, v))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale - lse[..., None])
    if causal:
        p = torch.where(torch.tril(torch.ones((s, s), dtype=torch.bool)), p, torch.zeros(()))
    dof = d_out.float()
    di = (dof * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)

    def halves(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi

    pv = halves(p)
    ds = halves((pv if split else p) * (dp - di))
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale

    def by_group(t):
        return t.reshape(b, k.shape[1], group, s, d).sum(2)

    return dq.to(q.dtype), by_group(dk).to(k.dtype), by_group(dv).to(v.dtype)


@pytest.mark.parametrize("shape,causal", [((1, 4, 2, 256, 64), True), ((1, 4, 1, 77, 32), False)],
                         ids=["1x4x2x256x64-causal", "1x4x1x77x32-full"])
@pytest.mark.parametrize("split", [True, False], ids=["p-ds-split-hi-lo", "p-ds-single-bf16"])
def test_tensor_core_backward_numerics_split_p_and_ds(shape, causal, split):
    """Split P and dS keep every gradient within a relative L2 error of
    5e-4 of the plain backward (float32 inside, its outputs rounded to
    bf16 once) on the same bf16 inputs; a single bf16 P and dS (the
    textbook kernel) lands above 1e-3, beside chip_smoke.py's bound of
    1e-3 for the card."""
    _, (q, k, v) = _qkv(shape, "bfloat16", seed=3)
    out, lse = ref.mha_reference_lse(q.float(), k.float(), v.float(), causal=causal)
    out = out.to(torch.bfloat16)
    rng = np.random.default_rng(4)
    d_out = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(torch.bfloat16)
    want = ref.mha_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    got = _emulate_tensor_core_backward(q, k, v, out, lse, d_out, causal=causal, split=split)
    rel = [float((g.float() - w.float()).norm() / w.float().norm()) for g, w in zip(got, want)]
    if split:
        assert max(rel) <= 5e-4, rel
    else:
        assert min(rel) > 1e-3, rel


def test_chunked_attention_on_the_cpu_stays_differentiable():
    """C16: the CPU path is the reference's loop and gives q, k and v the
    reference's gradients (the card's goes through the backward
    kernel)."""
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
    """C16, closed: under grad mode an input that requires grad sends the
    wrapper and the op through the autograd Function (its output carries
    the Function's backward), and on the CPU nothing is built or
    launched."""
    from repro_torch.kernels import nvcc
    fa.reset_launch_counts()
    _, (q, k, v) = _qkv((1, 4, 2, 8, 32), "float32")
    args = {"q": q, "k": k, "v": v}
    args[which] = args[which].clone().requires_grad_(True)
    for fn in (fa.flash_attention_cuda, ops.attention_op):
        out = fn(args["q"], args["k"], args["v"])
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        out.sum().backward()
        assert args[which].grad is not None
    with torch.no_grad():
        assert fa.flash_attention_cuda(args["q"], args["k"], args["v"]).grad_fn is None
    assert fa.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_bwd_cuda": 0}
    assert all(source not in (fa.SOURCE, fa.BWD_SOURCE) for source, _ in nvcc._LIBS)


# the Function on the CPU against jax.vjp of the reference: one case of
# each dtype / mask / group / length in tier 1, the full matrix under slow
_GRAD_TIER1 = {("float32", True, 1, 8), ("float32", False, 4, 77), ("bfloat16", True, 4, 256),
               ("bfloat16", False, 1, 77)}
GRAD_CASES = [
    pytest.param(dtype, causal, group, s,
                 marks=() if (dtype, causal, group, s) in _GRAD_TIER1 else pytest.mark.slow,
                 id=f"{dtype}-{'causal' if causal else 'full'}-g{group}-s{s}")
    for dtype in ("float32", "bfloat16") for causal in (True, False)
    for group in (1, 4) for s in (8, 77, 256)
]


@pytest.mark.parametrize("dtype,causal,group,s", GRAD_CASES)
def test_attention_function_gradients_match_reference_vjp(dtype, causal, group, s):
    import jax

    (jq, jk, jv), (q, k, v) = _qkv((1, 2 * group, 2, s, 32), dtype, seed=s + group)
    rng = np.random.default_rng(7)
    g = rng.standard_normal(q.shape).astype(np.float32)
    jg = jnp.asarray(g, JNP[dtype])
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(TORCH[dtype])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.attention_op(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, tg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for fn in (lambda a, b, c: jax_attn.chunked_attention(a, b, c, causal=causal, chunk=64),
               lambda a, b, c: jax_ref.mha_reference(a, b, c, causal=causal)):
        _, vjp = jax.vjp(fn, jq, jk, jv)
        for t, w in zip(got, vjp(jg)):
            w = np.asarray(w, np.float32)
            assert t.dtype == TORCH[dtype]
            assert float(np.abs(_f32(t) - w).max()) <= tol * float(np.abs(w).max())


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_equals_autograd_through_the_plain_forward(causal):
    _, (q, k, v) = _qkv((2, 8, 2, 40, 32), "float32", seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.mha_reference(*leaves, causal=causal)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, leaves, g)
    o, lse = ref.mha_reference_lse(q, k, v, causal=causal)
    assert torch.equal(o, out.detach())
    got = ref.mha_backward_reference(q, k, v, o, lse, g, causal=causal)
    for t, w in zip(got, want):
        assert float((t - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    meta = dict(device="meta")
    q = torch.empty((1, 4, 8, 32), **meta)
    k = torch.empty((1, 2, 8, 32), **meta)
    lse = torch.empty((1, 4, 8), **meta)
    with pytest.raises(ValueError, match="out and d_out"):
        fa.flash_attention_bwd_cuda(q, k, k, q[:, :2], lse, q)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, k, q, lse[..., :4], q)
    with pytest.raises(TypeError, match="lse has dtype"):
        fa.flash_attention_bwd_cuda(q, k, k, q, lse.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.empty((1, 4, 8, 48), **meta)
        fa.flash_attention_bwd_cuda(x, x, x, x, lse, x)


def test_backward_that_fails_to_build_raises_and_nothing_reroutes(monkeypatch):
    """On a stand-in for card tensors (meta): a backward library that
    does not build raises out of the autograd backward, and the plain
    twin is never called in its place."""
    import subprocess
    from repro_torch.kernels import nvcc

    def failing_build(source, flags=nvcc.NVCC_FLAGS):
        raise subprocess.CalledProcessError(1, ["nvcc", str(source)])

    twin_calls = []
    monkeypatch.setattr(nvcc, "_LIBS", {})
    monkeypatch.setattr(nvcc, "build", failing_build)
    monkeypatch.setattr(ref, "mha_backward_reference",
                        lambda *a, **kw: twin_calls.append(1))
    # the forward stands in too: it returns a meta output and LSE
    monkeypatch.setattr(fa, "_forward", lambda q, k, v, causal, lse: (
        torch.empty_like(q), torch.empty(q.shape[:3], device=q.device)))
    q, k, v = (torch.empty((1, h, 8, 32), device="meta", requires_grad=True)
               for h in (4, 2, 2))
    out = fa.flash_attention_cuda(q, k, v)
    with pytest.raises(subprocess.CalledProcessError):
        out.sum().backward()
    with pytest.raises(subprocess.CalledProcessError):
        fa.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(), q.detach(),
                                    torch.empty((1, 4, 8), device="meta"), q.detach())
    assert twin_calls == []
    assert fa.LAUNCHES["flash_attention_bwd_cuda"] == 0


def test_backward_source_names_what_it_computes_and_uses_no_atomics():
    src = fa.BWD_SOURCE.read_text()
    assert "src/repro/models/attention.py:33" in src
    assert "src/repro/train/train_step.py:34" in src
    assert "atomic" not in src.replace("no atomics", "")
    for kernel in ("attention_bwd_prepass", "attention_dkdv_kernel", "attention_dq_kernel",
                   "attention_bwd_prepass_pairs", "attention_dkdv_bf16_kernel",
                   "attention_group_sum", "attention_dq_bf16_kernel"):
        assert f"{kernel}(" in src
    # the bf16 kernels: wgmma fed by TMA, through the forward's pieces
    assert '#include "sm90.cuh"' in src and "tma_load(" in src and "mma_rs(" in src
    # its own library: the forward's build hash does not depend on it
    from repro_torch.kernels import nvcc
    assert fa.library_path() == nvcc.library_path(fa.SOURCE, fa.FLAGS)
    assert nvcc.library_path(fa.BWD_SOURCE, fa.FLAGS).name.startswith("flash_attention_bwd-")


def test_library_hash_covers_included_headers(tmp_path):
    """A source's library is named by its bytes and those of the headers
    it includes: an edited header never loads a stale build."""
    from repro_torch.kernels import nvcc
    for name in (fa.BWD_SOURCE.name, "sm90.cuh"):
        (tmp_path / name).write_bytes((fa.BWD_SOURCE.parent / name).read_bytes())
    src = tmp_path / fa.BWD_SOURCE.name
    assert nvcc._included_headers(src) == [tmp_path / "sm90.cuh"]
    before = nvcc.library_path(src, fa.FLAGS)
    assert before == nvcc.library_path(fa.BWD_SOURCE, fa.FLAGS)
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert nvcc.library_path(src, fa.FLAGS) != before
    assert nvcc.library_path(src, fa.FLAGS).name.startswith("flash_attention_bwd-")


def test_padded_head_dim_runs_through_the_kernel_path():
    """D = 16 (the reduced configs' heads) is zero-padded to 32 for the
    kernels: the padded call computes the same function."""
    _, (q, k, v) = _qkv((1, 4, 2, 20, 16), "float32", seed=2)
    qp, kp, vp = fa._padded((q, k, v), 16)
    assert qp.shape[-1] == 32 and bool((qp[..., 16:] == 0).all())
    # the padded columns add nothing to a score (the kernel keeps the
    # true scale, 1/sqrt(16))
    s16 = ref._masked_scores(q, k, False)
    s32 = ref._masked_scores(qp, kp, False) * np.sqrt(32) / np.sqrt(16)
    assert torch.allclose(s16, s32, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_card_attention_refuses_grad_and_runs_under_no_grad():
    """C16, closed, on the card: the wrapper and `chunked_attention`
    carry a gradient through the backward kernel, equal to the plain
    twin's at the kernel's tolerances; under no_grad the output has no
    graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    for dtype, tol in (("bfloat16", 2e-2), ("float32", 1e-4)):
        _, qkv = _qkv((1, 4, 2, 64, 32), dtype)
        qkv = [t.to(dev) for t in qkv]
        o, lse = ref.mha_reference_lse(*qkv)
        g = torch.randn(o.shape, device=dev).to(o.dtype)
        want = ref.mha_backward_reference(*qkv, o, lse, g)
        for fn in (fa.flash_attention_cuda, attention.chunked_attention):
            fa.reset_launch_counts()
            leaves = [t.clone().requires_grad_(True) for t in qkv]
            got = torch.autograd.grad(fn(*leaves), leaves, g)
            torch.cuda.synchronize()
            assert fa.LAUNCHES == {"flash_attention_cuda": 1, "flash_attention_bwd_cuda": 1}
            for t, w in zip(got, want):
                assert float((t.float() - w.float()).abs().max()) <= tol * float(
                    w.float().abs().max())
            with torch.no_grad():
                assert not fn(*leaves).requires_grad
