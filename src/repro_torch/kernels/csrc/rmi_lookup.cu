// Fused RMI lookup for Hopper (sm_90a): stage-0 MLP -> leaf select ->
// leaf position -> error window -> first probe at the prediction ->
// fixed-trip branchless search over the sorted base keys, and with
// WITH_DELTA a fixed-trip lower bound over the staged delta keys plus
// one prefix gather.
//
// rmi_lookup_kernel replaces the reference's Pallas kernels
//   rmi_merged_lookup_pallas  (src/repro/kernels/rmi_lookup.py:827,
//                              body _rmi_merged_kernel)      WITH_DELTA
//   rmi_lookup_pallas         (src/repro/kernels/rmi_lookup.py:778,
//                              body _rmi_kernel)             !WITH_DELTA
// which share _base_lower_bound and _delta_lower_bound.
//
// rmi_sharded_lookup_kernel replaces
//   rmi_sharded_merged_lookup_pallas (src/repro/kernels/rmi_lookup.py:895,
//                                     body _sharded_shard_body at :668)
// One thread per (shard, query), the shard on blockIdx.y: the same
// per-query body with each shard's n, leaf count and f32(m/n) read as
// runtime values, `steps` the maximum over the shards, and the final
// lower bound clamped to the shard's n (extra trips past a smaller
// shard's window overshoot only there).  Every stacked array is
// addressed by its own row stride, so a row broadcast with
// `expand` (stride 0) is read in place.  It emits per-shard
// (local base_lb, delta prefix contribution); the caller reassembles
// global ranks from the routed row and the shard offsets.
//
// What bounds them on this card: dependent 4-byte gathers from device
// memory.  Each query reads its 4-byte key, the leaf's four parameters
// (4 sectors, one leaf index), the first probe and `steps` halving
// probes into the base keys: about 4 + 1 + steps sectors for the base,
// and `dsteps` more for the delta, whose few MB usually sit in L2.  The
// probes of one query depend on each other, so the time is a chain of
// memory latencies per thread; the design answers that with one query
// per thread and many resident warps (no shared memory, few registers),
// so the card keeps many chains in flight.  The sharded kernel searches
// every query on every shard row, as the reference's grid does: S times
// the single-shard work.  Staging the top search levels in shared
// memory, and searching only the routed row, are later work.
//
// The window contract: a stored key is found only if this kernel picks
// the same leaf and the same position as the build did.  The build runs
// the plain PyTorch stage-0 (core/models.py:stage0_apply), so every
// multiply-add here is a separately rounded __fmul_rn then __fadd_rn
// (and the file is built with -fmad=false), hidden layers sum over
// their inputs in ascending order, and float-to-int casts clamp in
// float first (see to_index).  The position clamps to f32(n - 1), the
// build's clamp; the reference's sharded body clamps to f32(n) - 1,
// which differs above 2**24 (ROADMAP queue C).  Every gather index is
// clipped: a load out of bounds is not clamped on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_HIDDEN 64
#define INDEX_CLAMP 1073741824.0f  // 2**30: every rank fits with room for +1

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x > lo ? x : lo;  // NaN -> lo, like the plain version's select
  return x < hi ? x : hi;
}

__device__ __forceinline__ int to_index(float x, float lo) {
  return (int)clampf(x, lo, INDEX_CLAMP);  // truncation toward zero
}

// One dense layer in the fixed order: acc = x0*w0j; acc += xk*wkj; + bj.
__device__ __forceinline__ float dense_out(const float* __restrict__ x, int din,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int dout, int j) {
  float acc = __fmul_rn(x[0], __ldg(w + j));
  for (int k = 1; k < din; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(x[k], __ldg(w + k * dout + j)));
  }
  return __fadd_rn(acc, __ldg(b + j));
}

__device__ __forceinline__ float stage0(float q, const float* __restrict__ s0,
                                        int nl, int h1, int h2) {
  if (nl == 1) {  // linear stage-0: w0 (1,1), b0 (1,)
    return __fadd_rn(__fmul_rn(q, __ldg(s0)), __ldg(s0 + 1));
  }
  float x[MAX_HIDDEN];
  float y[MAX_HIDDEN];
  int dims[4] = {1, h1, nl == 3 ? h2 : 1, 1};
  x[0] = q;
  const float* p = s0;
  for (int l = 0; l < nl; ++l) {
    int din = dims[l], dout = dims[l + 1];
    const float* w = p;
    const float* b = p + din * dout;
    p = b + dout;
    for (int j = 0; j < dout; ++j) {
      float v = dense_out(x, din, w, b, dout, j);
      y[j] = (l < nl - 1) ? (v > 0.0f ? v : 0.0f) : v;
    }
    for (int j = 0; j < dout; ++j) x[j] = y[j];
  }
  return x[0];
}

// stage-0 -> leaf select -> clipped leaf position -> window -> first
// probe -> `steps` halving trips: the base lower bound of one query
// (the reference's _base_lower_bound), without the sharded clamp.
__device__ __forceinline__ int base_lower_bound(
    float qq, const float* __restrict__ s0, int nl, int h1, int h2,
    const float* __restrict__ leaf_w, const float* __restrict__ leaf_b,
    const float* __restrict__ err_lo, const float* __restrict__ err_hi, int M,
    float ratio, const float* __restrict__ keys, int n, float nm1f,
    int steps) {
  // ---- stage 0 -> leaf select -> clipped leaf position ----------------
  float p0 = stage0(qq, s0, nl, h1, h2);
  int leaf = min(to_index(floorf(__fmul_rn(p0, ratio)), 0.0f), M - 1);
  float pos = __fadd_rn(__fmul_rn(__ldg(leaf_w + leaf), qq), __ldg(leaf_b + leaf));
  pos = clampf(pos, 0.0f, nm1f);

  // ---- error window: clip(int(pos+lo), 0, n), clip(int(pos+hi)+1, 0, n)
  int lo = min(to_index(__fadd_rn(pos, __ldg(err_lo + leaf)), 0.0f), n);
  int hi = max(min(to_index(__fadd_rn(pos, __ldg(err_hi + leaf)), -1.0f) + 1, n), 0);

  // ---- first probe at the prediction (model binary search §3.4) -------
  int p0i = min(to_index(pos, 0.0f), n - 1);
  bool right = __ldg(keys + p0i) < qq;
  lo = right ? max(lo, p0i + 1) : lo;
  hi = right ? hi : min(hi, p0i);

  // ---- fixed-trip branchless halving -----------------------------------
  for (int s = 0; s < steps; ++s) {
    int mid = (lo + hi) >> 1;
    bool r = __ldg(keys + min(mid, n - 1)) < qq;
    lo = r ? mid + 1 : lo;
    hi = r ? hi : mid;
  }
  return lo;
}

// Full-range lower bound over the +inf-padded delta keys (no pin: with
// an unpadded power-of-two delta it can reach D + 1, which the prefix
// gather clamps).
__device__ __forceinline__ int delta_lower_bound(float qq,
                                                 const float* __restrict__ dkeys,
                                                 int D, int dsteps) {
  int dlo = 0, dhi = D;
  for (int s = 0; s < dsteps; ++s) {
    int mid = (dlo + dhi) >> 1;
    bool r = __ldg(dkeys + min(mid, D - 1)) < qq;
    dlo = r ? mid + 1 : dlo;
    dhi = r ? dhi : mid;
  }
  return dlo;
}

template <bool WITH_DELTA>
__global__ void __launch_bounds__(256)
rmi_lookup_kernel(const float* __restrict__ q, int B,
                  const float* __restrict__ s0, int nl, int h1, int h2,
                  const float* __restrict__ leaf_w,
                  const float* __restrict__ leaf_b,
                  const float* __restrict__ err_lo,
                  const float* __restrict__ err_hi, int M, float ratio,
                  const float* __restrict__ keys, int n, float nm1f, int steps,
                  const float* __restrict__ dkeys,
                  const int* __restrict__ dprefix, int D, int dsteps,
                  int* __restrict__ out_base, int* __restrict__ out_merged) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float qq = q[i];
  int lo = base_lower_bound(qq, s0, nl, h1, h2, leaf_w, leaf_b, err_lo,
                            err_hi, M, ratio, keys, n, nm1f, steps);
  out_base[i] = lo;
  if (WITH_DELTA) {
    int dlo = delta_lower_bound(qq, dkeys, D, dsteps);
    out_merged[i] = lo + __ldg(dprefix + min(dlo, D));
  }
}

// Row strides (in elements) of the stacked inputs; 0 reads one row for
// every shard.
struct ShardStrides {
  long long q, s0, leaf_w, leaf_b, err_lo, err_hi, keys, dkeys, dprefix;
};

__global__ void __launch_bounds__(256)
rmi_sharded_lookup_kernel(const float* __restrict__ q, int B,
                          const float* __restrict__ s0, int nl, int h1, int h2,
                          const float* __restrict__ leaf_w,
                          const float* __restrict__ leaf_b,
                          const float* __restrict__ err_lo,
                          const float* __restrict__ err_hi,
                          const float* __restrict__ keys,
                          const float* __restrict__ dkeys,
                          const int* __restrict__ dprefix, int D,
                          const int* __restrict__ shard_n,
                          const int* __restrict__ shard_m,
                          const float* __restrict__ shard_ratio, int steps,
                          int dsteps, ShardStrides st,
                          int* __restrict__ out_base,
                          int* __restrict__ out_contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  long long s = blockIdx.y;
  int n = __ldg(shard_n + s);
  int M = __ldg(shard_m + s);
  float qq = q[s * st.q + i];
  int lo = base_lower_bound(
      qq, s0 + s * st.s0, nl, h1, h2, leaf_w + s * st.leaf_w,
      leaf_b + s * st.leaf_b, err_lo + s * st.err_lo, err_hi + s * st.err_hi,
      M, __ldg(shard_ratio + s), keys + s * st.keys, n, __int2float_rn(n - 1),
      steps);
  int dlo = delta_lower_bound(qq, dkeys + s * st.dkeys, D, dsteps);
  out_base[s * B + i] = min(lo, n);
  out_contrib[s * B + i] = __ldg(dprefix + s * st.dprefix + min(dlo, D));
}

extern "C" int rmi_lookup_launch(
    const float* q, int B, const float* s0, int nl, int h1, int h2,
    const float* leaf_w, const float* leaf_b, const float* err_lo,
    const float* err_hi, int M, float ratio, const float* keys, int n,
    float nm1f, int steps, const float* dkeys, const int* dprefix, int D,
    int dsteps, int* out_base, int* out_merged, void* stream) {
  const int threads = 256;
  dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dkeys != nullptr) {
    rmi_lookup_kernel<true><<<grid, threads, 0, st>>>(
        q, B, s0, nl, h1, h2, leaf_w, leaf_b, err_lo, err_hi, M, ratio, keys,
        n, nm1f, steps, dkeys, dprefix, D, dsteps, out_base, out_merged);
  } else {
    rmi_lookup_kernel<false><<<grid, threads, 0, st>>>(
        q, B, s0, nl, h1, h2, leaf_w, leaf_b, err_lo, err_hi, M, ratio, keys,
        n, nm1f, steps, nullptr, nullptr, 0, 0, out_base, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmi_sharded_lookup_launch(
    const float* q, int S, int B, const float* s0, int nl, int h1, int h2,
    const float* leaf_w, const float* leaf_b, const float* err_lo,
    const float* err_hi, const float* keys, const float* dkeys,
    const int* dprefix, int D, const int* shard_n, const int* shard_m,
    const float* shard_ratio, int steps, int dsteps, const long long* strides,
    int* out_base, int* out_contrib, void* stream) {
  const int threads = 256;
  dim3 grid((B + threads - 1) / threads, S);
  ShardStrides st = {strides[0], strides[1], strides[2], strides[3], strides[4],
                     strides[5], strides[6], strides[7], strides[8]};
  rmi_sharded_lookup_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      q, B, s0, nl, h1, h2, leaf_w, leaf_b, err_lo, err_hi, keys, dkeys,
      dprefix, D, shard_n, shard_m, shard_ratio, steps, dsteps, st, out_base,
      out_contrib);
  return (int)cudaGetLastError();
}
