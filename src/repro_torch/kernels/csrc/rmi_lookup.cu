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
// It emits, for every query on every shard row as the reference's grid
// does, the per-shard (local base_lb, delta prefix contribution); the
// caller reassembles global ranks from the routed row and the shard
// offsets.  Each row runs the single-shard body with its shard's n, leaf
// count and f32(m/n) as runtime values, `steps` the maximum over the
// shards, and the lower bound clamped to the shard's n (extra trips past
// a smaller shard's window overshoot only there).  Every stacked input
// is addressed by its own row stride, so a row broadcast with `expand`
// (stride 0) is read in place.
//
// What bounds the lookups on this card: chains of dependent sector reads
// from device memory.  A query gathers a random leaf, then the first
// probe and the halving probes in a random window of the base keys (780
// MB at 195M keys); each gather moves a whole sector for 4 useful bytes,
// and the last trips fall in a sector already fetched.  The delta keys
// (4 MB at 1<<20 entries) are read from L2.  A leaf is one 16-byte
// record (w, b, err_lo, err_hi) read by one vector load: one sector a
// query where four separate arrays cost four.  One query a thread and
// many resident warps keep the chains in flight, and the delta search's
// trips ride beside the base search's (the two do not depend on each
// other), so a thread has two gathers in flight.  Staging the delta's
// top levels in shared memory, several queries a thread and a persistent
// grid were measured on the card and did not pay for the single-shard
// kernel (PERF.md §6).
//
// The sharded lookup searches every query on every row, so S times the
// single-shard work, and only the owning row's search reaches device
// memory: on every other row the query lies outside [0, 1] in that
// shard's frame, its leaf and position clamp to the first or last ones,
// and all such lanes probe the same few lines.  Measured on the card,
// what bounds it is then not the chain of gathers but the work of all
// S x B lanes: the instructions they issue, the distinct lines each
// warp-wide gather touches, and the owned lanes' misses, with the delta
// search (20 trips over 4 MB in L2 at 1<<20 entries) near half the time.
// So each lane's trip is made as cheap as it can be: one thread per
// (shard, query) with the shard on blockIdx.y, the leaf one 16-byte load
// from the (S, M, 4) record `ops.stack_rows` builds, each row's base
// address kept in a register (otherwise the compiler rebuilds
// row * stride + index in 64 bits at every probe), the delta trips
// beside the base trips, and the base trips stopped once every search
// of the warp sits at a fixed point, which no later trip moves, so the
// answer is the fixed-trip one (`settling_trip`).  The alternative, one
// thread per query searching the rows in chunks in lockstep (2 gathers
// a row in flight a trip, B/32 warps), was slower on the card at every
// chunk width: its lanes do the same work with fewer warps and more
// registers (PERF.md §6).  Staging the per-shard scalars and stage-0
// rows in shared memory was slower too.
//
// The window contract: a stored key is found only if this kernel picks
// the same leaf and the same position as the build did.  The build runs
// the plain PyTorch stage-0 (core/models.py:stage0_apply), so every
// multiply-add here is a separately rounded __fmul_rn then __fadd_rn
// (and the file is built with -fmad=false), hidden layers sum over
// their inputs in ascending order, and float-to-int casts clamp in
// float first (see to_index).  The position clamps to f32(n - 1), the
// build's clamp; the reference's sharded body clamps to f32(n) - 1,
// which differs above 2**24 (ROADMAP queue C).  A query that is +inf
// takes the position f32(n - 1), the end of the key range, whatever the
// leaf's slope: on a leaf of slope 0 (keys that share one float32
// value) 0 * inf is NaN, which the clamp would send to 0 and search in
// the window of the first keys (queue C 17).  From there the first
// probe, at n - 1, moves lo to n, so +inf ranks past every key like any
// finite query above them: n + 1 single-shard, n sharded.  -inf and NaN
// clamp to 0.  Every gather index is clipped: a load out of bounds is
// not clamped on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_HIDDEN 64
#define INDEX_CLAMP 1073741824.0f  // 2**30: every rank fits with room for +1
#define POS_INF __int_as_float(0x7f800000)

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

// stage 0 -> leaf select
__device__ __forceinline__ int select_leaf(float qq, const float* __restrict__ s0,
                                           int nl, int h1, int h2, int M,
                                           float ratio) {
  float p0 = stage0(qq, s0, nl, h1, h2);
  return min(to_index(floorf(__fmul_rn(p0, ratio)), 0.0f), M - 1);
}

// One branchless halving trip toward the lower bound of qq in [lo, hi),
// given the value v probed at mid.
__device__ __forceinline__ void halve(int& lo, int& hi, int mid, float v,
                                      float qq) {
  bool r = v < qq;
  lo = r ? mid + 1 : lo;
  hi = r ? hi : mid;
}

// Leaf record (w, b, err_lo, err_hi) -> clipped leaf position -> error
// window -> first probe at the prediction (model binary search §3.4):
// the window [lo, hi) the halving trips search.
__device__ __forceinline__ void base_window(float qq, float4 leaf,
                                            const float* __restrict__ keys,
                                            int n, float nm1f, int& lo,
                                            int& hi) {
  float pos = __fadd_rn(__fmul_rn(leaf.x, qq), leaf.y);
  pos = clampf(qq == POS_INF ? nm1f : pos, 0.0f, nm1f);
  // clip(int(pos+lo), 0, n), clip(int(pos+hi)+1, 0, n)
  lo = min(to_index(__fadd_rn(pos, leaf.z), 0.0f), n);
  hi = max(min(to_index(__fadd_rn(pos, leaf.w), -1.0f) + 1, n), 0);
  int p0i = min(to_index(pos, 0.0f), n - 1);
  bool right = __ldg(keys + p0i) < qq;
  lo = right ? max(lo, p0i + 1) : lo;
  hi = right ? hi : min(hi, p0i);
}

// One trip of the full-range lower bound over the +inf-padded delta keys
// (no pin: with an unpadded power-of-two delta the search can reach
// D + 1, which the prefix gather clamps).
__device__ __forceinline__ void delta_trip(int& lo, int& hi,
                                           const float* __restrict__ dkeys,
                                           int D, float qq) {
  int mid = (lo + hi) >> 1;
  halve(lo, hi, mid, __ldg(dkeys + min(mid, D - 1)), qq);
}

// The delta search does not depend on the base search, so its trips
// ride along the base trips: each thread keeps two gathers in flight.
template <bool WITH_DELTA>
__global__ void __launch_bounds__(256)
rmi_lookup_kernel(const float* __restrict__ q, int B,
                  const float* __restrict__ s0, int nl, int h1, int h2,
                  const float4* __restrict__ leaves, int M, float ratio,
                  const float* __restrict__ keys, int n, float nm1f, int steps,
                  const float* __restrict__ dkeys,
                  const int* __restrict__ dprefix, int D, int dsteps,
                  int* __restrict__ out_base, int* __restrict__ out_merged) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float qq = q[i];
  int lo, hi, dlo = 0, dhi = D;
  base_window(qq, __ldg(leaves + select_leaf(qq, s0, nl, h1, h2, M, ratio)),
              keys, n, nm1f, lo, hi);
  for (int s = 0; s < steps; ++s) {
    int mid = (lo + hi) >> 1;
    float v = __ldg(keys + min(mid, n - 1));
    if (WITH_DELTA && s < dsteps) delta_trip(dlo, dhi, dkeys, D, qq);
    halve(lo, hi, mid, v, qq);
  }
  out_base[i] = lo;
  if (WITH_DELTA) {
    for (int s = steps; s < dsteps; ++s) delta_trip(dlo, dhi, dkeys, D, qq);
    out_merged[i] = lo + __ldg(dprefix + min(dlo, D));
  }
}

// Row strides of the stacked inputs, in elements (`leaf` in 16-byte
// records); 0 reads one row for every shard.
struct ShardStrides {
  long long q, s0, leaf, keys, dkeys, dprefix;
};

struct ShardArgs {
  const float* q;
  int S, B;
  const float* s0;
  int nl, h1, h2;
  const float4* leaves;
  const float* keys;
  const float* dkeys;
  const int* dprefix;
  int D, steps, dsteps;
  ShardStrides st;
  const int* shard_n;
  const int* shard_m;
  const float* shard_ratio;
  int* out_base;
  int* out_contrib;
};

// One base trip that also reports whether the search now sits at a
// fixed point, which no later trip moves: (x + 1, x), or (x, x) just
// after a probe at x that was not below qq.  From [lo, hi) with
// lo <= hi a trip keeps lo <= hi + 1, and (x, x) steps at most once, to
// (x + 1, x), so a search that reached one ends there.
__device__ __forceinline__ bool settling_trip(int& lo, int& hi, float v, int mid,
                                              float qq) {
  bool r = v < qq;
  lo = r ? mid + 1 : lo;
  hi = r ? hi : mid;
  return (lo == hi + 1) | ((lo == hi) & !r);
}

// A row's base address, kept in a register: without the barrier the
// compiler folds row * stride back into every probe's address.
__device__ __forceinline__ const float* row_pointer(const float* base, long long offset) {
  const float* p = base + offset;
  asm("" : "+l"(p));
  return p;
}

// Query i on shard row s: its leaf and window, then the base and delta
// searches trip by trip, both probes issued before either is compared.
// The base trips stop once every search of the warp (`warp`: its lanes
// in the launch) sits at a fixed point, which gives the fixed-trip
// answer; the delta search, full-range, runs all its trips.
__device__ __forceinline__ void lookup_row(const ShardArgs& a, int i, long long s,
                                           unsigned warp) {
  int n = __ldg(a.shard_n + s);
  int nm1 = n - 1;
  float qq = a.q[s * a.st.q + i];
  int leaf = select_leaf(qq, a.s0 + s * a.st.s0, a.nl, a.h1, a.h2,
                         __ldg(a.shard_m + s), __ldg(a.shard_ratio + s));
  const float* kr = row_pointer(a.keys, s * a.st.keys);
  const float* dr = row_pointer(a.dkeys, s * a.st.dkeys);
  int lo, hi, dlo = 0, dhi = a.D;
  base_window(qq, __ldg(a.leaves + s * a.st.leaf + leaf), kr, n,
              __int2float_rn(nm1), lo, hi);
  bool fixed = lo == hi + 1;
  // both searches side by side while both run, then the longer alone
  int t = 0;
  for (; t < a.steps && t < a.dsteps && !__all_sync(warp, fixed); ++t) {
    int mid = (lo + hi) >> 1;
    int dmid = (dlo + dhi) >> 1;
    float v = __ldg(kr + min(mid, nm1));
    float dv = __ldg(dr + min(dmid, a.D - 1));
    fixed = settling_trip(lo, hi, v, mid, qq);
    halve(dlo, dhi, dmid, dv, qq);
  }
  for (int dt = t; dt < a.dsteps; ++dt) {
    int dmid = (dlo + dhi) >> 1;
    halve(dlo, dhi, dmid, __ldg(dr + min(dmid, a.D - 1)), qq);
  }
  for (; t < a.steps && !__all_sync(warp, fixed); ++t) {
    int mid = (lo + hi) >> 1;
    fixed = settling_trip(lo, hi, __ldg(kr + min(mid, nm1)), mid, qq);
  }
  a.out_base[s * a.B + i] = min(lo, n);
  a.out_contrib[s * a.B + i] = __ldg(a.dprefix + s * a.st.dprefix + min(dlo, a.D));
}

// One thread per (shard, query), the shard on blockIdx.y.  The warp's
// lanes in the launch are fixed by a ballot before any lane leaves.
__global__ void __launch_bounds__(256) rmi_sharded_lookup_kernel(ShardArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned warp = __ballot_sync(0xffffffffu, i < a.B);
  if (i >= a.B) return;
  lookup_row(a, i, blockIdx.y, warp);
}

extern "C" int rmi_lookup_launch(
    const float* q, int B, const float* s0, int nl, int h1, int h2,
    const float* leaves, int M, float ratio, const float* keys, int n,
    float nm1f, int steps, const float* dkeys, const int* dprefix, int D,
    int dsteps, int* out_base, int* out_merged, void* stream) {
  const int threads = 256;
  dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const float4* rec = (const float4*)leaves;
  if (dkeys != nullptr) {
    rmi_lookup_kernel<true><<<grid, threads, 0, st>>>(
        q, B, s0, nl, h1, h2, rec, M, ratio, keys, n, nm1f, steps, dkeys,
        dprefix, D, dsteps, out_base, out_merged);
  } else {
    rmi_lookup_kernel<false><<<grid, threads, 0, st>>>(
        q, B, s0, nl, h1, h2, rec, M, ratio, keys, n, nm1f, steps, nullptr,
        nullptr, 0, 0, out_base, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int rmi_sharded_lookup_launch(
    const float* q, int S, int B, const float* s0, int nl, int h1, int h2,
    const float* leaves, const float* keys, const float* dkeys,
    const int* dprefix, int D, const int* shard_n, const int* shard_m,
    const float* shard_ratio, int steps, int dsteps, const long long* strides,
    int* out_base, int* out_contrib, void* stream) {
  const int threads = 256;
  ShardArgs a = {q, S, B, s0, nl, h1, h2, (const float4*)leaves, keys, dkeys,
                 dprefix, D, steps, dsteps,
                 {strides[0], strides[1], strides[2], strides[3], strides[4],
                  strides[5]},
                 shard_n, shard_m, shard_ratio, out_base, out_contrib};
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((B + threads - 1) / threads, S);
  rmi_sharded_lookup_kernel<<<grid, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
