// Merged range scans for Hopper (sm_90a): rows of (base minus
// tombstones) ∪ (staged inserts) in merge order, addressed by merged
// rank, without materializing the merge.
//
// rmi_scan_range_kernel replaces the reference's Pallas kernel
//   rmi_scan_range_pallas (src/repro/kernels/rmi_lookup.py:510,
//                          body _scan_range_kernel at :466)
// It ranks the endpoints of [lo, hi) from the prefix-sum page index,
// r = live_prefix[lb(base, b)] + lb(ins, b), once per block into shared
// memory (the reference recomputes them in every grid step: same
// answer), then resolves each lane's rank t = r0 + lane to a row with
// two single-gather searches: j = lb(ins_rank, t) staged inserts
// precede t, and the (t-j)-th live base row is lb(live_prefix, t-j+1)-1.
//
// rmi_sharded_scan_kernel replaces
//   rmi_sharded_scan_page_pallas (src/repro/kernels/rmi_lookup.py:605,
//                                 body _sharded_scan_kernel at :564)
// One thread per (shard, output lane), the shard on blockIdx.y: a lane
// owns global stream slot t when own_lo <= t < own_hi of its shard, and
// resolves the shard-local rank ls0 + t - own_lo (int32, wrapping like
// the reference) through the same rows-from-index path as the range
// kernel, against its own shard's slab row; other lanes emit
// (+inf, 0, dead).  The caller reduces min/sum/max over the shards.
//
// rmi_scan_page_kernel replaces
//   rmi_scan_page_pallas  (src/repro/kernels/rmi_lookup.py:336,
//                          body _scan_page_kernel at :301 and
//                          _scan_page_body at :219)
// It takes explicit page start ranks and resolves each lane's rank by
// nested searches over the tombstoned base positions: the partition
// runs isteps trips of (base lower bound + del_pos lower bound), the
// select runs steps trips of a del_pos lower bound.
//
// What bounds them on this card: dependent 4-byte gathers.  The range
// kernel's lane runs msteps probes into ins_rank (a few MB, in L2) and
// psteps probes into live_prefix (780 MB at 195M keys), but the lanes of
// a warp hold neighbouring ranks, so their probes coincide until the
// last few levels and a warp's load is one or two sectors; the rows it
// finally reads (base key and value) are contiguous.  The byte bound is
// its reads of the rows in range plus its writes.  The page kernel
// chains about isteps*(steps+dsteps) + steps*dsteps dependent gathers
// per lane and is slow by design; it stays as the cross-check of the
// range kernel's rows.  One lane per thread, no shared memory beyond the
// two endpoint ranks, many resident warps to keep chains in flight;
// the sharded kernel repeats the range kernel's per-lane work on each of
// S rows, of which one owns the lane;
// staging the top search levels in shared memory is later work.
//
// Every gather index is clipped exactly where the reference clips it: a
// load out of bounds is not clamped on the card.  int32 sums that can
// pass 2**31 (page starts, ranks plus offsets) wrap, as the reference's
// int32 arithmetic and the plain PyTorch twin do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clipi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Fixed-trip lower bound of q in arr[0:size]; converged lanes are pinned
// by lo < hi so extra trips never walk lo past size.  v < NaN is false.
template <typename T>
__device__ __forceinline__ int lower_bound(const T* __restrict__ arr, T q,
                                           int size, int steps) {
  int lo = 0, hi = size;
  for (int s = 0; s < steps; ++s) {
    int mid = (lo + hi) >> 1;
    bool r = (__ldg(arr + clipi(mid, 0, size - 1)) < q) && (lo < hi);
    lo = r ? mid + 1 : lo;
    hi = r ? hi : mid;
  }
  return lo;
}

// min(base row p, insert row j) with its source's value (base wins a
// tie); a dead lane writes (+inf, 0, 0).
__device__ __forceinline__ void emit(bool valid, int p, int j,
                                     const float* __restrict__ base,
                                     const int* __restrict__ bvals, int n,
                                     const float* __restrict__ ins,
                                     const int* __restrict__ ivals, int ni,
                                     int lane, float* __restrict__ out_k,
                                     int* __restrict__ out_v,
                                     int* __restrict__ out_live) {
  float key = CUDART_INF_F;
  int val = 0;
  if (valid) {
    int pc = clipi(p, 0, n - 1), jc = clipi(j, 0, ni - 1);
    float a_key = (p < 0 || p >= n) ? CUDART_INF_F : __ldg(base + pc);
    float c_key = (j >= ni) ? CUDART_INF_F : __ldg(ins + jc);
    bool from_ins = c_key < a_key;
    key = from_ins ? c_key : a_key;
    val = from_ins ? __ldg(ivals + jc) : __ldg(bvals + pc);
  }
  out_k[lane] = key;
  out_v[lane] = val;
  out_live[lane] = valid ? 1 : 0;
}

// Rank t -> merged row through the prefix-sum page index: j staged
// inserts precede rank t, and the (t-j)-th live base row is
// lb(live_prefix, t-j+1) - 1 (the reference's _scan_rows_from_index).
__device__ __forceinline__ void rows_from_index(
    int t, bool valid, const float* __restrict__ base,
    const int* __restrict__ bvals, const int* __restrict__ live_prefix, int n,
    const float* __restrict__ ins, const int* __restrict__ ivals,
    const int* __restrict__ ins_rank, int ni, int psteps, int msteps,
    int lane, float* __restrict__ out_k, int* __restrict__ out_v,
    int* __restrict__ out_live) {
  int j = lower_bound(ins_rank, t, ni, msteps);
  int p = lower_bound(live_prefix, wadd(wsub(t, j), 1), n + 1, psteps) - 1;
  emit(valid, p, j, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
       out_live);
}

__global__ void __launch_bounds__(256)
rmi_scan_range_kernel(const float* __restrict__ bounds,
                      const float* __restrict__ base,
                      const int* __restrict__ bvals,
                      const int* __restrict__ live_prefix, int n,
                      const float* __restrict__ ins,
                      const int* __restrict__ ivals,
                      const int* __restrict__ ins_rank, int ni, int lanes,
                      int steps, int isteps, int psteps, int msteps,
                      float* __restrict__ out_k, int* __restrict__ out_v,
                      int* __restrict__ out_live) {
  __shared__ int ends[2];
  if (threadIdx.x < 2) {
    float b = __ldg(bounds + threadIdx.x);
    int bl = lower_bound(base, b, n, steps);
    ends[threadIdx.x] = wadd(__ldg(live_prefix + bl), lower_bound(ins, b, ni, isteps));
  }
  __syncthreads();
  int r0 = ends[0];
  int r1 = max(ends[1], r0);  // inverted ranges clamp empty
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int t = wadd(r0, lane);
  rows_from_index(t, t < r1, base, bvals, live_prefix, n, ins, ivals, ins_rank,
                  ni, psteps, msteps, lane, out_k, out_v, out_live);
}

// Slabs (S, n), (S, n + 1) and (S, ni) row-major; outputs (S, lanes).
__global__ void __launch_bounds__(256)
rmi_sharded_scan_kernel(const float* __restrict__ base,
                        const int* __restrict__ bvals,
                        const int* __restrict__ live_prefix, int n,
                        const float* __restrict__ ins,
                        const int* __restrict__ ivals,
                        const int* __restrict__ ins_rank, int ni,
                        const int* __restrict__ ls0,
                        const int* __restrict__ own_lo,
                        const int* __restrict__ own_hi, int lanes, int psteps,
                        int msteps, float* __restrict__ out_k,
                        int* __restrict__ out_v, int* __restrict__ out_live) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  long long s = blockIdx.y;
  int lo = __ldg(own_lo + s);
  bool owner = lane >= lo && lane < __ldg(own_hi + s);
  int t = wadd(__ldg(ls0 + s), wsub(lane, lo));
  long long o = s * lanes;
  rows_from_index(t, owner, base + s * n, bvals + s * n,
                  live_prefix + s * (n + 1), n, ins + s * ni, ivals + s * ni,
                  ins_rank + s * ni, ni, psteps, msteps, lane, out_k + o,
                  out_v + o, out_live + o);
}

__global__ void __launch_bounds__(256)
rmi_scan_page_kernel(const int* __restrict__ starts, int page_size,
                     const float* __restrict__ base,
                     const int* __restrict__ bvals, int n,
                     const float* __restrict__ ins,
                     const int* __restrict__ ivals, int ni,
                     const int* __restrict__ del_pos, int nd,
                     const int* __restrict__ end_rank, int lanes, int steps,
                     int isteps, int dsteps, float* __restrict__ out_k,
                     int* __restrict__ out_v, int* __restrict__ out_live) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int t = wadd(__ldg(starts + lane / page_size), lane % page_size);

  // ---- partition: staged inserts among the first t merged rows -------
  int lo = 0, hi = ni;
  for (int s = 0; s < isteps; ++s) {
    int mid = (lo + hi) >> 1;
    float ck = mid >= ni ? CUDART_INF_F : __ldg(ins + clipi(mid, 0, ni - 1));
    int bl = lower_bound(base, ck, n, steps);
    int dl = lower_bound(del_pos, bl, nd, dsteps);
    bool pred = wadd(mid, bl - dl) >= t;
    bool adv = !pred && (lo < hi);
    lo = adv ? mid + 1 : lo;
    hi = pred ? mid : hi;
  }
  int j = lo;
  int i1 = wadd(wsub(t, j), 1);

  // ---- select: the (t-j)-th live base position -------------------------
  lo = 0;
  hi = n;
  for (int s = 0; s < steps; ++s) {
    int mid = (lo + hi) >> 1;
    int dl = lower_bound(del_pos, mid + 1, nd, dsteps);
    bool pred = (mid + 1 - dl) >= i1;
    bool adv = !pred && (lo < hi);
    lo = adv ? mid + 1 : lo;
    hi = pred ? mid : hi;
  }
  emit(t >= 0 && t < __ldg(end_rank), lo, j, base, bvals, n, ins, ivals, ni,
       lane, out_k, out_v, out_live);
}

extern "C" int rmi_scan_range_launch(
    const float* bounds, const float* base, const int* bvals,
    const int* live_prefix, int n, const float* ins, const int* ivals,
    const int* ins_rank, int ni, int lanes, int steps, int isteps, int psteps,
    int msteps, float* out_k, int* out_v, int* out_live, void* stream) {
  const int threads = 256;
  dim3 grid((lanes + threads - 1) / threads);
  rmi_scan_range_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      bounds, base, bvals, live_prefix, n, ins, ivals, ins_rank, ni, lanes,
      steps, isteps, psteps, msteps, out_k, out_v, out_live);
  return (int)cudaGetLastError();
}

extern "C" int rmi_scan_page_launch(
    const int* starts, int page_size, const float* base, const int* bvals,
    int n, const float* ins, const int* ivals, int ni, const int* del_pos,
    int nd, const int* end_rank, int lanes, int steps, int isteps, int dsteps,
    float* out_k, int* out_v, int* out_live, void* stream) {
  const int threads = 256;
  dim3 grid((lanes + threads - 1) / threads);
  rmi_scan_page_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      starts, page_size, base, bvals, n, ins, ivals, ni, del_pos, nd,
      end_rank, lanes, steps, isteps, dsteps, out_k, out_v, out_live);
  return (int)cudaGetLastError();
}

extern "C" int rmi_sharded_scan_launch(
    const float* base, const int* bvals, const int* live_prefix, int S, int n,
    const float* ins, const int* ivals, const int* ins_rank, int ni,
    const int* ls0, const int* own_lo, const int* own_hi, int lanes,
    int psteps, int msteps, float* out_k, int* out_v, int* out_live,
    void* stream) {
  const int threads = 256;
  dim3 grid((lanes + threads - 1) / threads, S);
  rmi_sharded_scan_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      base, bvals, live_prefix, n, ins, ivals, ins_rank, ni, ls0, own_lo,
      own_hi, lanes, psteps, msteps, out_k, out_v, out_live);
  return (int)cudaGetLastError();
}
