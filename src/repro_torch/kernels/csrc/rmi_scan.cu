// Merged range scans for Hopper (sm_90a): rows of (base minus
// tombstones) ∪ (staged inserts) in merge order, addressed by merged
// rank, without materializing the merge.
//
// rmi_scan_range_kernel replaces the reference's Pallas kernel
//   rmi_scan_range_pallas (src/repro/kernels/rmi_lookup.py:510,
//                          body _scan_range_kernel at :466)
// It ranks the endpoints of [lo, hi) from the prefix-sum page index,
// r = live_prefix[lb(base, b)] + lb(ins, b), once per block (the
// reference recomputes them in every grid step: same answer), then
// resolves each lane's rank t = r0 + lane to a row: j = lb(ins_rank, t)
// staged inserts precede t, and the (t-j)-th live base row is
// lb(live_prefix, t-j+1)-1.
//
// rmi_sharded_scan_kernel replaces
//   rmi_sharded_scan_page_pallas (src/repro/kernels/rmi_lookup.py:605,
//                                 body _sharded_scan_kernel at :564)
// One thread per (shard, output lane), the shard on blockIdx.y: a lane
// owns global stream slot t when own_lo <= t < own_hi of its shard, and
// resolves the shard-local rank ls0 + t - own_lo (int32, wrapping like
// the reference) through the per-lane fixed-trip searches of
// rows_from_index, against its own shard's slab row; other lanes emit
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
// What bounds the range kernel on this card: the bytes of the rows in
// range (base key, value and live_prefix entry read, three outputs
// written), once the chain of dependent searches that places the first
// row is paid.  Lane by lane, that chain is msteps + psteps (about 48 at
// 195M keys) dependent gathers, repeated by every warp.  The design pays
// it once a tile of consecutive ranks, one tile a block: a
// warp-cooperative 33-ary search (one gather a lane, a ballot, about 6
// rounds over 195M entries) ranks the endpoints, then places the tile's
// first and last valid rank at (j, p).  Lower bounds in a non-decreasing
// array are unique and monotone, so every rank of the tile has its j in
// [j_first, j_last] and its p in [p_first, p_last].  Those spans of
// ins_rank and live_prefix are loaded into shared memory with coalesced
// loads, each lane finishes its searches there and emits its rows
// coalesced.  A span longer than its buffer (a tombstone-dense tile, an
// insert-dense one) is searched in device memory, narrowed to the span.
// ins_rank and live_prefix must be non-decreasing, as `device_scan_slab`
// builds them.  A persistent grid (blocks looping over tiles) measured
// the same and is not used.  The page and sharded kernels chain their
// searches lane by lane; the page kernel is slow by design and stays as
// the cross-check of the range kernel's rows.
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

#define SCAN_THREADS 256
#define FULL_MASK 0xffffffffu

// lo + #{arr[lo:hi] < q} for a non-decreasing arr, by a 33-ary search:
// each round the warp's 32 lanes probe 32 points that cut [lo, hi) into
// 33 parts, and the ballot's count picks the part.  Every lane of the
// warp calls it with the same arguments and gets the same answer.
template <typename T>
__device__ __forceinline__ int warp_lower_bound(const T* __restrict__ arr, T q,
                                                int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    long long span = hi - lo;
    int p = lo + (int)(span * (lane + 1) / 33);
    int c = __popc(__ballot_sync(FULL_MASK, __ldg(arr + p) < q));
    int nlo = c == 0 ? lo : lo + (int)(span * c / 33) + 1;
    hi = c == 32 ? hi : lo + (int)(span * (c + 1) / 33);
    lo = nlo;
  }
  int p = lo + lane;
  bool less = p < hi ? __ldg(arr + p) < q : false;
  return lo + __popc(__ballot_sync(FULL_MASK, less));
}

// #{arr[0:size] < q} for a non-decreasing arr, pinned fixed trips.
template <typename T>
__device__ __forceinline__ int span_lower_bound(const T* arr, T q, int size) {
  int lo = 0, hi = size;
  for (int s = 32 - __clz(size); s > 0; --s) {
    int mid = (lo + hi) >> 1;
    bool r = (lo < hi) && (arr[min(mid, size - 1)] < q);
    lo = r ? mid + 1 : lo;
    hi = r ? hi : mid;
  }
  return lo;
}

// Block b resolves lanes [b * tile, (b + 1) * tile) of the range, with
// `icap` ins_rank and `pcap` live_prefix entries of shared memory.
__global__ void __launch_bounds__(SCAN_THREADS)
rmi_scan_range_kernel(const float* __restrict__ bounds,
                      const float* __restrict__ base,
                      const int* __restrict__ bvals,
                      const int* __restrict__ live_prefix, int n,
                      const float* __restrict__ ins,
                      const int* __restrict__ ivals,
                      const int* __restrict__ ins_rank, int ni, int lanes,
                      int tile, int icap, int pcap, float* __restrict__ out_k,
                      int* __restrict__ out_v, int* __restrict__ out_live) {
  extern __shared__ int span_buf[];
  int* ins_span = span_buf;
  int* lp_span = span_buf + icap;
  __shared__ int part[4];   // lb(base, b0), lb(ins, b0), lb(base, b1), lb(ins, b1)
  __shared__ int edge[4];   // j_first, j_last, p_first, p_last of the tile
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;

  // ---- endpoints: four warps, one search each --------------------------
  if (warp < 4) {
    float b = __ldg(bounds + (warp >> 1));
    int r = (warp & 1) ? warp_lower_bound(ins, b, 0, ni)
                       : warp_lower_bound(base, b, 0, n);
    if (wl == 0) part[warp] = r;
  }
  __syncthreads();
  const int r0 = wadd(__ldg(live_prefix + part[0]), part[1]);
  const int r1 = max(wadd(__ldg(live_prefix + part[2]), part[3]), r0);  // inverted: empty

  // lanes [l0, v1) hold ranks t = r0 + lane < r1 (the wrapper keeps
  // r0 + lanes inside int32); lanes [v1, l1) are masked
  const long long l0 = (long long)blockIdx.x * tile;
  const int l1 = (int)min((long long)lanes, l0 + tile);
  const int v1 = (int)min((long long)l1, max((long long)r1 - r0, l0));
  if (v1 > l0) {
    // ---- the tile's first and last valid rank -> (j, p) ----------------
    const int ta = wadd(r0, (int)l0), tb = wadd(r0, v1 - 1);
    if (warp < 2) {
      int j = warp_lower_bound(ins_rank, warp ? tb : ta, 0, ni);
      if (wl == 0) edge[warp] = j;
    }
    __syncthreads();
    if (warp < 2) {
      int u = warp ? wadd(wsub(tb, edge[0]), 1) : wadd(wsub(ta, edge[1]), 1);
      int p = warp_lower_bound(live_prefix, u, 0, n + 1);
      if (wl == 0) edge[2 + warp] = p;
    }
    __syncthreads();
    // ---- every rank's j in [jf, jf + jn], its p + 1 in [pf, pf + pn] ---
    const int jf = edge[0], jn = edge[1] - edge[0];
    const int pf = edge[2], pn = edge[3] - edge[2];
    const bool ins_in_smem = jn <= icap, lp_in_smem = pn <= pcap;
    if (ins_in_smem)
      for (int k = threadIdx.x; k < jn; k += SCAN_THREADS)
        ins_span[k] = __ldg(ins_rank + jf + k);
    if (lp_in_smem)
      for (int k = threadIdx.x; k < pn; k += SCAN_THREADS)
        lp_span[k] = __ldg(live_prefix + pf + k);
    __syncthreads();
    for (int lane = (int)l0 + threadIdx.x; lane < v1; lane += SCAN_THREADS) {
      int t = wadd(r0, lane);
      int j = jf + (ins_in_smem ? span_lower_bound(ins_span, t, jn)
                                : span_lower_bound(ins_rank + jf, t, jn));
      int u = wadd(wsub(t, j), 1);
      int p = pf - 1 + (lp_in_smem ? span_lower_bound(lp_span, u, pn)
                                   : span_lower_bound(live_prefix + pf, u, pn));
      emit(true, p, j, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    }
  }
  for (int lane = v1 + threadIdx.x; lane < l1; lane += SCAN_THREADS)
    emit(false, 0, 0, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
         out_live);
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
    const int* ins_rank, int ni, int lanes, int tile, int icap, int pcap,
    float* out_k, int* out_v, int* out_live, void* stream) {
  dim3 grid((unsigned)(((long long)lanes + tile - 1) / tile));
  int smem = (icap + pcap) * (int)sizeof(int);
  rmi_scan_range_kernel<<<grid, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      bounds, base, bvals, live_prefix, n, ins, ivals, ins_rank, ni, lanes,
      tile, icap, pcap, out_k, out_v, out_live);
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
