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
// A block resolves one tile of stream slots of one shard (the shard on
// blockIdx.y).  Shard s owns the slots own_lo <= t < own_hi and
// resolves them at shard-local rank ls0 + t - own_lo (int32, wrapping
// like the reference) through its own slab row, as the range kernel
// does; other slots come back (+inf, 0, dead).  The caller reduces
// min/sum/max over the shards.
//
// rmi_scan_page_kernel replaces
//   rmi_scan_page_pallas  (src/repro/kernels/rmi_lookup.py:336,
//                          body _scan_page_kernel at :301 and
//                          _scan_page_body at :219)
// It takes explicit page start ranks.  The reference resolves each lane
// by nested searches over the tombstoned base positions: a partition of
// isteps trips, each a base lower bound and a del_pos lower bound, then
// a select of steps trips, each a del_pos lower bound.  Both searches
// are lower bounds in arrays that are non-decreasing, so this kernel
// reads them from two arrays that a pre-pass (rmi_scan_page_prepass)
// writes once per call:
//   rank_of_ins[m] = m + bl - lb(del_pos, bl), bl = lb(base, ins[m])
//     (the partition's predicate is rank_of_ins[mid] >= t, so its j is
//     lb(rank_of_ins, t); pad slots see ins = +inf, as in the
//     reference);
//   gap[m] = del_pos[m] - m for a tombstone (< n), INT_MAX for a pad
//     (the u-th live base position, u = t - j + 1, is
//     u - 1 + lb(gap, u), clamped to [0, n] exactly where the
//     reference's select saturates).
// del_pos must hold distinct sorted positions below n, then pads of n,
// as `device_scan_plan` builds it.
//
// What bounds these kernels on this card: the bytes of the rows in range
// (base key, value and index entry read, three outputs written), once
// the chain of dependent searches that places the first row is paid.
// Lane by lane, that chain is msteps + psteps (about 48 at 195M keys)
// dependent gathers for the range and sharded kernels, and about 1,650
// for the reference's nested page searches.  The design pays it once a
// tile, one tile a block: a warp-cooperative 33-ary search (one gather
// a lane, a ballot, about 6 rounds over 195M entries) places the
// tile's least and greatest rank t at (j, k) in the two index arrays.
// Lower bounds in a non-decreasing array are monotone, so every rank
// of the tile has its j in [j_least, j_greatest] and its k in
// [k_least, k_greatest].  Those spans are loaded into shared memory
// with coalesced loads (place_spans), each lane finishes its searches
// there (finish_rank) and emits its rows coalesced.  A span longer than
// its buffer (a tombstone-dense tile, an insert-dense one, pages whose
// starts lie far apart) is searched in device memory, narrowed to the
// span.  The index arrays (ins_rank and live_prefix, rank_of_ins and
// gap) must be non-decreasing, as `device_scan_slab` builds the first
// two and the pre-pass the other two.
//   Range kernel: a tile is 2,048 consecutive ranks.  Sharded kernel:
// a tile is 2,048 consecutive stream slots of one shard; a tile that
// owns no slot writes dead rows and searches nothing, and a tile whose
// owned local ranks (or t - j + 1) would wrap int32, which only
// adversarial owners reach, chains its searches lane by lane
// (rows_from_index).  Page kernel: a tile is the whole pages that hold
// about 2,048 lanes (one page when a page holds more), its span placed
// from the least and greatest valid rank of those pages.  A persistent
// grid (blocks looping over tiles) measured the same for the range
// kernel and is not used.
//
// Every gather index is clipped exactly where the reference clips it: a
// load out of bounds is not clamped on the card.  int32 sums that can
// pass 2**31 (page starts, ranks plus offsets) wrap, as the reference's
// int32 arithmetic and the plain PyTorch twin do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

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

// Where the ranks of one tile search two non-decreasing index arrays:
// j = lb(A, t) lies in [jf, jf + jn], k = lb(B, t - j + 1) in
// [kf, kf + kn]; a span that fits its buffer is staged there.
struct Spans {
  int jf, jn, kf, kn;
  bool a_staged, b_staged;
};

// Every thread of the block calls it, with the least and greatest rank
// ta <= tb of the tile (t - j + 1 must not wrap int32 for a rank in
// [ta, tb]).  Warps 0 and 1 place the two ends, all threads stage.
__device__ __forceinline__ Spans place_spans(const int* __restrict__ A, int na,
                                             const int* __restrict__ B, int nb,
                                             int ta, int tb, int* a_buf,
                                             int acap, int* b_buf, int bcap) {
  __shared__ int edge[4];   // jf, j of tb, kf, k of tb's end
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  if (warp < 2) {
    int j = warp_lower_bound(A, warp ? tb : ta, 0, na);
    if (wl == 0) edge[warp] = j;
  }
  __syncthreads();
  if (warp < 2) {
    int u = warp ? wadd(wsub(tb, edge[0]), 1) : wadd(wsub(ta, edge[1]), 1);
    int k = warp_lower_bound(B, u, 0, nb);
    if (wl == 0) edge[2 + warp] = k;
  }
  __syncthreads();
  Spans s;
  s.jf = edge[0];
  s.jn = edge[1] - edge[0];
  s.kf = edge[2];
  s.kn = edge[3] - edge[2];
  s.a_staged = s.jn <= acap;
  s.b_staged = s.kn <= bcap;
  if (s.a_staged)
    for (int i = threadIdx.x; i < s.jn; i += blockDim.x)
      a_buf[i] = __ldg(A + s.jf + i);
  if (s.b_staged)
    for (int i = threadIdx.x; i < s.kn; i += blockDim.x)
      b_buf[i] = __ldg(B + s.kf + i);
  __syncthreads();
  return s;
}

// One rank t of the tile: j = lb(A, t), u = t - j + 1, k = lb(B, u),
// searched inside the spans (staged, or in device memory).
__device__ __forceinline__ void finish_rank(const Spans& s,
                                            const int* __restrict__ A,
                                            const int* __restrict__ B,
                                            const int* a_buf, const int* b_buf,
                                            int t, int& j, int& u, int& k) {
  j = s.jf + (s.a_staged ? span_lower_bound(a_buf, t, s.jn)
                         : span_lower_bound(A + s.jf, t, s.jn));
  u = wadd(wsub(t, j), 1);
  k = s.kf + (s.b_staged ? span_lower_bound(b_buf, u, s.kn)
                         : span_lower_bound(B + s.kf, u, s.kn));
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
  __shared__ int part[4];   // lb(base, b0), lb(ins, b0), lb(base, b1), lb(ins, b1)
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
    const Spans sp = place_spans(ins_rank, ni, live_prefix, n + 1,
                                 wadd(r0, (int)l0), wadd(r0, v1 - 1), span_buf,
                                 icap, span_buf + icap, pcap);
    for (int lane = (int)l0 + threadIdx.x; lane < v1; lane += SCAN_THREADS) {
      int j, u, k;
      finish_rank(sp, ins_rank, live_prefix, span_buf, span_buf + icap,
                  wadd(r0, lane), j, u, k);
      emit(true, k - 1, j, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    }
  }
  for (int lane = v1 + threadIdx.x; lane < l1; lane += SCAN_THREADS)
    emit(false, 0, 0, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
         out_live);
}

// Slabs (S, n), (S, n + 1) and (S, ni) row-major; outputs (S, lanes).
// Block (b, s) resolves stream slots [b * tile, (b + 1) * tile) of shard s.
__global__ void __launch_bounds__(SCAN_THREADS)
rmi_sharded_scan_kernel(const float* __restrict__ base,
                        const int* __restrict__ bvals,
                        const int* __restrict__ live_prefix, int n,
                        const float* __restrict__ ins,
                        const int* __restrict__ ivals,
                        const int* __restrict__ ins_rank, int ni,
                        const int* __restrict__ ls0,
                        const int* __restrict__ own_lo,
                        const int* __restrict__ own_hi, int lanes, int tile,
                        int icap, int pcap, int psteps, int msteps,
                        float* __restrict__ out_k, int* __restrict__ out_v,
                        int* __restrict__ out_live) {
  extern __shared__ int span_buf[];
  const long long s = blockIdx.y;
  base += s * n;
  bvals += s * n;
  live_prefix += s * (n + 1);
  ins += s * ni;
  ivals += s * ni;
  ins_rank += s * ni;
  out_k += s * lanes;
  out_v += s * lanes;
  out_live += s * lanes;
  const int lo = __ldg(own_lo + s), hi = __ldg(own_hi + s), r = __ldg(ls0 + s);
  const int l0 = blockIdx.x * tile;
  const int l1 = (int)min((long long)lanes, (long long)l0 + tile);
  // owned slots [oa, ob) of the tile, at local ranks ta + (lane - oa)
  const int oa = max(l0, lo), ob = min(l1, hi);
  const int ta = (int)((unsigned)r + (unsigned)oa - (unsigned)lo);
  const long long tb = (long long)ta + (ob - 1 - oa);
  if (oa < ob && (ta < INT_MIN + ni - 1 || tb > INT_MAX - 1)) {
    // local ranks (or t - j + 1) wrap int32 inside the tile: chain lane by lane
    for (int lane = l0 + threadIdx.x; lane < l1; lane += SCAN_THREADS)
      rows_from_index((int)((unsigned)r + (unsigned)lane - (unsigned)lo),
                      lane >= lo && lane < hi, base, bvals, live_prefix, n,
                      ins, ivals, ins_rank, ni, psteps, msteps, lane, out_k,
                      out_v, out_live);
    return;
  }
  if (oa < ob) {
    const Spans sp = place_spans(ins_rank, ni, live_prefix, n + 1, ta, (int)tb,
                                 span_buf, icap, span_buf + icap, pcap);
    for (int lane = oa + threadIdx.x; lane < ob; lane += SCAN_THREADS) {
      int j, u, k;
      finish_rank(sp, ins_rank, live_prefix, span_buf, span_buf + icap,
                  ta + (lane - oa), j, u, k);
      emit(true, k - 1, j, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    }
  }
  // slots this shard does not own (the whole tile when it owns none)
  for (int lane = l0 + threadIdx.x; lane < l1; lane += SCAN_THREADS)
    if (lane < oa || lane >= ob)
      emit(false, 0, 0, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
}

// One thread per insert slot and per del_pos slot: the page kernel's two
// index arrays (see the head comment).
__global__ void __launch_bounds__(SCAN_THREADS)
rmi_scan_page_prepass(const float* __restrict__ base, int n,
                      const float* __restrict__ ins, int ni,
                      const int* __restrict__ del_pos, int nd, int steps,
                      int dsteps, int* __restrict__ rank_of_ins,
                      int* __restrict__ gap) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < ni) {
    int bl = lower_bound(base, __ldg(ins + m), n, steps);
    int dl = lower_bound(del_pos, bl, nd, dsteps);
    rank_of_ins[m] = wadd(m, bl - dl);
  }
  if (m < nd) {
    int d = __ldg(del_pos + m);
    gap[m] = d < n ? d - m : INT_MAX;
  }
}

// Block b resolves pages [b * ppt, (b + 1) * ppt): their lanes' ranks
// t = starts[g] + lane, valid in [0, end_rank), through rank_of_ins
// (`icap` entries of shared memory) and gap (`dcap`).
__global__ void __launch_bounds__(SCAN_THREADS)
rmi_scan_page_kernel(const int* __restrict__ starts, int pages, int page_size,
                     int ppt, const float* __restrict__ base,
                     const int* __restrict__ bvals, int n,
                     const float* __restrict__ ins,
                     const int* __restrict__ ivals, int ni,
                     const int* __restrict__ rank_of_ins,
                     const int* __restrict__ gap, int nd,
                     const int* __restrict__ end_rank, int icap, int dcap,
                     float* __restrict__ out_k, int* __restrict__ out_v,
                     int* __restrict__ out_live) {
  extern __shared__ int span_buf[];
  __shared__ int least, greatest;
  const int end = __ldg(end_rank);
  const long long g0 = (long long)blockIdx.x * ppt;
  const long long g1 = min((long long)pages, g0 + ppt);
  if (threadIdx.x == 0) {
    least = INT_MAX;
    greatest = INT_MIN;
  }
  __syncthreads();
  // a page's valid lanes are one run: 0 <= start + lane < end
  int ta = INT_MAX, tb = INT_MIN;
  for (long long g = g0 + threadIdx.x; g < g1; g += SCAN_THREADS) {
    const long long st = __ldg(starts + g);
    const long long va = max(0LL, -st), vb = min((long long)page_size, end - st);
    if (va < vb) {
      ta = min(ta, (int)(st + va));
      tb = max(tb, (int)(st + vb - 1));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    ta = min(ta, __shfl_xor_sync(FULL_MASK, ta, o));
    tb = max(tb, __shfl_xor_sync(FULL_MASK, tb, o));
  }
  if ((threadIdx.x & 31) == 0 && ta <= tb) {
    atomicMin(&least, ta);
    atomicMax(&greatest, tb);
  }
  __syncthreads();
  ta = least;
  tb = greatest;
  // the wrapper keeps pages * page_size inside int32
  const int l0 = (int)g0 * page_size, l1 = (int)g1 * page_size;
  if (ta > tb) {   // no valid lane in the tile
    for (int lane = l0 + threadIdx.x; lane < l1; lane += SCAN_THREADS)
      emit(false, 0, 0, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    return;
  }
  const Spans sp = place_spans(rank_of_ins, ni, gap, nd, ta, tb, span_buf,
                               icap, span_buf + icap, dcap);
  for (int lane = l0 + threadIdx.x; lane < l1; lane += SCAN_THREADS) {
    const int g = lane / page_size;
    const int t = wadd(__ldg(starts + g), lane - g * page_size);
    if (t >= 0 && t < end) {
      int j, u, k;
      finish_rank(sp, rank_of_ins, gap, span_buf, span_buf + icap, t, j, u, k);
      const long long p = min(max((long long)u - 1 + k, 0LL), (long long)n);
      emit(true, (int)p, j, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    } else {
      emit(false, 0, 0, base, bvals, n, ins, ivals, ni, lane, out_k, out_v,
           out_live);
    }
  }
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

// scratch: ni + nd ints (rank_of_ins, then gap)
extern "C" int rmi_scan_page_launch(
    const int* starts, int pages, int page_size, int ppt, const float* base,
    const int* bvals, int n, const float* ins, const int* ivals, int ni,
    const int* del_pos, int nd, const int* end_rank, int steps, int dsteps,
    int icap, int dcap, int* scratch, float* out_k, int* out_v,
    int* out_live, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* rank_of_ins = scratch;
  int* gap = scratch + ni;
  int slots = max(ni, nd);
  rmi_scan_page_prepass<<<(slots + SCAN_THREADS - 1) / SCAN_THREADS,
                          SCAN_THREADS, 0, st>>>(
      base, n, ins, ni, del_pos, nd, steps, dsteps, rank_of_ins, gap);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((unsigned)(((long long)pages + ppt - 1) / ppt));
  int smem = (icap + dcap) * (int)sizeof(int);
  rmi_scan_page_kernel<<<grid, SCAN_THREADS, smem, st>>>(
      starts, pages, page_size, ppt, base, bvals, n, ins, ivals, ni,
      rank_of_ins, gap, nd, end_rank, icap, dcap, out_k, out_v, out_live);
  return (int)cudaGetLastError();
}

extern "C" int rmi_sharded_scan_launch(
    const float* base, const int* bvals, const int* live_prefix, int S, int n,
    const float* ins, const int* ivals, const int* ins_rank, int ni,
    const int* ls0, const int* own_lo, const int* own_hi, int lanes, int tile,
    int icap, int pcap, int psteps, int msteps, float* out_k, int* out_v,
    int* out_live, void* stream) {
  dim3 grid((unsigned)(((long long)lanes + tile - 1) / tile), S);
  int smem = (icap + pcap) * (int)sizeof(int);
  rmi_sharded_scan_kernel<<<grid, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      base, bvals, live_prefix, n, ins, ivals, ins_rank, ni, ls0, own_lo,
      own_hi, lanes, tile, icap, pcap, psteps, msteps, out_k, out_v,
      out_live);
  return (int)cudaGetLastError();
}
