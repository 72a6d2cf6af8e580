// The paper's §4 and §5 point probes for Hopper (sm_90a): one thread a
// hash query, four Bloom queries a thread.
//
// hash_probe_kernel replaces the reference's Pallas kernel
//   hash_probe_pallas  (src/repro/kernels/hash_probe.py:51, body _hash_kernel)
// The §4 model hash: linear stage-0 -> leaf select -> leaf position
// clamped to [0, f32(n - 1)] -> slot = int(pos * f32(S/n)) clamped to
// [0, S - 1] -> primary slot compare -> walk of the overflow chain.
// Every multiply-add is a separately rounded __fmul_rn then __fadd_rn
// (and the file is built with -fmad=false), the arithmetic of the
// port's build (core/learned_hash.model_slots through
// core/rmi.leaf_and_pos), so build-time and probe-time slots agree;
// f32(M/n) and f32(S/n) are computed on the host.  A +inf query takes
// the position f32(n - 1) whatever the leaf's slope, as in
// leaf_and_pos (0 * inf on a leaf of slope 0 is NaN: ROADMAP queue C
// 17); it never equals a stored key, so no answer depends on it.
// Float-to-int casts clamp in float first and every gather index is
// clipped, so a NaN or infinite query gathers in bounds and finds
// nothing.  The reference
// walks a fixed `trips` = max_chain - 1 steps; this walk stops at the
// chain's end (next < 0) or at a hit, which gives the same answer.
//
// bloom_probe_kernel replaces
//   bloom_probe_pallas (src/repro/kernels/bloom_probe.py:45, body _bloom_kernel)
// h1 = mix32(q, 1), h2 = mix32(q, 2) | 1, and for i < k the bit
// ((h1 + i*h2) mod 2**32) mod num_bits must be set: uint32 arithmetic,
// which wraps as the TPU's does.  The words arrive as the uint32 bit
// patterns of an int32 tensor.  A query stops at its first clear bit,
// which gives the same answer as testing all k.
//
// What bounds them on this card: random gathers from device memory,
// each moving one 32-byte sector for a few useful bytes.  A hash query
// reads its key (coalesced), its leaf's (w, b), its slot's key and next
// pointer, and each overflow node's key and next pointer along its
// chain; a Bloom query reads its key and one sector per probe until the
// first clear bit (k for a hit).  The gathers of one hash query depend
// on each other (leaf -> slot -> first node -> next node), so a thread
// holds one in flight; one query a thread and many resident warps (no
// shared memory, few registers) keep many in flight.  The Bloom probe
// takes four queries a thread and issues the next probe of every live
// one before testing any, so a thread holds up to four gathers in
// flight and a warp reads its keys and writes its answers as whole
// lines.  Measured on the card, neither helps much: at 1<<20 queries on
// a 233.5 MB filter the kernel runs at the card's rate for independent
// random sectors (a bare gather of two random words a thread takes
// within 5% of its time), which is about a third of the memory's rate
// in bytes.  Two probes a step, eight queries a thread, loads that skip
// L1 and a fastmod in place of `%` measured level or slower (PERF.md
// §6).  Only a layout that puts a key's k bits in one sector would
// move it, and that changes the filter's function (ROADMAP queue C 11).
//
// The hash probe reads every pair it needs by one 8-byte load: the leaf
// as a (w, b) record, and the slot and each overflow node as a (key
// bits, next) int32 record, the key column viewed as float32
// (`ops.hash_probe_tensors` packs them on the card; the wrapper packs
// separate arrays per call).  Each pair then costs one sector where two
// arrays cost two.  `build_hashmap` lays each slot's overflow nodes out
// contiguously in chain order, so after the first node the walk mostly
// reads lines already fetched; it still follows `next` for any map.
// Loading the record after the current node with it (the next node of a
// contiguous chain) was measured on the card and did not pay.

#include <cuda_runtime.h>
#include <stdint.h>

#define INDEX_CLAMP 1073741824.0f  // 2**30: every slot and leaf fits
#define POS_INF __int_as_float(0x7f800000)

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x > lo ? x : lo;  // NaN -> lo, like the plain version's select
  return x < hi ? x : hi;
}

__device__ __forceinline__ int to_index(float x) {
  return (int)clampf(x, 0.0f, INDEX_CLAMP);  // truncation toward zero
}

// One query a thread.  A leaf record is float2 (w, b); slot and
// overflow records are int2 (key bits, next).
__global__ void __launch_bounds__(256)
hash_probe_kernel(const float* __restrict__ q, int B,
                  const float* __restrict__ s0,
                  const float2* __restrict__ leaves, int M, float leaf_ratio,
                  float nm1f, const int2* __restrict__ slots,
                  int S, float slot_ratio, const int2* __restrict__ ovf, int O,
                  int trips, bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float qq = q[i];
  float p0 = __fadd_rn(__fmul_rn(qq, __ldg(s0)), __ldg(s0 + 1));
  int leaf = min(to_index(floorf(__fmul_rn(p0, leaf_ratio))), M - 1);
  float2 lf = __ldg(leaves + leaf);
  float pos = __fadd_rn(__fmul_rn(lf.x, qq), lf.y);
  pos = clampf(qq == POS_INF ? nm1f : pos, 0.0f, nm1f);
  int slot = min(to_index(__fmul_rn(pos, slot_ratio)), S - 1);
  int2 rec = __ldg(slots + slot);
  bool found = __int_as_float(rec.x) == qq;
  int nxt = rec.y;
  for (int t = 0; t < trips && !found && nxt >= 0; ++t) {
    rec = __ldg(ovf + min(nxt, O - 1));
    found = __int_as_float(rec.x) == qq;
    nxt = rec.y;
  }
  out[i] = found;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t seed_const) {
  h ^= seed_const;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

constexpr int BLOOM_Q = 4;  // queries a thread: one uint4 of keys, one uchar4 of answers
static_assert(BLOOM_Q == 4, "keys arrive as one uint4, answers leave as one uchar4");

// BLOOM_Q queries a thread: keys by one 16-byte load and answers by one
// 4-byte store when the thread's queries are whole and both tensors
// aligned (`vec`), else one by one (the ragged tail, a view).  Each
// step issues the next probe of every live query before testing any,
// and the thread stops once none is live.
__global__ void __launch_bounds__(256)
bloom_probe_kernel(const uint32_t* __restrict__ q, int B,
                   const uint32_t* __restrict__ words, uint32_t num_bits,
                   int k, bool vec, bool* __restrict__ out) {
  long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * BLOOM_Q;
  if (first >= B) return;
  int m = (int)min((long long)BLOOM_Q, B - first);
  bool whole = vec && m == BLOOM_Q;
  uint32_t h[BLOOM_Q], h2[BLOOM_Q];
  bool hit[BLOOM_Q];
  uint4 v = whole ? __ldg(reinterpret_cast<const uint4*>(q + first)) : make_uint4(0, 0, 0, 0);
  uint32_t key[BLOOM_Q] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < BLOOM_Q; ++j) {
    if (!whole && j < m) key[j] = q[first + j];
    h[j] = mix32(key[j], 0x9E3779B9u);          // seed 1
    h2[j] = mix32(key[j], 0x3C6EF372u) | 1u;    // seed 2: 2 * 0x9E3779B9 mod 2**32
    hit[j] = j < m;                             // lanes past the batch: dead
  }
  for (int i = 0; i < k; ++i) {
    uint32_t bit[BLOOM_Q], w[BLOOM_Q];
#pragma unroll
    for (int j = 0; j < BLOOM_Q; ++j) {
      bit[j] = h[j] % num_bits;
      w[j] = hit[j] ? __ldg(words + (bit[j] >> 5)) : 0u;
    }
    bool live = false;
#pragma unroll
    for (int j = 0; j < BLOOM_Q; ++j) {
      hit[j] = hit[j] && ((w[j] >> (bit[j] & 31u)) & 1u);
      h[j] += h2[j];                            // h1 + (i + 1) * h2, mod 2**32
      live |= hit[j];
    }
    if (!live) break;
  }
  if (whole) {
    *reinterpret_cast<uchar4*>(out + first) = make_uchar4(hit[0], hit[1], hit[2], hit[3]);
  } else {
#pragma unroll
    for (int j = 0; j < BLOOM_Q; ++j) {
      if (j < m) out[first + j] = hit[j];
    }
  }
}

extern "C" int hash_probe_launch(
    const float* q, int B, const float* s0, const float* leaves, int M,
    float leaf_ratio, float nm1f, const int* slots, int S, float slot_ratio,
    const int* ovf, int O, int trips, bool* out, void* stream) {
  const int threads = 256;
  hash_probe_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      q, B, s0, (const float2*)leaves, M, leaf_ratio, nm1f,
      (const int2*)slots, S, slot_ratio, (const int2*)ovf, O, trips, out);
  return (int)cudaGetLastError();
}

extern "C" int bloom_probe_launch(const uint32_t* q, int B,
                                  const uint32_t* words, uint32_t num_bits,
                                  int k, bool* out, void* stream) {
  const int threads = 256;
  long long per_block = (long long)threads * BLOOM_Q;
  int blocks = (int)((B + per_block - 1) / per_block);
  bool vec = (uintptr_t)q % 16 == 0 && (uintptr_t)out % 4 == 0;
  bloom_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      q, B, words, num_bits, k, vec, out);
  return (int)cudaGetLastError();
}
