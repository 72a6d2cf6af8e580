// The paper's §4 and §5 point probes for Hopper (sm_90a), one thread per
// query each.
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
// f32(M/n) and f32(S/n) are computed on the host.  Float-to-int casts
// clamp in float first and every gather index is clipped, so a NaN or
// infinite query gathers in bounds and finds nothing.  The reference
// walks a fixed `trips` = max_chain - 1 steps; this walk stops at the
// chain's end (next < 0) or at a hit, which gives the same answer.
//
// bloom_probe_kernel replaces
//   bloom_probe_pallas (src/repro/kernels/bloom_probe.py:45, body _bloom_kernel)
// h1 = mix32(q, 1), h2 = mix32(q, 2) | 1, and for i < k the bit
// ((h1 + i*h2) mod 2**32) mod num_bits must be set: uint32 arithmetic,
// which wraps as the TPU's does.  The words arrive as the uint32 bit
// patterns of an int32 tensor.  The probe stops at the first clear bit,
// which gives the same answer as testing all k.
//
// What bounds them on this card: random 4-byte gathers from device
// memory, each touching one 32-byte sector.  A hash query reads its key
// (coalesced), two leaf parameters and a slot's key and next pointer
// (four sectors, two pairs at one index each) and two sectors per
// overflow node it walks; a Bloom query reads its key and one sector
// per probe until the first clear bit (k for a stored key).  The
// gathers of one query depend on each other only along the hash chain,
// so the time is a few memory latencies per thread; one query per
// thread and many resident warps (no shared memory, few registers) keep
// many in flight.  Left for later: interleaving the slot key and next
// pointer (and the two leaf parameters) so each pair is one sector,
// a blocked Bloom layout that puts all k probes of a key in one sector,
// and several queries per thread.

#include <cuda_runtime.h>
#include <stdint.h>

#define INDEX_CLAMP 1073741824.0f  // 2**30: every slot and leaf fits

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  x = x > lo ? x : lo;  // NaN -> lo, like the plain version's select
  return x < hi ? x : hi;
}

__device__ __forceinline__ int to_index(float x) {
  return (int)clampf(x, 0.0f, INDEX_CLAMP);  // truncation toward zero
}

__global__ void __launch_bounds__(256)
hash_probe_kernel(const float* __restrict__ q, int B,
                  const float* __restrict__ s0,
                  const float* __restrict__ leaf_w,
                  const float* __restrict__ leaf_b, int M, float leaf_ratio,
                  float nm1f, const float* __restrict__ slot_key,
                  const int* __restrict__ slot_next, int S, float slot_ratio,
                  const float* __restrict__ ovf_key,
                  const int* __restrict__ ovf_next, int O, int trips,
                  bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float qq = q[i];
  float p0 = __fadd_rn(__fmul_rn(qq, __ldg(s0)), __ldg(s0 + 1));
  int leaf = min(to_index(floorf(__fmul_rn(p0, leaf_ratio))), M - 1);
  float pos = __fadd_rn(__fmul_rn(__ldg(leaf_w + leaf), qq), __ldg(leaf_b + leaf));
  pos = clampf(pos, 0.0f, nm1f);
  int slot = min(to_index(__fmul_rn(pos, slot_ratio)), S - 1);
  bool found = __ldg(slot_key + slot) == qq;
  int nxt = __ldg(slot_next + slot);
  for (int t = 0; t < trips && !found && nxt >= 0; ++t) {
    int safe = min(nxt, O - 1);
    found = __ldg(ovf_key + safe) == qq;
    nxt = __ldg(ovf_next + safe);
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

__global__ void __launch_bounds__(256)
bloom_probe_kernel(const uint32_t* __restrict__ q, int B,
                   const uint32_t* __restrict__ words, uint32_t num_bits,
                   int k, bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t h = q[i];
  uint32_t h1 = mix32(h, 0x9E3779B9u);        // seed 1
  uint32_t h2 = mix32(h, 0x3C6EF372u) | 1u;   // seed 2: 2 * 0x9E3779B9 mod 2**32
  bool hit = true;
  for (int j = 0; j < k && hit; ++j) {
    uint32_t bit = (h1 + (uint32_t)j * h2) % num_bits;
    hit = (__ldg(words + (bit >> 5)) >> (bit & 31u)) & 1u;
  }
  out[i] = hit;
}

extern "C" int hash_probe_launch(
    const float* q, int B, const float* s0, const float* leaf_w,
    const float* leaf_b, int M, float leaf_ratio, float nm1f,
    const float* slot_key, const int* slot_next, int S, float slot_ratio,
    const float* ovf_key, const int* ovf_next, int O, int trips, bool* out,
    void* stream) {
  const int threads = 256;
  hash_probe_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      q, B, s0, leaf_w, leaf_b, M, leaf_ratio, nm1f, slot_key, slot_next, S,
      slot_ratio, ovf_key, ovf_next, O, trips, out);
  return (int)cudaGetLastError();
}

extern "C" int bloom_probe_launch(const uint32_t* q, int B,
                                  const uint32_t* words, uint32_t num_bits,
                                  int k, bool* out, void* stream) {
  const int threads = 256;
  bloom_probe_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(q, B, words, num_bits, k, out);
  return (int)cudaGetLastError();
}
