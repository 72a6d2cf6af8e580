// Causal or full GQA attention with an online softmax, for sm_90a.
//
// Replaces the reference's TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:83, body `_flash_kernel`): the
// same function, not its block structure.  q (B, Hq, S, D), k and v
// (B, Hkv, S, D), all contiguous, float32 or bfloat16; query head h
// reads KV head h / (Hq / Hkv) directly (no repeat).  Scores are
// s = (q . k) * scale in float32, masked with -1e30 (never -inf, so no
// row turns into NaN); tiles strictly above the diagonal are skipped;
// the output is acc / max(l, 1e-30) stored in q's dtype.
//
// Design.  One block per (64-row query tile, query head, batch row),
// 512 threads: eight lanes per query row split D (lane t holds the
// float4s t, t + 8, ... of its row of q and of the accumulator, so D/8
// floats each) and sum a dot product with three __shfl_xor_sync steps.
// The row's running max m, sum l and accumulator stay in registers.  The
// K and V tiles (64 keys) are staged in shared memory as float32,
// converted from bf16 on load, 2 x 64 x D x 4 bytes (64 KB at D = 128,
// dynamic shared memory); the tile's scores, then its probabilities,
// sit in a 64 x 65 float32 array (each lane exponentiates 8 of a row's
// 64 scores).  All four rows of a warp read the same K/V float4 at the
// same time, a broadcast, so the tile reads have no bank conflicts.
// Ragged tails on both axes are masked in the kernel: any S works.
//
// What bounds it.  The causal prefill at B = 2, Hq = 32, S = 4096,
// D = 128 does 0.27 TFLOP against 151 MB moved, far above the card's
// ~295 operations per byte, so the bound is the tensor cores' bf16 rate.
// This kernel multiplies in float32 on the CUDA cores from shared
// memory (one shared load per four FMAs), so it sits far above that
// bound; tensor cores (mma.sync / wgmma) and TMA loads of the K/V tiles
// are a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per staged tile
constexpr int LANES = 8;     // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr int SROW = BK + 1; // padded row of the score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float lane_sum(float x) {
  // xor offsets below LANES stay inside a row's eight lanes
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int D4 = D / 4;         // float4s in a row
  constexpr int NV = D4 / LANES;    // float4s a lane holds
  extern __shared__ float4 smem[];
  float4* Ks = smem;                 // BK x D4
  float4* Vs = Ks + BK * D4;         // BK x D4
  float* Ss = reinterpret_cast<float*>(Vs + BK * D4);  // BQ x SROW

  const int tid = threadIdx.x;
  const int r = tid / LANES;
  const int t = tid % LANES;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = qt * BQ + r;
  const int group = Hq / Hkv;
  const size_t qbase = ((size_t)b * Hq + h) * (size_t)S * D;
  const size_t kvbase = ((size_t)b * Hkv + h / group) * (size_t)S * D;

  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = qpos < S ? load4(q + qbase + (size_t)qpos * D + 4 * (t + LANES * i))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF;
  float l = 0.f;

  const int last_tile = (S - 1) / BK;
  // causal: stop at the diagonal tile (BQ == BK), as the reference skips
  // the tiles strictly above it
  const int ntiles = (causal ? min(qt, last_tile) : last_tile) + 1;
  float* srow = Ss + r * SROW;

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int row = idx / D4;
      const int c = idx % D4;
      const int kp = kt * BK + row;
      if (kp < S) {
        const size_t off = kvbase + (size_t)kp * D + 4 * c;
        Ks[idx] = load4(k + off);
        Vs[idx] = load4(v + off);
      } else {
        Ks[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
        Vs[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();

    // scores of this tile: s = (q . k) * scale, masked
    float tmax = NEG_INF;
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = Ks[j * D4 + t + LANES * i];
        part += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z + qr[i].w * kk.w;
      }
      float s = lane_sum(part) * scale;
      const int kp = kt * BK + j;
      if (kp >= S || (causal && kp > qpos)) s = NEG_INF;
      tmax = fmaxf(tmax, s);
      if ((j % LANES) == t) srow[j] = s;
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    __syncwarp();
    // probabilities: each lane exponentiates every eighth score
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / LANES; ++jj) {
      const int j = jj * LANES + t;
      const float p = expf(srow[j] - m_new);
      srow[j] = p;
      psum += p;
    }
    l = l * alpha + lane_sum(psum);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      const float p = srow[j];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = Vs[j * D4 + t + LANES * i];
        acc[i].x += p * vv.x; acc[i].y += p * vv.y;
        acc[i].z += p * vv.z; acc[i].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qpos < S) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 a = acc[i];
      store4(o + qbase + (size_t)qpos * D + 4 * (t + LANES * i),
             make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int S, float scale, int causal, cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(float) + BQ * SROW * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq,
             int Hkv, int S, int D, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Hq, int Hkv, int S, int D,
                                      int dtype, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Hq, Hkv, S, D, scale, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
