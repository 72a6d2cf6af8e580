// Causal or full GQA attention with an online softmax, for sm_90a.
//
// Replaces the reference's TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:83, body `_flash_kernel`): the
// same function, not its block structure.  q (B, Hq, Sq, D), k and v
// (B, Hkv, Sk, D), all contiguous, bfloat16 or float32, D in {32, 64,
// 128}, any Sq, Sk >= 1 (causal needs Sq == Sk: the reference's mask
// counts both from position 0); query head h reads KV head
// h / (Hq / Hkv) directly (no repeat).  Scores are s = (q . k) * scale
// in float32, masked with -1e30 (never -inf, so no row turns into NaN)
// past Sk and, causal, above the diagonal; tiles strictly above the
// diagonal are skipped; the output is acc / max(l, 1e-30) stored in q's
// dtype.  Cross-attention (decoder queries over encoder keys) is the
// full mask with Sq != Sk: the query tiles, the output and the LSE run
// over Sq, the key tiles over Sk.  Given a non-null `lse` (float32,
// (B, Hq, Sq)), each row's
// log-sum-exp m + log(l), in the units of the scaled scores, is stored
// beside it for the backward kernel (flash_attention_bwd.cu); the
// inference path passes null and stores nothing more.
//
// What bounds it.  The causal prefill at B = 2, Hq = 32, S = 4096,
// D = 128 does 0.27 TFLOP against 151 MB moved, far above the card's
// ~295 operations per byte, so the bound is the tensor cores' bf16 rate
// (0.28 ms at 989 TFLOP/s).
//
// bfloat16: the tensor cores (`flash_attention_bf16_kernel`).  One block
// takes 128 query rows of one (batch, query head): two consumer
// warpgroups of 64 rows and one producer warp, 288 threads.  The
// producer's one lane loads the Q tile once and K/V tiles of 64 keys
// into a three-stage ring by TMA, through 3-D tensor maps over
// (D, S, B * H) (S = Sq for Q, Sk for K and V): rows past S arrive as
// zeros, never as the next head's rows (a zero key still scores 0, so
// the mask covers keys >= Sk), and D = 32 arrives as 64 columns whose upper half is zero.  Every
// tile lands with the 128-byte swizzle that `wgmma` reads; full barriers
// count the TMA bytes, empty barriers the eight consumer warps.  These
// pieces (tensor maps, TMA, mbarriers, wgmma wrappers) are in sm90.cuh,
// which the backward kernels share.
//   Each consumer warpgroup computes S = Q K^T with wgmma.mma_async
// m64n64k16 (Q and K from shared memory, float32 accumulators in
// registers), scales and masks it in the accumulator's own layout (the
// -1e30 mask only on the diagonal and ragged tiles), and keeps each
// row's max and sum in registers (a row spans one lane quad: two
// shuffles).  P keeps float32 precision: it is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both go through a
// register-A wgmma m64n{D}k16 into the same float32 accumulator, V read
// MN-major from shared memory (the transpose bit).  The accumulator's
// fragment is the A operand's fragment, so the split needs no shuffles.
// A single bf16 P rounds every probability to 8 bits (2^-9 relative)
// and misses one bf16 rounding of the float32 twin on the output; the
// split leaves ~2^-17.  It costs half again the function's operations
// (the floor of this design is 1.5x the bound, ~0.42 ms at the shape
// above).
//   Keeping the tensor cores fed: tile j's Q K^T and tile j - 1's P V are
// issued together and the softmax of tile j runs while P V finishes; the
// two warpgroups take turns to issue (named barriers 1 and 2), so one's
// softmax overlaps the other's products.  For the turns to pair up, both
// warpgroups step through every tile the block loads: on the diagonal
// the first warpgroup also reads the tile wholly above its rows, which
// adds exactly 0.  Blocks are numbered so that the last query tiles
// (the most keys under the causal mask) start first.  The epilogue
// divides by max(l, 1e-30), rounds to bf16 and stores only rows < Sq.
// ptxas gives the D = 128 instance 168 registers a thread and no spills.
// 128-key tiles or a producer warpgroup that hands its registers over
// (setmaxnreg) did not fit in those registers, and a persistent grid was
// slower (PERF.md §6).
//
// float32: the CUDA cores (`flash_attention_f32_kernel`), as in the first
// port.  The float32 twin is held to 2e-5, which TF32 (10-bit mantissa)
// cannot meet, and float32 has no other tensor-core path.  One block per
// 64-row query tile, 512 threads: eight lanes per query row split D and
// sum a dot product with three shuffles; K and V tiles of 64 keys sit in
// shared memory, the tile's scores in a 64 x 65 array.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per staged tile
constexpr int LANES = 8;     // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr int SROW = BK + 1; // padded row of the score tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float lane_sum(float x) {
  // xor offsets below LANES stay inside a row's eight lanes
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                           float scale, int causal) {
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
  const size_t qbase = ((size_t)b * Hq + h) * (size_t)Sq * D;
  const size_t kvbase = ((size_t)b * Hkv + h / group) * (size_t)Sk * D;

  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = qpos < Sq ? load4(q + qbase + (size_t)qpos * D + 4 * (t + LANES * i))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF;
  float l = 0.f;

  const int last_tile = (Sk - 1) / BK;
  // causal (Sq == Sk): stop at the diagonal tile (BQ == BK), as the
  // reference skips the tiles strictly above it
  const int ntiles = (causal ? min(qt, last_tile) : last_tile) + 1;
  float* srow = Ss + r * SROW;

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int row = idx / D4;
      const int c = idx % D4;
      const int kp = kt * BK + row;
      if (kp < Sk) {
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
      if (kp >= Sk || (causal && kp > qpos)) s = NEG_INF;
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

  if (qpos < Sq) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 a = acc[i];
      store4(o + qbase + (size_t)qpos * D + 4 * (t + LANES * i),
             make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc));
    }
    if (lse != nullptr && t == 0) lse[((size_t)b * Hq + h) * Sq + qpos] = m + logf(lc);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(float) + BQ * SROW * sizeof(float);
  auto kernel = flash_attention_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;                 // query rows per block
constexpr int BK = 64;                  // keys per K/V tile
constexpr int STAGES = 3;               // K/V tiles in flight
constexpr int CONSUMERS = 256;          // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32; // and one producer warp

template <int D>
struct Layout {
  static constexpr int DP = D < CHUNK ? CHUNK : D;  // columns held (D = 32 padded)
  static constexpr int NCH = DP / CHUNK;            // 128-byte column chunks
  static constexpr int Q_CHUNK = BQ * 128;          // bytes of one Q column chunk
  static constexpr int KV_CHUNK = BK * 128;         // bytes of one K or V column chunk
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;   // one K (or V) tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int NBAR = 1 + 3 * STAGES;       // q full; k full, v full, empty per stage
  static constexpr int SMEM = OFF_BAR + 8 * NBAR + 1024;  // + slack to align to 1024
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                            int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                            int causal) {
  using L = Layout<D>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = sbase, sk = sbase + L::OFF_K, sv = sbase + L::OFF_V;
  const uint32_t q_full = sbase + L::OFF_BAR;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  // the last query tiles (most keys under the causal mask) start first
  const int bh = blockIdx.x % (B * Hq);
  const int qt = (Sq + BQ - 1) / BQ - 1 - blockIdx.x / (B * Hq);
  const int b = bh / Hq, h = bh % Hq;
  const int bhkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int ntiles = ((causal ? min(q0 + BQ, Sk) : Sk) + BK - 1) / BK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one lane issues every TMA load ----
    if (lane == 0) {
      bar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < L::NCH; ++c)
        tma_load(sq + c * L::Q_CHUNK, &qmap, q_full, c * CHUNK, q0, bh);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) bar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        bar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < L::NCH; ++c)
          tma_load(sk + s * L::KV_BYTES + c * L::KV_CHUNK, &kmap, k_full + 8 * s,
                   c * CHUNK, kt * BK, bhkv);
        bar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int c = 0; c < L::NCH; ++c)
          tma_load(sv + s * L::KV_BYTES + c * L::KV_CHUNK, &vmap, v_full + 8 * s,
                   c * CHUNK, kt * BK, bhkv);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows row0 .. row0 + 63 ----
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;
  const int rA = row0 + 16 * (warp % 4) + g;   // this thread's two rows
  const int rB = rA + 8;
  const uint32_t sq_wg = sq + wg * 64 * 128;

  float sacc[32];          // scores, then probabilities, of one tile
  float oacc[DP / 2];      // the output accumulator
  uint32_t phi[16], plo[16];  // P's bf16 halves as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF;   // running max of each row (scaled scores)
  float lA = 0.f, lB = 0.f;           // this thread's part of each row's sum
  float alphaA = 1.f, alphaB = 1.f;   // rescale of the accumulator for this tile

  // S = Q K^T of the tile in stage s: D/16 k-steps of 32 bytes along the
  // swizzled rows (one commit group)
  auto issue_qk = [&](int s) {
    const uint32_t skt = sk + s * L::KV_BYTES;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      mma_ss(sacc, desc128(sq_wg + (ks / 4) * L::Q_CHUNK + off, 16, 1024),
             desc128(skt + (ks / 4) * L::KV_CHUNK + off, 16, 1024), (int)(ks > 0));
    }
    wg_commit();
  };
  // O += P_hi V + P_lo V for the tile in stage s: 16 keys a k-step, V
  // MN-major (one commit group)
  auto issue_pv = [&](int s) {
    const uint32_t svt = sv + s * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc128(svt + kk * 16 * 128, L::KV_CHUNK, 1024);
      mma_rs(oacc, phi + 4 * kk, dv);
      mma_rs(oacc, plo + 4 * kk, dv);
    }
    wg_commit();
  };
  // scale and mask tile kt's scores (the mask only on the diagonal and
  // ragged tiles), update the running max and sum, and leave
  // P = exp(s - m) in sacc; alpha rescales the accumulator
  auto softmax = [&](int kt) {
    const int kbase = kt * BK;
    const bool masked = kbase + BK > Sk || (causal && kbase + BK - 1 > row0);
    float xA = mA, xB = mB;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = sacc[4 * j + e] * scale;
        float c = sacc[4 * j + 2 + e] * scale;
        if (masked) {
          const int key = kbase + 8 * j + 2 * t + e;
          if (key >= Sk || (causal && key > rA)) a = NEG_INF;
          if (key >= Sk || (causal && key > rB)) c = NEG_INF;
        }
        sacc[4 * j + e] = a;
        sacc[4 * j + 2 + e] = c;
        xA = fmaxf(xA, a);
        xB = fmaxf(xB, c);
      }
    }
    xA = quad_max(xA);
    xB = quad_max(xB);
    const float nA = xA * LOG2E, nB = xB * LOG2E;
    alphaA = ex2(fmaf(mA, LOG2E, -nA));
    alphaB = ex2(fmaf(mB, LOG2E, -nB));
    mA = xA;
    mB = xB;
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sacc[4 * j] = ex2(fmaf(sacc[4 * j], LOG2E, -nA));
      sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], LOG2E, -nA));
      sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], LOG2E, -nB));
      sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], LOG2E, -nB));
      sA += sacc[4 * j] + sacc[4 * j + 1];
      sB += sacc[4 * j + 2] + sacc[4 * j + 3];
    }
    lA = lA * alphaA + sA;
    lB = lB * alphaB + sB;
  };
  // rescale the accumulator, then split P into bf16 hi + lo A
  // fragments: key columns 16 kk .. 16 kk + 15 are k-step kk, registers
  // {row A, row B} x {columns 2t, 2t + 8}
  auto rescale_and_split = [&]() {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      oacc[4 * j] *= alphaA;
      oacc[4 * j + 1] *= alphaA;
      oacc[4 * j + 2] *= alphaB;
      oacc[4 * j + 3] *= alphaB;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * (j / 2) + 2 * (j % 2);
      split(sacc[4 * j], sacc[4 * j + 1], phi[r], plo[r]);
      split(sacc[4 * j + 2], sacc[4 * j + 3], phi[r + 1], plo[r + 1]);
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * s);
  };

  bar_wait(q_full, 0);
  if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first
  bar_wait(k_full, 0);
  turn_wait(wg);
  keep(sacc);
  wg_fence();
  issue_qk(0);
  turn_pass(wg);
  wg_wait<0>();
  keep(sacc);
  softmax(0);
  rescale_and_split();
  // tile kt's Q K^T and tile kt - 1's P V go out together; the softmax
  // of tile kt runs while the tensor cores finish P V and the other
  // warpgroup's products.  Both warpgroups step through every tile the
  // block loads (a tile wholly above a warpgroup's diagonal adds exactly
  // 0), so their turns stay paired.
  for (int kt = 1; kt < ntiles; ++kt) {
    const int s = kt % STAGES, sp = (kt - 1) % STAGES;
    bar_wait(k_full + 8 * s, (kt / STAGES) & 1);
    bar_wait(v_full + 8 * sp, ((kt - 1) / STAGES) & 1);
    turn_wait(wg);
    keep(sacc);
    keep(oacc);
    wg_fence();
    issue_qk(s);
    issue_pv(sp);
    turn_pass(wg);
    wg_wait<1>();
    keep(sacc);
    softmax(kt);
    wg_wait<0>();
    keep(oacc);
    release(sp);
    rescale_and_split();
  }
  const int sl = (ntiles - 1) % STAGES;
  bar_wait(v_full + 8 * sl, ((ntiles - 1) / STAGES) & 1);
  turn_wait(wg);
  keep(oacc);
  wg_fence();
  issue_pv(sl);
  turn_pass(wg);
  wg_wait<0>();
  keep(oacc);
  release(sl);

  // ---- epilogue: acc / max(l, 1e-30) in bf16, rows < Sq only ----
  const float dA = fmaxf(quad_sum(lA), 1e-30f);
  const float dB = fmaxf(quad_sum(lB), 1e-30f);
  __nv_bfloat16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < D) {
      if (rA < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rA * D + col) =
            __floats2bfloat162_rn(oacc[4 * j] / dA, oacc[4 * j + 1] / dA);
      if (rB < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rB * D + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] / dB, oacc[4 * j + 3] / dB);
    }
  }
  if (lse != nullptr && t == 0) {
    // mA, mB: the rows' maxima, the same in every lane of the quad
    if (rA < Sq) lse[(size_t)bh * Sq + rA] = mA + logf(dA);
    if (rB < Sq) lse[(size_t)bh * Sq + rB] = mB + logf(dB);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
                cudaStream_t stream) {
  using L = Layout<D>;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  if (!encode(fn, &qm, q, D, Sq, (long long)B * Hq, BQ) ||
      !encode(fn, &km, k, D, Sk, (long long)B * Hkv, BK) ||
      !encode(fn, &vm, v, D, Sk, (long long)B * Hkv, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename F>
int by_head_dim(int D, F f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q has
// Sq rows a head, k and v Sk; causal needs Sq == Sk.  `lse` is null, or
// float32 (B, Hq, Sq) for the rows' log-sum-exp.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Hq, int Hkv, int Sq,
                                      int Sk, int D, int dtype, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv != 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return by_head_dim(D, [&](auto d) {
      return launch_f32<decltype(d)::value>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale, causal,
                                            st);
    });
  if (dtype == 1)
    return by_head_dim(D, [&](auto d) {
      return tc::launch_bf16<decltype(d)::value>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, scale,
                                                 causal, st);
    });
  return (int)cudaErrorInvalidValue;
}
