// The gradient of the flash-attention kernel (flash_attention.cu), for
// sm_90a, on the CUDA cores.
//
// Replaces no TPU kernel: the reference has no backward kernel.  It
// takes the gradient of its plain online-softmax loop
// (src/repro/models/attention.py:33, `chunked_attention`) with
// `jax.value_and_grad` (src/repro/train/train_step.py:34); this source
// computes that gradient for the function the forward kernel computes,
// with its conventions: q (B, Hq, S, D), k and v (B, Hkv, S, D), all
// contiguous, bfloat16 or float32, D in {32, 64, 128}, any S >= 1;
// query head h reads KV head h / (Hq / Hkv); scores s = (q . k) * scale
// in float32, scaled after the dot; causal or full; keys past S and,
// under the causal mask, keys past the query are masked (P = 0, as
// exp(-1e30 - lse) is in float32).
//
// From the forward's output o and its row log-sum-exp lse (float32,
// (B, Hq, S), m + log(l) in the units of the scaled scores), with
// P = exp(s - lse):
//   Di = rowsum(dO o O)                        (pre-pass, float32)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di)
//   dQ = dS K * scale,  dK = dS^T Q * scale    (GQA: summed over a group)
// Every input is widened to float32 as it is staged in shared memory and
// every sum is taken in float32; the outputs are rounded once to the
// inputs' type.
//
// Three launches, no atomics, so two launches on the same inputs give
// the same bits:
//   (a) `attention_bwd_prepass`: one warp a row writes Di.
//   (b) `attention_dkdv_kernel`: one block a (batch, KV head, 64-key
//       tile) holds its K and V tiles, loops over the group's query heads
//       and the query tiles on or below the diagonal, recomputes P from
//       Q, K and lse, and accumulates dV and dK in registers; it writes
//       each once.  The first key tiles (the most query tiles under the
//       causal mask) start first.
//   (c) `attention_dq_kernel`: one block a (batch, query head, 64-query
//       tile) holds its Q and dO tiles, loops over the key tiles on or
//       below the diagonal, recomputes P and dS, and accumulates dQ.  The
//       last query tiles start first.
//
// What bounds it.  The gradient does 2.5x the forward's operations (five
// products of the forward's two sizes); at B = 1, Hq = 32, S = 4096,
// D = 128, causal, that is ~343 GFLOP, 0.35 ms at the tensor cores' bf16
// rate of 989 TFLOP/s.  This design recomputes S and dP in both (b) and
// (c) (seven products in all) on the CUDA cores, whose float32 rate is 67
// TFLOP/s: its floor is ~10 ms at that shape.  It is the simple, exact
// design; `wgmma` on the forward's TMA tiles is later work (ROADMAP
// queue A item 9).
//
// Tiles: 64 queries x 64 keys, 256 threads.  A score tile is 16 x 16
// threads of 4 x 4 entries (rows ty + 16a, keys tx + 16c), each a float4
// walk along D over rows padded by 4 floats (conflict-free 16-byte loads).
// The (64, D) accumulators give each thread R rows of NC float4 columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // keys of a tile
constexpr int THREADS = 256;
constexpr int PAD = 4;        // floats of padding after each staged row
constexpr int PROW = BK + 1;  // padded row of the P and dS tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// The thread layout of a (64, D) accumulator: TX threads across D's
// float4 columns, TY across the 64 rows; each thread holds rows
// y + TY r (r < R) and float4 columns x + TX c (c < NC).
template <int D>
struct Acc {
  static constexpr int DC = D / 4;
  static constexpr int TX = DC < 16 ? DC : 16;
  static constexpr int TY = THREADS / TX;
  static constexpr int R = 64 / TY;
  static constexpr int NC = DC / TX;
  static constexpr int LD = D + PAD;  // staged row, floats
};

// rows row0 .. row0 + 63 of a (S, D) slab into dst[64][D + PAD] as
// float32; rows past S are zeros
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int S) {
  constexpr int DC = D / 4;
  for (int idx = threadIdx.x; idx < 64 * DC; idx += THREADS) {
    const int r = idx / DC, c = idx % DC;
    const int row = row0 + r;
    const float4 x = row < S ? load4(src + (size_t)row * D + 4 * c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * Acc<D>::LD + 4 * c, x);
  }
}

// acc[a][c] = A[ty + 16a] . B[tx + 16c] over D, both staged (64, D + PAD)
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = Acc<D>::LD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = load4(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = load4(B + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[a][c];
        s = fmaf(x[a].x, y[c].x, s);
        s = fmaf(x[a].y, y[c].y, s);
        s = fmaf(x[a].z, y[c].z, s);
        s = fmaf(x[a].w, y[c].w, s);
        acc[a][c] = s;
      }
  }
}

__device__ __forceinline__ void fma4(float4& o, float w, float4 x) {
  o.x = fmaf(w, x.x, o.x);
  o.y = fmaf(w, x.y, o.y);
  o.z = fmaf(w, x.z, o.z);
  o.w = fmaf(w, x.w, o.w);
}

// out (rows y + TY r) += W^T X: sum over the tile's 64 rows i of
// W[i][row] * X[i][:], W a (64, PROW) tile, X staged (64, D + PAD)
template <int D>
__device__ __forceinline__ void acc_tn(float4 (&out)[Acc<D>::R][Acc<D>::NC], const float* W,
                                       const float* X, int y, int x) {
  using A = Acc<D>;
#pragma unroll 4
  for (int i = 0; i < BQ; ++i) {
    float w[A::R];
#pragma unroll
    for (int r = 0; r < A::R; ++r) w[r] = W[i * PROW + y + A::TY * r];
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      const float4 xv = load4(X + i * A::LD + 4 * (x + A::TX * c));
#pragma unroll
      for (int r = 0; r < A::R; ++r) fma4(out[r][c], w[r], xv);
    }
  }
}

// out (rows y + TY r) += W X: sum over the tile's 64 keys j of
// W[row][j] * X[j][:]
template <int D>
__device__ __forceinline__ void acc_nn(float4 (&out)[Acc<D>::R][Acc<D>::NC], const float* W,
                                       const float* X, int y, int x) {
  using A = Acc<D>;
#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    float w[A::R];
#pragma unroll
    for (int r = 0; r < A::R; ++r) w[r] = W[(y + A::TY * r) * PROW + j];
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      const float4 xv = load4(X + j * A::LD + 4 * (x + A::TX * c));
#pragma unroll
      for (int r = 0; r < A::R; ++r) fma4(out[r][c], w[r], xv);
    }
  }
}

// P and dS of one (query tile, key tile) pair, from the staged Q, dO, K,
// V and the rows' lse and Di, into Ps and Ss (both (64, PROW))
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* Os,
                                                  const float* Ks, const float* Vs,
                                                  const float* Ls, const float* Ds, float* Ps,
                                                  float* Ss, int i0, int k0, int S, float scale,
                                                  int causal) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  tile_dot<D>(s, Qs, Ks, ty, tx);
  tile_dot<D>(dp, Os, Vs, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int i = i0 + r;
    const float lse = Ls[r], di = Ds[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = tx + 16 * c;
      const int j = k0 + jl;
      const bool live = i < S && j < S && !(causal && j > i);
      const float p = live ? expf(s[a][c] * scale - lse) : 0.f;
      if (Ps != nullptr) Ps[r * PROW + jl] = p;
      Ss[r * PROW + jl] = p * (dp[a][c] - di);
    }
  }
}

// the lse and Di of rows i0 .. i0 + 63 (zeros past S)
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds, const float* lse,
                                           const float* di, size_t base, int i0, int S) {
  if (threadIdx.x < BQ) {
    const int row = i0 + threadIdx.x;
    Ls[threadIdx.x] = row < S ? lse[base + row] : 0.f;
    Ds[threadIdx.x] = row < S ? di[base + row] : 0.f;
  }
}

// ---- (a) Di = rowsum(dO o O), one warp a row ------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_prepass(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ di, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  const T* a = o + row * D;
  const T* b = dout + row * D;
  float s = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 x = load4(a + c), y = load4(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) di[row] = s;
}

// ---- (b) dK and dV, one block a (batch, KV head, key tile) ----------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attention_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      T* __restrict__ dk, T* __restrict__ dv, int B, int S, int Hq, int Hkv,
                      float scale, int causal) {
  using A = Acc<D>;
  constexpr int LD = A::LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Os = Qs + BQ * LD;    // dO
  float* Ps = Os + BQ * LD;
  float* Ss = Ps + BQ * PROW;  // dS
  float* Ls = Ss + BQ * PROW;
  float* Ds = Ls + BQ;

  const int bhkv = blockIdx.x % (B * Hkv);
  const int kt = blockIdx.x / (B * Hkv);
  const int b = bhkv / Hkv, hk = bhkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = kt * BK;
  const size_t kvoff = (size_t)bhkv * S * D;
  const int y = threadIdx.x / A::TX, x = threadIdx.x % A::TX;

  stage<D>(Ks, k + kvoff, k0, S);
  stage<D>(Vs, v + kvoff, k0, S);

  float4 dka[A::R][A::NC], dva[A::R][A::NC];
#pragma unroll
  for (int r = 0; r < A::R; ++r)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      dka[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dva[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  const int nqt = (S + BQ - 1) / BQ;
  // causal: query tiles from the diagonal on (BQ == BK)
  const int qt0 = causal ? kt : 0;
  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * Hq + hk * group + g;
    const size_t qoff = bh * S * D;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int i0 = qt * BQ;
      __syncthreads();  // every reader of the previous tiles is done
      stage<D>(Qs, q + qoff, i0, S);
      stage<D>(Os, dout + qoff, i0, S);
      stage_rows(Ls, Ds, lse, di, bh * S, i0, S);
      __syncthreads();
      probs_and_dscores<D>(Qs, Os, Ks, Vs, Ls, Ds, Ps, Ss, i0, k0, S, scale, causal);
      __syncthreads();
      acc_tn<D>(dva, Ps, Os, y, x);
      acc_tn<D>(dka, Ss, Qs, y, x);
    }
  }

#pragma unroll
  for (int r = 0; r < A::R; ++r) {
    const int row = k0 + y + A::TY * r;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < A::NC; ++c) {
        const size_t off = kvoff + (size_t)row * D + 4 * (x + A::TX * c);
        store4(dk + off, scaled(dka[r][c], scale));
        store4(dv + off, dva[r][c]);
      }
    }
  }
}

// ---- (c) dQ, one block a (batch, query head, query tile) ------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int B, int S, int Hq, int Hkv, float scale,
                    int causal) {
  using A = Acc<D>;
  constexpr int LD = A::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + BQ * LD;    // dO
  float* Ks = Os + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ss = Vs + BK * LD;    // dS
  float* Ls = Ss + BQ * PROW;
  float* Ds = Ls + BQ;

  const int nqt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = nqt - 1 - blockIdx.x / (B * Hq);
  const int b = bh / Hq, h = bh % Hq;
  const size_t kvoff = ((size_t)b * Hkv + h / (Hq / Hkv)) * S * D;
  const size_t qoff = (size_t)bh * S * D;
  const int i0 = qt * BQ;
  const int y = threadIdx.x / A::TX, x = threadIdx.x % A::TX;

  stage<D>(Qs, q + qoff, i0, S);
  stage<D>(Os, dout + qoff, i0, S);
  stage_rows(Ls, Ds, lse, di, (size_t)bh * S, i0, S);

  float4 dqa[A::R][A::NC];
#pragma unroll
  for (int r = 0; r < A::R; ++r)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) dqa[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // causal: key tiles up to the diagonal (BQ == BK)
  const int nkt = causal ? qt + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every reader of the previous tiles is done
    stage<D>(Ks, k + kvoff, k0, S);
    stage<D>(Vs, v + kvoff, k0, S);
    __syncthreads();
    probs_and_dscores<D>(Qs, Os, Ks, Vs, Ls, Ds, nullptr, Ss, i0, k0, S, scale, causal);
    __syncthreads();
    acc_nn<D>(dqa, Ss, Ks, y, x);
  }

#pragma unroll
  for (int r = 0; r < A::R; ++r) {
    const int row = i0 + y + A::TY * r;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < A::NC; ++c)
        store4(dq + qoff + (size_t)row * D + 4 * (x + A::TX * c), scaled(dqa[r][c], scale));
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* di, void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
           int S, float scale, int causal, cudaStream_t stream) {
  constexpr int LD = Acc<D>::LD;
  const size_t smem_kv = (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * BQ * PROW + 2 * BQ) * 4;
  const size_t smem_q = (size_t)(2 * BQ * LD + 2 * BK * LD + BQ * PROW + 2 * BQ) * 4;
  const long long rows = (long long)B * Hq * S;
  const long long tiles = (S + BQ - 1) / BQ;
  if ((rows + 7) / 8 > 0x7fffffffLL || tiles * B * Hq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);

  attention_bwd_prepass<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dop, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv_kernel = attention_dkdv_kernel<D, T>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(unsigned)(tiles * B * Hkv), THREADS, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, di, static_cast<T*>(dk), static_cast<T*>(dv), B, S, Hq, Hkv,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kernel = attention_dq_kernel<D, T>;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<(unsigned)(tiles * B * Hq), THREADS, smem_q, stream>>>(
      qp, kp, vp, dop, lse, di, static_cast<T*>(dq), B, S, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int D, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* di, void* dq, void* dk, void* dv,
                int B, int Hq, int Hkv, int S, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<32, T>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Hq, Hkv, S, scale, causal, st);
    case 64:
      return launch<64, T>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Hq, Hkv, S, scale, causal, st);
    case 128:
      return launch<128, T>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Hq, Hkv, S, scale, causal,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `di` is float32 scratch of B * Hq * S
// entries.  Returns cudaGetLastError() after the last launch (0 = all
// three launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* di, void* dq, void* dk, void* dv, int B,
                                          int Hq, int Hkv, int S, int D, int dtype,
                                          float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  if (dtype == 0)
    return by_head_dim<float>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S, scale,
                              causal, st);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S,
                                      scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
