// The gradient of the flash-attention kernel (flash_attention.cu), for
// sm_90a: bfloat16 on the tensor cores, float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference has no backward kernel.  It
// takes the gradient of its plain online-softmax loop
// (src/repro/models/attention.py:33, `chunked_attention`) with
// `jax.value_and_grad` (src/repro/train/train_step.py:34); this source
// computes that gradient for the function the forward kernel computes,
// with its conventions: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), all
// contiguous, bfloat16 or float32, D in {32, 64, 128}, any Sq, Sk >= 1
// (causal needs Sq == Sk; the full mask with Sq != Sk is
// cross-attention); query head h reads KV head h / (Hq / Hkv); scores
// s = (q . k) * scale in float32, scaled after the dot; causal or full;
// keys past Sk, queries past Sq and, under the causal mask, keys past
// the query are masked (P = 0, as exp(-1e30 - lse) is in float32).
//
// From the forward's output o and its row log-sum-exp lse (float32,
// (B, Hq, Sq), m + log(l) in the units of the scaled scores), with
// P = exp(s - lse):
//   Di = rowsum(dO o O)                        (pre-pass, float32)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di)
//   dQ = dS K * scale,  dK = dS^T Q * scale    (GQA: summed over a group)
// Every sum is taken in float32 and the outputs are rounded once to the
// inputs' type.  There are no atomics: two launches on the same inputs
// give the same bits.  Both dtypes start with a pre-pass in which one
// warp a row computes Di.
//
// What bounds it.  The gradient does 2.5x the forward's operations (five
// products of the forward's two sizes); at B = 1, Hq = 32, S = 4096,
// D = 128, causal, that is ~343 GFLOP, 0.35 ms at the tensor cores' bf16
// rate of 989 TFLOP/s, against ~26 MB of bytes.
//
// bfloat16: the tensor cores, four launches, in the forward's pieces
// (sm90.cuh: tensor maps over (D, Sq or Sk, B * H) with rows past the
// length zero and
// D = 32 carried as 64 columns, TMA into the 128-byte swizzle, mbarriers,
// wgmma).  P and dS keep float32 precision as in the forward: each is
// split into bf16(x) and bf16(x - bf16(x)), and both halves go through a
// register-A wgmma into the same float32 accumulator (a single bf16 P and
// dS, the textbook design, lands ~20x further from the float32
// gradient).  S and dP are computed in both (b) and (d), and dV, dK and
// dQ take two products each: ten products where the bound counts five,
// a floor of 2x the bound (~0.7 ms at the shape above).
//   (a) `attention_bwd_prepass_pairs`: `attention_bwd_prepass`'s Di beside
//       each row's lse (times log2 e), as float pairs, each head's Sq rows
//       padded to a multiple of 64 with zeros, so a tile's pairs arrive
//       by one bulk copy.
//   (b) `attention_dkdv_bf16_kernel`: one block a (batch, query head,
//       128-key tile), the first key tiles (the most query tiles under
//       the causal mask) first.  K and V arrive once; (Q, dO, pairs)
//       tiles of 64 queries stream through a four-stage ring.  Under the
//       causal mask only the query tiles on or past the diagonal are
//       read.  Each warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T
//       (m64n64k16, both operands from shared memory, K-major), P^T and
//       dS^T in the accumulators' own registers, then dV += P^T dO and
//       dK += dS^T Q (register-A m64n{D}k16, dO and Q read MN-major from
//       the same swizzled tiles).  The accumulator's fragment is the A
//       operand's, so nothing passes through shared memory.  To hold the
//       registers at two (64, D) accumulators plus 64 more, the products
//       go out in three groups a tile: S^T (issued with the previous
//       tile's dK), then dP^T with dV once P^T is split, then dK with the
//       next S^T once dS^T (from P^T's halves) is split.  dK and dV are
//       per query head: the epilogue stores them in float32 to scratch.
//   (c) `attention_group_sum`: each KV head's dK and dV, its group's
//       Hq / Hkv partials added in head order and rounded once to bf16.
//   (d) `attention_dq_bf16_kernel`: one block a (batch, query head,
//       128-query tile), the last query tiles first: Q and dO arrive
//       once, (K, V) tiles of 64 keys stream through a four-stage ring.
//       S = Q K^T and dP = dO V^T from shared memory, P and dS in
//       registers from the rows' pairs, then dQ += dS K (register-A, K
//       read MN-major from the tile that fed S), issued with the next
//       tile's S and dP.  Each dQ row is written once, rows < Sq only.
// Sq and Sk are each three things in (b) and (d): the rows of their
// tensor maps, the tile counts (query tiles and dQ blocks from Sq, key
// tiles and dK/dV blocks from Sk) and the masks.  A key row past Sk
// arrives zero-filled and would still score 0 (P = exp(-lse), not 0),
// so keys >= Sk are masked in every tile of both kernels, and queries
// >= Sq in the dK/dV kernel (its P^T columns).
// Both kernels run two warpgroups and no producer warp: thread 0 issues
// every load, two tiles ahead of the one in use, into the stage of a
// tile both warpgroups released two tiles back, so it does not wait in
// practice.  A producer warp would make the block 288 threads, for which
// ptxas caps a thread at 168 registers (as for the forward); at 256
// threads the cap is 255, and the D = 128 instances take 254 (dK/dV) and
// 218 (dQ) with no spills (with a producer warp, or a producer warpgroup
// handing registers over by setmaxnreg, ptxas kept the cap at 168 and
// the D = 128 kernels spilled; PERF.md §6).  Both warpgroups step through
// every tile the block loads (a tile wholly masked for one of them adds
// exactly 0), and the mask is applied only on diagonal and ragged tiles.
//
// float32: the CUDA cores, as in the first port (the float32 twin is
// held to 1e-4, which TF32 cannot meet), three launches: (a)
// `attention_bwd_prepass` writes Di; every input is widened to float32
// as it is staged in shared memory:
//   (b) `attention_dkdv_kernel`: one block a (batch, KV head, 64-key
//       tile) holds its K and V tiles, loops over the group's query heads
//       and the query tiles on or below the diagonal, recomputes P from
//       Q, K and lse, and accumulates dV and dK in registers; it writes
//       each once.  The first key tiles start first.
//   (c) `attention_dq_kernel`: one block a (batch, query head, 64-query
//       tile) holds its Q and dO tiles, loops over the key tiles on or
//       below the diagonal, recomputes P and dS, and accumulates dQ.  The
//       last query tiles start first.
// Tiles: 64 queries x 64 keys, 256 threads.  A score tile is 16 x 16
// threads of 4 x 4 entries (rows ty + 16a, keys tx + 16c), each a float4
// walk along D over rows padded by 4 floats (conflict-free 16-byte loads).
// The (64, D) accumulators give each thread R rows of NC float4 columns.
// This design recomputes S and dP in both kernels (seven products) at
// the CUDA cores' float32 rate of 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int S) {
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
                                                  float* Ss, int i0, int k0, int Sq, int Sk,
                                                  float scale, int causal) {
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
      const bool live = i < Sq && j < Sk && !(causal && j > i);
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

// the warp's sum of a[c] b[c] over the row's D columns, in every lane
template <typename T>
__device__ __forceinline__ float row_dot(const T* a, const T* b, int D, int lane) {
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
  return s;
}

__global__ void __launch_bounds__(256)
attention_bwd_prepass(const float* __restrict__ o, const float* __restrict__ dout,
                      float* __restrict__ di, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  const float s = row_dot(o + row * D, dout + row * D, D, lane);
  if (lane == 0) di[row] = s;
}

// ---- (b) dK and dV, one block a (batch, KV head, key tile) ----------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dk, float* __restrict__ dv, int B, int Sq, int Sk,
                      int Hq, int Hkv, float scale, int causal) {
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
  const size_t kvoff = (size_t)bhkv * Sk * D;
  const int y = threadIdx.x / A::TX, x = threadIdx.x % A::TX;

  stage<D>(Ks, k + kvoff, k0, Sk);
  stage<D>(Vs, v + kvoff, k0, Sk);

  float4 dka[A::R][A::NC], dva[A::R][A::NC];
#pragma unroll
  for (int r = 0; r < A::R; ++r)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      dka[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dva[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  const int nqt = (Sq + BQ - 1) / BQ;
  // causal (Sq == Sk): query tiles from the diagonal on (BQ == BK)
  const int qt0 = causal ? kt : 0;
  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * Hq + hk * group + g;
    const size_t qoff = bh * Sq * D;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int i0 = qt * BQ;
      __syncthreads();  // every reader of the previous tiles is done
      stage<D>(Qs, q + qoff, i0, Sq);
      stage<D>(Os, dout + qoff, i0, Sq);
      stage_rows(Ls, Ds, lse, di, bh * Sq, i0, Sq);
      __syncthreads();
      probs_and_dscores<D>(Qs, Os, Ks, Vs, Ls, Ds, Ps, Ss, i0, k0, Sq, Sk, scale, causal);
      __syncthreads();
      acc_tn<D>(dva, Ps, Os, y, x);
      acc_tn<D>(dka, Ss, Qs, y, x);
    }
  }

#pragma unroll
  for (int r = 0; r < A::R; ++r) {
    const int row = k0 + y + A::TY * r;
    if (row < Sk) {
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

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, int B, int Sq, int Sk, int Hq, int Hkv,
                    float scale, int causal) {
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

  const int nqt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = nqt - 1 - blockIdx.x / (B * Hq);
  const int b = bh / Hq, h = bh % Hq;
  const size_t kvoff = ((size_t)b * Hkv + h / (Hq / Hkv)) * Sk * D;
  const size_t qoff = (size_t)bh * Sq * D;
  const int i0 = qt * BQ;
  const int y = threadIdx.x / A::TX, x = threadIdx.x % A::TX;

  stage<D>(Qs, q + qoff, i0, Sq);
  stage<D>(Os, dout + qoff, i0, Sq);
  stage_rows(Ls, Ds, lse, di, (size_t)bh * Sq, i0, Sq);

  float4 dqa[A::R][A::NC];
#pragma unroll
  for (int r = 0; r < A::R; ++r)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) dqa[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // causal (Sq == Sk): key tiles up to the diagonal (BQ == BK)
  const int nkt = causal ? qt + 1 : (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every reader of the previous tiles is done
    stage<D>(Ks, k + kvoff, k0, Sk);
    stage<D>(Vs, v + kvoff, k0, Sk);
    __syncthreads();
    probs_and_dscores<D>(Qs, Os, Ks, Vs, Ls, Ds, nullptr, Ss, i0, k0, Sq, Sk, scale, causal);
    __syncthreads();
    acc_nn<D>(dqa, Ss, Ks, y, x);
  }

#pragma unroll
  for (int r = 0; r < A::R; ++r) {
    const int row = i0 + y + A::TY * r;
    if (row < Sq) {
#pragma unroll
      for (int c = 0; c < A::NC; ++c)
        store4(dq + qoff + (size_t)row * D + 4 * (x + A::TX * c), scaled(dqa[r][c], scale));
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* di, void* dq, void* dk, void* dv, int B, int Hq,
               int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr int LD = Acc<D>::LD;
  const size_t smem_kv = (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * BQ * PROW + 2 * BQ) * 4;
  const size_t smem_q = (size_t)(2 * BQ * LD + 2 * BK * LD + BQ * PROW + 2 * BQ) * 4;
  const long long rows = (long long)B * Hq * Sq;
  const long long qtiles = (Sq + BQ - 1) / BQ, ktiles = (Sk + BK - 1) / BK;
  if ((rows + 7) / 8 > 0x7fffffffLL || qtiles * B * Hq > 0x7fffffffLL ||
      ktiles * B * Hkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);

  attention_bwd_prepass<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), dop, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv_kernel = attention_dkdv_kernel<D>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(unsigned)(ktiles * B * Hkv), THREADS, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, di, static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, Hq,
      Hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kernel = attention_dq_kernel<D>;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<(unsigned)(qtiles * B * Hq), THREADS, smem_q, stream>>>(
      qp, kp, vp, dop, lse, di, static_cast<float*>(dq), B, Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int KT = 128;            // keys of a dK/dV block, queries of a dQ block
constexpr int QT = 64;             // queries of a streamed (Q, dO) tile
constexpr int KS = 64;             // keys of a streamed (K, V) tile
constexpr int STAGES = 4;          // streamed tiles held
constexpr int AHEAD = STAGES - 2;  // tiles loaded ahead of the one in use
constexpr int TC_THREADS = 256;    // two warpgroups of 64 rows
constexpr int ROW_PAD = 64;        // each head's (lse, Di) rows padded to a multiple
// whether P and dS feed dV, dK and dQ as both bf16 halves; built with
// -DATTN_BWD_SINGLE_BF16 the lo products are left out, the textbook
// single-bf16 design (a control of the card's relative L2 bound:
// attention_pair.py)
#ifdef ATTN_BWD_SINGLE_BF16
constexpr bool LO_HALVES = false;
#else
constexpr bool LO_HALVES = true;
#endif

// dK/dV: K and V of 128 keys, then STAGES x (Q, dO) of QT queries, then
// STAGES x the (lse log2 e, Di) pairs of those queries, then the barriers
template <int D>
struct DkdvLayout {
  static constexpr int DP = D < CHUNK ? CHUNK : D;  // columns held (D = 32 padded)
  static constexpr int NCH = DP / CHUNK;            // 128-byte column chunks
  static constexpr int K_CHUNK = KT * 128;          // bytes of one K (or V) column chunk
  static constexpr int KV_BYTES = NCH * K_CHUNK;
  static constexpr int Q_CHUNK = QT * 128;          // bytes of one Q (or dO) column chunk
  static constexpr int QT_BYTES = NCH * Q_CHUNK;    // one streamed Q (or dO) tile
  static constexpr int ROW_BYTES = QT * 8;          // one tile's pairs
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_ROWS = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * ROW_BYTES;
  static constexpr int NBAR = 1 + 2 * STAGES;       // K/V full; full, empty per stage
  static constexpr int SMEM = OFF_BAR + 8 * NBAR + 1024;  // + slack to align to 1024
};

// dQ: Q and dO of 128 queries, then STAGES x (K, V) of 64 keys, then the
// barriers
template <int D>
struct DqLayout {
  static constexpr int DP = D < CHUNK ? CHUNK : D;
  static constexpr int NCH = DP / CHUNK;
  static constexpr int Q_CHUNK = KT * 128;          // bytes of one Q (or dO) column chunk
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_CHUNK = KS * 128;         // bytes of one K (or V) column chunk
  static constexpr int KV_BYTES = NCH * KV_CHUNK;   // one streamed K (or V) tile
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int NBAR = 1 + 2 * STAGES;       // Q/dO full; full, empty per stage
  static constexpr int SMEM = OFF_BAR + 8 * NBAR + 1024;
};

// ---- (a) Di and lse log2 e as pairs, each head's rows padded to ROW_PAD --

__global__ void __launch_bounds__(256)
attention_bwd_prepass_pairs(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, float2* __restrict__ pairs,
                            long long rows, int S, int Sp, int D) {
  // rows: B * Hq * Sp; rows past S are (0, 0)
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  const long long bh = row / Sp;
  const int s = (int)(row % Sp);
  float2 pr = make_float2(0.f, 0.f);
  if (s < S) {
    const long long r = bh * S + s;
    pr = make_float2(lse[r] * LOG2E, row_dot(o + r * D, dout + r * D, D, lane));
  }
  if (lane == 0) pairs[row] = pr;
}

// a fresh product's accumulator: its first k-step overwrites it, so the
// old values die at their last read instead of living to the wgmma (set
// before the fence, which must follow every register write a wgmma reads)
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// A fragments stay live (and in place) until the wgmma that reads them
// has been waited for
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// the float pair a bf16 hi + lo pair of A-fragment registers holds
__device__ __forceinline__ float2 joined(uint32_t hi, uint32_t lo) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  return make_float2(h.x + l.x, h.y + l.y);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory; the barrier counts them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

__device__ __forceinline__ void init_barriers(uint32_t first_full, uint32_t full,
                                              uint32_t empty) {
  if (threadIdx.x == 0) {
    bar_init(first_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, TC_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---- (b) dK and dV per query head, one block a (batch, query head, 128 keys)

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
attention_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float2* __restrict__ pairs, float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int B, int Sq, int Sk, int Hq,
                           int Hkv, float scale, int causal) {
  using L = DkdvLayout<D>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sbase, sv = sbase + L::OFF_V;
  const uint32_t sq = sbase + L::OFF_Q, sdo = sbase + L::OFF_DO, srows = sbase + L::OFF_ROWS;
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (sbase - smem_u32(smem_raw)) + L::OFF_ROWS);
  const uint32_t kv_full = sbase + L::OFF_BAR;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;

  // the first key tiles (the most query tiles under the causal mask) start first
  const int bh = blockIdx.x % (B * Hq);
  const int k0 = blockIdx.x / (B * Hq) * KT;
  const int b = bh / Hq, h = bh % Hq;
  const int bhkv = b * Hkv + h / (Hq / Hkv);
  const int qt0 = causal ? k0 / QT : 0;             // the diagonal's query tile
  const int ntiles = (Sq + QT - 1) / QT - qt0;
  const float2* pairs_bh = pairs + (size_t)bh * ((Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD);
  init_barriers(kv_full, full, empty);

  // thread 0 loads: tile i's Q, dO and pairs into stage i % STAGES once
  // every warp has released the tile that held it
  auto load_tile = [&](int i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i) * QT;
    if (i >= STAGES) bar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
    bar_expect_tx(full + 8 * s, 2 * L::QT_BYTES + L::ROW_BYTES);
    for (int c = 0; c < L::NCH; ++c) {
      tma_load(sq + s * L::QT_BYTES + c * L::Q_CHUNK, &qmap, full + 8 * s, c * CHUNK, q0, bh);
      tma_load(sdo + s * L::QT_BYTES + c * L::Q_CHUNK, &domap, full + 8 * s, c * CHUNK, q0,
               bh);
    }
    bulk_load(srows + s * L::ROW_BYTES, pairs_bh + q0, L::ROW_BYTES, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    bar_expect_tx(kv_full, 2 * L::KV_BYTES);
    for (int c = 0; c < L::NCH; ++c) {
      tma_load(sk + c * L::K_CHUNK, &kmap, kv_full, c * CHUNK, k0, bhkv);
      tma_load(sv + c * L::K_CHUNK, &vmap, kv_full, c * CHUNK, k0, bhkv);
    }
    for (int i = 0; i < AHEAD && i < ntiles; ++i) load_tile(i);
  }
  __syncwarp();

  // ---- warpgroup wg takes keys kw0 .. kw0 + 63 ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int kA = kw0 + 16 * (warp % 4) + g;  // this thread's two keys
  const int kB = kA + 8;
  const uint32_t sk_wg = sk + wg * 64 * 128, sv_wg = sv + wg * 64 * 128;
  const float sl2 = scale * LOG2E;

  float sacc[QT / 2];                  // S^T of a tile
  float dpacc[QT / 2];                 // dP^T of a tile
  float dv[DP / 2], dk[DP / 2];        // the accumulators
  uint32_t phi[QT / 4], plo[QT / 4];   // P^T's bf16 halves as A fragments
  uint32_t shi[QT / 4], slo[QT / 4];   // dS^T's
  zero(dv);
  zero(dk);

  // S^T = K Q^T (a = K) or dP^T = V dO^T (a = V) of the tile at x: D/16
  // k-steps of 32 bytes along the swizzled rows
  auto issue_t = [&](float (&acc)[QT / 2], uint32_t a, uint32_t x) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      mma_ss(acc, desc128(a + (ks / 4) * L::K_CHUNK + off, 16, 1024),
             desc128(x + (ks / 4) * L::Q_CHUNK + off, 16, 1024), (int)(ks > 0));
    }
  };
  // acc += hi X + lo X, X the (QT queries, D) tile at x read MN-major: 16
  // queries a k-step
  auto issue_acc = [&](float (&acc)[DP / 2], const uint32_t* hi, const uint32_t* lo,
                       uint32_t x) {
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t dx = desc128(x + kk * 16 * 128, L::Q_CHUNK, 1024);
      mma_rs(acc, hi + 4 * kk, dx);
      if constexpr (LO_HALVES) mma_rs(acc, lo + 4 * kk, dx);
    }
  };
  // P^T = exp(S^T scale - lse) of the tile at queries q0 .., masked (only
  // on diagonal and ragged tiles), split into bf16 halves: query columns
  // 16 kk .. 16 kk + 15 are k-step kk, registers {key A, key B} x
  // {columns 2t, 2t + 8}; rs holds the tile's (lse log2 e, Di) pairs
  auto probs = [&](int q0, const float* rs) {
    const bool masked = q0 + QT > Sq || kw0 + 64 > Sk || (causal && kw0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float4 ld = *reinterpret_cast<const float4*>(rs + 2 * c);
      float p[4] = {ex2(fmaf(sacc[4 * j], sl2, -ld.x)), ex2(fmaf(sacc[4 * j + 1], sl2, -ld.z)),
                    ex2(fmaf(sacc[4 * j + 2], sl2, -ld.x)),
                    ex2(fmaf(sacc[4 * j + 3], sl2, -ld.z))};
      if (masked) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + c + e;
          if (qp >= Sq || kA >= Sk || (causal && kA > qp)) p[e] = 0.f;
          if (qp >= Sq || kB >= Sk || (causal && kB > qp)) p[2 + e] = 0.f;
        }
      }
      const int r = 4 * (j / 2) + 2 * (j % 2);
      split(p[0], p[1], phi[r], plo[r]);
      split(p[2], p[3], phi[r + 1], plo[r + 1]);
    }
  };
  // dS^T = P^T (dP^T - Di), P^T as its two halves, split the same way
  auto dscores = [&](const float* rs) {
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const float4 ld = *reinterpret_cast<const float4*>(rs + 2 * (8 * j + 2 * t));
      const int r = 4 * (j / 2) + 2 * (j % 2);
      const float2 pA = joined(phi[r], plo[r]), pB = joined(phi[r + 1], plo[r + 1]);
      split(pA.x * (dpacc[4 * j] - ld.y), pA.y * (dpacc[4 * j + 1] - ld.w), shi[r], slo[r]);
      split(pB.x * (dpacc[4 * j + 2] - ld.y), pB.y * (dpacc[4 * j + 3] - ld.w), shi[r + 1],
            slo[r + 1]);
    }
  };
  // one tile; with `more`, the next tile's S^T goes out with this dK
  auto step = [&](int i, auto more) {
    const int s = i % STAGES;
    if (threadIdx.x == 0 && i + AHEAD < ntiles) load_tile(i + AHEAD);
    __syncwarp();
    const uint32_t sq_s = sq + s * L::QT_BYTES, sdo_s = sdo + s * L::QT_BYTES;
    const float* rs = rows + s * (L::ROW_BYTES / 4);
    probs((qt0 + i) * QT, rs);
    // dP^T, and dV += P^T dO
    zero(dpacc);
    keep(dpacc);
    keep(dv);
    keep(phi);
    keep(plo);
    wg_fence();
    issue_t(dpacc, sv_wg, sdo_s);
    issue_acc(dv, phi, plo, sdo_s);
    wg_commit();
    wg_wait<0>();
    keep(dpacc);
    keep(dv);
    keep(phi);
    keep(plo);
    dscores(rs);
    // dK += dS^T Q, and S^T of the next tile
    const int s1 = (i + 1) % STAGES;
    if constexpr (decltype(more)::value) {
      bar_wait(full + 8 * s1, ((i + 1) / STAGES) & 1);
      zero(sacc);
      keep(sacc);
    }
    keep(dk);
    keep(shi);
    keep(slo);
    wg_fence();
    issue_acc(dk, shi, slo, sq_s);
    if constexpr (decltype(more)::value) issue_t(sacc, sk_wg, sq + s1 * L::QT_BYTES);
    wg_commit();
    wg_wait<0>();
    keep(dk);
    keep(sacc);
    keep(shi);
    keep(slo);
    release(empty + 8 * s, lane);
  };

  bar_wait(kv_full, 0);
  bar_wait(full, 0);
  zero(sacc);
  keep(sacc);
  wg_fence();
  issue_t(sacc, sk_wg, sq);
  wg_commit();
  wg_wait<0>();
  keep(sacc);
  for (int i = 0; i + 1 < ntiles; ++i) step(i, std::true_type{});
  step(ntiles - 1, std::false_type{});

  // ---- epilogue: this head's dK (times scale) and dV in float32, keys < Sk ----
  float* dkb = dk_part + (size_t)bh * Sk * D;
  float* dvb = dv_part + (size_t)bh * Sk * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < D) {
      if (kA < Sk) {
        *reinterpret_cast<float2*>(dkb + (size_t)kA * D + col) =
            make_float2(dk[4 * j] * scale, dk[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)kA * D + col) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (kB < Sk) {
        *reinterpret_cast<float2*>(dkb + (size_t)kB * D + col) =
            make_float2(dk[4 * j + 2] * scale, dk[4 * j + 3] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)kB * D + col) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ---- (c) each KV head's dK and dV: its group's partials in head order ----

__global__ void __launch_bounds__(256)
attention_group_sum(const float4* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, long long n4, long long slab4, int group) {
  // n4: float4s of one output, slab4: of one head's (Sk, D)
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;  // 0: dK, 1: dV
  const long long e = i - which * n4;
  const float4* src = part + which * n4 * group + (e / slab4) * group * slab4 + e % slab4;
  float4 acc = src[0];
  for (int h = 1; h < group; ++h) {
    const float4 x = src[h * slab4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4((which ? dv : dk) + 4 * e, acc);
}

// ---- (d) dQ, one block a (batch, query head, 128 queries) ----------------

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
attention_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float2* __restrict__ pairs, __nv_bfloat16* __restrict__ dq,
                         int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = sbase, sdo = sbase + L::OFF_DO;
  const uint32_t sk = sbase + L::OFF_K, sv = sbase + L::OFF_V;
  const uint32_t q_full = sbase + L::OFF_BAR;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  // the last query tiles (the most keys under the causal mask) start first
  const int bh = blockIdx.x % (B * Hq);
  const int q0 = ((Sq + KT - 1) / KT - 1 - blockIdx.x / (B * Hq)) * KT;
  const int b = bh / Hq, h = bh % Hq;
  const int bhkv = b * Hkv + h / (Hq / Hkv);
  const int ntiles = ((causal ? min(q0 + KT, Sq) : Sk) + KS - 1) / KS;
  init_barriers(q_full, full, empty);

  // thread 0 loads: key tile j's K and V into stage j % STAGES once every
  // warp has released the tile that held it
  auto load_tile = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) bar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
    bar_expect_tx(full + 8 * s, 2 * L::KV_BYTES);
    for (int c = 0; c < L::NCH; ++c) {
      tma_load(sk + s * L::KV_BYTES + c * L::KV_CHUNK, &kmap, full + 8 * s, c * CHUNK, j * KS,
               bhkv);
      tma_load(sv + s * L::KV_BYTES + c * L::KV_CHUNK, &vmap, full + 8 * s, c * CHUNK, j * KS,
               bhkv);
    }
  };
  if (threadIdx.x == 0) {
    bar_expect_tx(q_full, 2 * L::Q_BYTES);
    for (int c = 0; c < L::NCH; ++c) {
      tma_load(sq + c * L::Q_CHUNK, &qmap, q_full, c * CHUNK, q0, bh);
      tma_load(sdo + c * L::Q_CHUNK, &domap, q_full, c * CHUNK, q0, bh);
    }
    for (int j = 0; j < AHEAD && j < ntiles; ++j) load_tile(j);
  }
  __syncwarp();

  // ---- warpgroup wg takes rows row0 .. row0 + 63 ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;
  const int rA = row0 + 16 * (warp % 4) + g;   // this thread's two rows
  const int rB = rA + 8;
  const uint32_t sq_wg = sq + wg * 64 * 128, sdo_wg = sdo + wg * 64 * 128;
  const float sl2 = scale * LOG2E;
  const float2* pairs_bh = pairs + (size_t)bh * ((Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD);
  const float2 pa = rA < Sq ? pairs_bh[rA] : make_float2(0.f, 0.f);  // (lse log2 e, Di)
  const float2 pb = rB < Sq ? pairs_bh[rB] : make_float2(0.f, 0.f);

  float sacc[KS / 2], dpacc[KS / 2];     // S and dP of a tile
  float dqa[DP / 2];                     // the accumulator
  uint32_t shi[KS / 4], slo[KS / 4];     // dS's bf16 halves as A fragments
  zero(dqa);

  // S = Q K^T and dP = dO V^T of the tile in stage s
  auto issue_sdp = [&](int s) {
    const uint32_t skt = sk + s * L::KV_BYTES, svt = sv + s * L::KV_BYTES;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks / 4) * L::Q_CHUNK + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * L::KV_CHUNK + (ks % 4) * 32;
      mma_ss(sacc, desc128(sq_wg + off, 16, 1024), desc128(skt + koff, 16, 1024),
             (int)(ks > 0));
      mma_ss(dpacc, desc128(sdo_wg + off, 16, 1024), desc128(svt + koff, 16, 1024),
             (int)(ks > 0));
    }
  };
  // dQ += dS_hi K + dS_lo K for the tile in stage s: 16 keys a k-step, K
  // read MN-major
  auto issue_dq = [&](int s) {
    const uint32_t skt = sk + s * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const uint64_t dx = desc128(skt + kk * 16 * 128, L::KV_CHUNK, 1024);
      mma_rs(dqa, shi + 4 * kk, dx);
      if constexpr (LO_HALVES) mma_rs(dqa, slo + 4 * kk, dx);
    }
  };
  // dS = P (dP - Di), P = exp(S scale - lse), masked (only on diagonal and
  // ragged tiles), split into bf16 halves
  auto dscores = [&](int kt) {
    const int kbase = kt * KS;
    const bool masked = kbase + KS > Sk || (causal && kbase + KS - 1 > row0);
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ex2(fmaf(sacc[4 * j + e], sl2, -pa.x));
        float p1 = ex2(fmaf(sacc[4 * j + 2 + e], sl2, -pb.x));
        if (masked) {
          const int key = kbase + 8 * j + 2 * t + e;
          if (key >= Sk || (causal && key > rA)) p0 = 0.f;
          if (key >= Sk || (causal && key > rB)) p1 = 0.f;
        }
        x[e] = p0 * (dpacc[4 * j + e] - pa.y);
        x[2 + e] = p1 * (dpacc[4 * j + 2 + e] - pb.y);
      }
      const int r = 4 * (j / 2) + 2 * (j % 2);
      split(x[0], x[1], shi[r], slo[r]);
      split(x[2], x[3], shi[r + 1], slo[r + 1]);
    }
  };
  // one tile; with `more`, the next tile's S and dP go out with this dQ
  auto step = [&](int j, auto more) {
    const int s = j % STAGES;
    if (threadIdx.x == 0 && j + AHEAD < ntiles) load_tile(j + AHEAD);
    __syncwarp();
    dscores(j);
    const int s1 = (j + 1) % STAGES;
    if constexpr (decltype(more)::value) {
      bar_wait(full + 8 * s1, ((j + 1) / STAGES) & 1);
      zero(sacc);
      zero(dpacc);
      keep(sacc);
      keep(dpacc);
    }
    keep(dqa);
    keep(shi);
    keep(slo);
    wg_fence();
    issue_dq(s);
    if constexpr (decltype(more)::value) issue_sdp(s1);
    wg_commit();
    wg_wait<0>();
    keep(dqa);
    keep(sacc);
    keep(dpacc);
    keep(shi);
    keep(slo);
    release(empty + 8 * s, lane);
  };

  bar_wait(q_full, 0);
  bar_wait(full, 0);
  zero(sacc);
  zero(dpacc);
  keep(sacc);
  keep(dpacc);
  wg_fence();
  issue_sdp(0);
  wg_commit();
  wg_wait<0>();
  keep(sacc);
  keep(dpacc);
  for (int j = 0; j + 1 < ntiles; ++j) step(j, std::true_type{});
  step(ntiles - 1, std::false_type{});

  // ---- epilogue: dQ times scale in bf16, rows < Sq only ----
  __nv_bfloat16* qb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < D) {
      if (rA < Sq)
        *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)rA * D + col) =
            __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (rB < Sq)
        *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)rB * D + col) =
            __floats2bfloat162_rn(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int Hq,
                int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  const int Sp = (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long rows = (long long)B * Hq * Sp;           // padded (lse, Di) rows
  const long long kv_blocks = (long long)((Sk + KT - 1) / KT) * B * Hq;
  const long long q_blocks = (long long)((Sq + KT - 1) / KT) * B * Hq;
  const long long n4 = (long long)B * Hkv * Sk * D / 4;    // float4s of dk (and of dv)
  if ((rows + 7) / 8 > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL ||
      (2 * n4 + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const long long bhq = (long long)B * Hq, bhkv = (long long)B * Hkv;
  // (b) streams QT-query tiles past 128 keys, (d) 64-key tiles past 128 queries
  CUtensorMap qs, dos, k128, v128, q128, do128, k64, v64;
  if (!encode(fn, &qs, q, D, Sq, bhq, QT) || !encode(fn, &dos, dout, D, Sq, bhq, QT) ||
      !encode(fn, &k128, k, D, Sk, bhkv, KT) || !encode(fn, &v128, v, D, Sk, bhkv, KT) ||
      !encode(fn, &q128, q, D, Sq, bhq, KT) || !encode(fn, &do128, dout, D, Sq, bhq, KT) ||
      !encode(fn, &k64, k, D, Sk, bhkv, KS) || !encode(fn, &v64, v, D, Sk, bhkv, KS))
    return (int)cudaErrorInvalidValue;

  // scratch: the pairs (B * Hq * Sp float2), then dK's and dV's per-head
  // partials (B * Hq * Sk * D floats each)
  float2* pairs = reinterpret_cast<float2*>(scratch);
  float* dk_part = scratch + 2 * rows;
  float* dv_part = dk_part + (size_t)B * Hq * Sk * D;
  attention_bwd_prepass_pairs<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
      pairs, rows, Sq, Sp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv_kernel = attention_dkdv_bf16_kernel<D>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkdvLayout<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(unsigned)kv_blocks, TC_THREADS, DkdvLayout<D>::SMEM, stream>>>(
      qs, k128, v128, dos, pairs, dk_part, dv_part, B, Sq, Sk, Hq, Hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  attention_group_sum<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n4, (long long)Sk * D / 4, Hq / Hkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kernel = attention_dq_bf16_kernel<D>;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqLayout<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<(unsigned)q_blocks, TC_THREADS, DqLayout<D>::SMEM, stream>>>(
      q128, k64, v64, do128, pairs, static_cast<__nv_bfloat16*>(dq), B, Sq, Sk, Hq, Hkv, scale,
      causal);
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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  `scratch`
// is float32: for float32 B * Hq * Sq entries (Di); for bfloat16
// 2 * B * Hq * Sp + 2 * B * Hq * Sk * D, Sp = Sq rounded up to a multiple
// of 64 (each row's (lse log2 e, Di), then the per-head dK and dV).
// Causal needs Sq == Sk.  Returns cudaGetLastError() after the last
// launch (0 = all launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* scratch, void* dq, void* dk, void* dv, int B,
                                          int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                          float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv != 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return by_head_dim(D, [&](auto dd) {
      return launch_f32<decltype(dd)::value>(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq, Hkv,
                                             Sq, Sk, scale, causal, st);
    });
  if (dtype == 1)
    return by_head_dim(D, [&](auto dd) {
      return tc::launch_bf16<decltype(dd)::value>(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq,
                                                  Hkv, Sq, Sk, scale, causal, st);
    });
  return (int)cudaErrorInvalidValue;
}
