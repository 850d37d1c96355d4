// Hopper (sm_90a) backward of the model substrate's attention (attn.cu):
// the gradients of causal or non-causal grouped-query attention,
//
//   q (B, Sq, H, dh), k, v (B, Skv, Hkv, dh), o and dO (B, Sq, H, dh), lse
//   (B, H, Sq) float32 (the forward's per-row logsumexp of the scaled
//   scores)  ->  dq (B, Sq, H, dh), dk and dv (B, Skv, Hkv, dh) in q's
//   dtype
//
// with P = exp(q.k^T scale - lse) (masked scores: causal j > i, keys past
// Skv and rows past Sq, give 0), D = rowsum(dO o), dS = P (dP - D), dP =
// dO.v^T:
//
//   dv = P^T dO,  dq = scale dS k,  dk = scale dS^T q,
//
// dk and dv summed over the H / Hkv query heads that read each kv head.
// Sq and Skv may differ where the attention is not causal (whisper's cross
// attention); a causal launch needs Sq == Skv.
// Sums are float32; each output is rounded once to the input's dtype.  No
// atomics: every sum runs in a fixed order, so two launches give the same
// bits.  One launcher with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py), three kernels on the given stream,
// in one of two forms (the forward's `form`):
//
//   1. attn_bwd_rows_kernel: D for every (b, h, row), a warp four rows,
//      and the wgmma form's base-2 logsumexp, padded past Sq.
//   2. the dQ pass, one block per query tile of one (b, h), walking the key
//      tiles of Skv (up to the diagonal when causal): S = q.k^T and dP =
//      dO.v^T recomputed, dS, dq += dS.k.
//   3. the dK/dV pass, one block per key tile of one (b, kv head) with K and
//      V staged once, walking the query tiles of Sq (from the diagonal on
//      when causal) for each of the group's query heads: S^T, dP^T, P^T,
//      dS^T, dv += P^T.dO and dk += dS^T.q.  Summing the group inside the
//      block needs no atomics.
//
// The JAX package has no backward kernel: it trains through jnp attention
// (src/repro/models/attention.py:77-162), whose gradient XLA derives; this
// is the gradient of the port's forward kernel, which replaces the Pallas
// `_kernel` of src/repro/kernels/flash_attention.py:25.  Bound: operations,
// the five products 10 B H Sq Skv dh (halved when causal) against the bytes of
// q, k, v, o, dO and the three gradients.  Both forms recompute S and dP in
// both passes (seven products; the wgmma form's split below makes ten).
// The forms:
//
//   * wgmma (attn_bwd_dq_wgmma_kernel, attn_bwd_dkdv_wgmma_kernel):
//     bfloat16, dh 64 or 128, every product on the tensor cores.  A
//     producer thread streams 64-row tiles by TMA (4-D tensor maps over the
//     (B, Sq or Skv, heads, dh) layouts read in place, 64-value boxes under
//     the 128-byte swizzle, rows past Sq or Skv read as zeros; the tile's lse and D by
//     1-D bulk copies of the padded rows) through a 4-stage ring; each
//     consumer warpgroup owns 64 keys (dK/dV) or 64 query rows (dQ) and
//     runs the two score products with both operands in shared memory
//     (K-major), P and dS in float32 registers (ex2 on the SFU, masking
//     only on the diagonal tile and the Skv tail), then the accumulating
//     products with A from registers and B the streamed tile read
//     N-major.  P and dS enter those as the forward's P does, in two
//     bfloat16 pieces (the rounding and the rounding of what it left, two
//     products each): one rounding (2^-9 of each term) put dv past BWD_TOL
//     at S = 4,095, and dq and dk at S = 65, where the sum of dS's terms
//     cancels (each row's dS sums to 0).  Rows past Sq carry lse = +inf, so
//     their P is 0 with no mask; keys past Skv read as zeros in the dK/dV
//     pass and are never written.  dK/dV blocks take two warpgroups (128
//     keys) at dh 64 and one at dh 128, where dK and dV alone hold 128
//     float32 registers a thread (a 384-thread launch caps ptxas at 168).
//     dQ blocks take two (128 rows).
//   * simt (attn_bwd_dq_kernel, attn_bwd_dkdv_kernel): float32 and other
//     head widths, float32 on the CUDA cores.  Thread layout (256 threads,
//     attn_tiles.cuh): thread (ty, tx) of 16 x 16 holds the 4 x 4 score
//     entries of rows 4 ty.. and columns 4 tx.. of a 64 x 64 tile, and of a
//     64 x dh accumulator rows 4 ty.. and columns tx + 16 c.  Operands of
//     the score products are staged d-major (float4 reads without bank
//     conflicts), those of the accumulating products row-major; the 64 x 64
//     P or dS tile goes through shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The rows' pass over (B, H, Sp): D[b, h, i] = sum_d dO[b, i, h, d]
// o[b, i, h, d] into out[n + r] and lse[b, h, i] log2(e) into out[r] (the
// wgmma form's base-2 logsumexp), r = (b H + h) Sp + i, n = B H Sp; S is
// the query rows (Sq), and rows past it (i >= S, Sp > S) take D = 0 and
// lse = +inf, so that their P is 0.
// blockIdx.y is b H + h; a warp takes kRowsWarp rows, their loads in
// flight together.
constexpr int kRowsWarp = 4;
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, int64_t n, int S, int Sp,
                     int H, int dh, float* __restrict__ out) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = (static_cast<int>(blockIdx.x) * 8
                  + static_cast<int>(threadIdx.x) / 32) * kRowsWarp;
  const int lane = threadIdx.x % 32;
  float acc[kRowsWarp];
#pragma unroll
  for (int j = 0; j < kRowsWarp; ++j) {
    acc[j] = 0.f;
    if (i0 + j < S) {
      const int64_t at = ((static_cast<int64_t>(b) * S + i0 + j) * H + h)
                         * dh;
      for (int d = lane; d < dh; d += 32) {
        acc[j] = fmaf(to_f(o[at + d]), to_f(dout[at + d]), acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsWarp; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[j] += __shfl_xor_sync(~0u, acc[j], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRowsWarp; ++j) {
      const int i = i0 + j;
      if (i >= Sp) break;
      const int64_t r = static_cast<int64_t>(bh) * Sp + i;
      out[r] = i < S ? lse[static_cast<int64_t>(bh) * S + i] * kLog2e
                     : __int_as_float(0x7f800000);
      out[n + r] = acc[j];
    }
  }
}

// the rows' pass over B H rows of Sp
template <typename T>
int launch_rows(const void* o, const void* dout, const float* lse,
                int64_t B, int64_t S, int64_t Sp, int64_t H, int dh,
                float* rows, cudaStream_t st) {
  constexpr int kBlockRows = 8 * kRowsWarp;
  attn_bwd_rows_kernel<T>
      <<<dim3(static_cast<unsigned>((Sp + kBlockRows - 1) / kBlockRows),
              static_cast<unsigned>(B * H)), 256, 0, st>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout), lse,
          B * H * Sp, static_cast<int>(S), static_cast<int>(Sp),
          static_cast<int>(H), dh, rows);
  return static_cast<int>(cudaGetLastError());
}

// S = q.k^T and dP = dO.v^T for this thread's 4 x 4 entries: q and dO
// d-major over 64 rows, k and v d-major over 64 keys
template <int DHP>
__device__ __forceinline__ void score_tiles(const float* __restrict__ qs,
                                            const float* __restrict__ gs,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < DHP; ++d) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + d * kRows + ty * 4);
    const float4 gv = *reinterpret_cast<const float4*>(gs + d * kRows + ty * 4);
    const float4 kv = *reinterpret_cast<const float4*>(ks + d * kKeys + tx * 4);
    const float4 vv = *reinterpret_cast<const float4*>(vs + d * kKeys + tx * 4);
    const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
    const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
    const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
      }
    }
  }
}

// P and dS from the scores: rows q0 + 4 ty + i (of Sq), keys k0 + 4 tx + j
// (of Skv); lse and D of the tile's rows in ls and ds
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* __restrict__ ls,
                                      const float* __restrict__ ds, int q0,
                                      int k0, int ty, int tx, int Sq,
                                      int Skv, float scale, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool live = row < Sq && col < Skv && (!causal || col <= row);
      const float p = live ? expf(fmaf(s[i][j], scale, -ls[ty * 4 + i]))
                           : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - ds[ty * 4 + i]);
    }
  }
}

__device__ __forceinline__ void put_tile(float* __restrict__ ps,
                                         const float (&x)[4][4], int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPRow + tx * 4) =
        make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
  }
}

// the rows' lse and D into shared memory (0 past the S = Sq rows)
__device__ __forceinline__ void stage_rows(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int64_t base, int q0, int S,
                                           float* __restrict__ ls,
                                           float* __restrict__ ds) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int row = q0 + r;
    ls[r] = row < S ? lse[base + row] : 0.f;
    ds[r] = row < S ? delta[base + row] : 0.f;
  }
}

template <int DHP> constexpr size_t dq_smem() {
  return sizeof(float) * (5 * DHP * kRows + kRows * kPRow + 2 * kRows);
}
template <int DHP> constexpr size_t dkdv_smem() {
  return sizeof(float) * (6 * DHP * kRows + kRows * kPRow + 2 * kRows);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Sq, int Skv, int H, int Hkv, int dh, float scale,
                   int causal) {
  constexpr int kCols = DHP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // q   [DHP][kRows]
  float* gs = qs + DHP * kRows;        // dO  [DHP][kRows]
  float* ks = gs + DHP * kRows;        // k   [DHP][kKeys]
  float* vs = ks + DHP * kKeys;        // v   [DHP][kKeys]
  float* kr = vs + DHP * kKeys;        // k   [kKeys][DHP]
  float* ps = kr + DHP * kKeys;        // dS  [kRows][kPRow]
  float* ls = ps + kRows * kPRow;      // lse [kRows]
  float* ds = ls + kRows;              // D   [kRows]

  // the heaviest (last) query tiles first
  const int n_tiles = (Sq + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * q_stride
                        + static_cast<int64_t>(h) * dh;
  const int64_t kv_base = static_cast<int64_t>(b) * Skv * kv_stride
                          + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(q + q_off, q_stride, min(kRows, Sq - q0), dh, qs);
  stage<T, DHP, true>(dout + q_off, q_stride, min(kRows, Sq - q0), dh, gs);
  stage_rows(lse, delta, (static_cast<int64_t>(b) * H + h) * Sq, q0, Sq, ls,
             ds);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (Skv + kKeys - 1) / kKeys;
  const int end = causal ? min(n_kv, (q0 + kRows - 1) / kKeys + 1) : n_kv;
  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kKeys;
    const int rows = min(kKeys, Skv - k0);
    const T* kb = k + kv_base + k0 * kv_stride;
    __syncthreads();                   // the last tile's kr and ps are read
    stage<T, DHP, true>(kb, kv_stride, rows, dh, ks);
    stage<T, DHP, true>(v + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                        vs);
    stage<T, DHP, false>(kb, kv_stride, rows, dh, kr);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DHP>(qs, gs, ks, vs, ty, tx, s, dp);
    probs(s, dp, ls, ds, q0, k0, ty, tx, Sq, Skv, scale, causal);
    put_tile(ps, dp, ty, tx);
    __syncthreads();

    // dq += dS . k
#pragma unroll 2
    for (int j4 = 0; j4 < kKeys; j4 += 4) {
      float d4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + i) * kPRow + j4);
        d4[i][0] = x.x;
        d4[i][1] = x.y;
        d4[i][2] = x.z;
        d4[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = kr + (j4 + jj) * DHP + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float x = krow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(d4[i][jj], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* out = dq + (static_cast<int64_t>(b) * Sq + row) * q_stride
             + static_cast<int64_t>(h) * dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(out + col, acc[i][c] * scale);
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int dh, float scale, int causal) {
  constexpr int kCols = DHP / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // k   [DHP][kKeys]
  float* vs = ks + DHP * kKeys;        // v   [DHP][kKeys]
  float* qs = vs + DHP * kKeys;        // q   [DHP][kRows]
  float* gs = qs + DHP * kRows;        // dO  [DHP][kRows]
  float* qr = gs + DHP * kRows;        // q   [kRows][DHP]
  float* gr = qr + DHP * kRows;        // dO  [kRows][DHP]
  float* ps = gr + DHP * kRows;        // P, then dS [kRows][kPRow]
  float* ls = ps + kRows * kPRow;      // lse [kRows]
  float* ds = ls + kRows;              // D   [kRows]

  // causal: the first key tiles see the most query tiles, and go first
  const int k0 = static_cast<int>(blockIdx.x) * kKeys;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int rep = H / Hkv;
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const int64_t kv_off = (static_cast<int64_t>(b) * Skv + k0) * kv_stride
                         + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(k + kv_off, kv_stride, min(kKeys, Skv - k0), dh, ks);
  stage<T, DHP, true>(v + kv_off, kv_stride, min(kKeys, Skv - k0), dh, vs);

  float dka[4][kCols], dva[4][kCols];  // keys k0 + 4 ty + i, cols tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int n_q = (Sq + kRows - 1) / kRows;
  const int first = causal ? k0 / kRows : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kRows;
      const int rows = min(kRows, Sq - q0);
      const int64_t q_off = (static_cast<int64_t>(b) * Sq + q0) * q_stride
                            + static_cast<int64_t>(h) * dh;
      __syncthreads();                 // the last tile's operands are read
      stage<T, DHP, true>(q + q_off, q_stride, rows, dh, qs);
      stage<T, DHP, true>(dout + q_off, q_stride, rows, dh, gs);
      stage<T, DHP, false>(q + q_off, q_stride, rows, dh, qr);
      stage<T, DHP, false>(dout + q_off, q_stride, rows, dh, gr);
      stage_rows(lse, delta, (static_cast<int64_t>(b) * H + h) * Sq, q0, Sq,
                 ls, ds);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<DHP>(qs, gs, ks, vs, ty, tx, s, dp);
      probs(s, dp, ls, ds, q0, k0, ty, tx, Sq, Skv, scale, causal);
      put_tile(ps, s, ty, tx);         // P
      __syncthreads();
      // dv += P^T . dO: this thread's keys are columns 4 ty.. of P
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            ps + r * kPRow + ty * 4);
        const float pa[4] = {x.x, x.y, x.z, x.w};
        const float* grow = gr + r * DHP + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float g = grow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dva[i][c] = fmaf(pa[i], g, dva[i][c]);
        }
      }
      __syncthreads();
      put_tile(ps, dp, ty, tx);        // dS
      __syncthreads();
      // dk += dS^T . q
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            ps + r * kPRow + ty * 4);
        const float da[4] = {x.x, x.y, x.z, x.w};
        const float* qrow = qr + r * DHP + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float qv = qrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[i][c] = fmaf(da[i], qv, dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Skv) continue;
    const int64_t at = (static_cast<int64_t>(b) * Skv + key) * kv_stride
                       + static_cast<int64_t>(hk) * dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        store(dk + at + col, dka[i][c] * scale);
        store(dv + at + col, dva[i][c]);
      }
    }
  }
}

template <typename T, int DHP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* rows, void* dq,
               void* dk, void* dv, int64_t B, int64_t Sq, int64_t Skv,
               int64_t H, int64_t Hkv, int64_t dh, float scale, int causal,
               cudaStream_t st) {
  constexpr size_t dq_bytes = dq_smem<DHP>();
  constexpr size_t dkdv_bytes = dkdv_smem<DHP>();
  if (cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_dq_kernel<T, DHP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dq_bytes))) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_dkdv_kernel<T, DHP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dkdv_bytes))) {
    return static_cast<int>(e);
  }
  const auto qt = static_cast<const T*>(q);
  const auto kt = static_cast<const T*>(k);
  const auto vt = static_cast<const T*>(v);
  const auto gt = static_cast<const T*>(dout);
  // rows of (B, H, Sq): no padding
  if (int rc = launch_rows<T>(o, dout, lse, B, Sq, Sq, H,
                              static_cast<int>(dh), rows, st)) {
    return rc;
  }
  const float* delta = rows + B * H * Sq;
  const unsigned q_tiles = static_cast<unsigned>((Sq + kRows - 1) / kRows);
  const unsigned k_tiles = static_cast<unsigned>((Skv + kKeys - 1) / kKeys);
  attn_bwd_dq_kernel<T, DHP><<<dim3(q_tiles, static_cast<unsigned>(B * H)),
                               kThreads, dq_bytes, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), static_cast<int>(Sq),
      static_cast<int>(Skv), static_cast<int>(H), static_cast<int>(Hkv),
      static_cast<int>(dh), scale, causal);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, DHP>
      <<<dim3(k_tiles, static_cast<unsigned>(B * Hkv)), kThreads, dkdv_bytes,
         st>>>(qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
               static_cast<T*>(dv), static_cast<int>(Sq),
               static_cast<int>(Skv), static_cast<int>(H),
               static_cast<int>(Hkv), static_cast<int>(dh), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* rows, void* dq,
                 void* dk, void* dv, int64_t B, int64_t Sq, int64_t Skv,
                 int64_t H, int64_t Hkv, int64_t dh, float scale, int causal,
                 cudaStream_t st) {
  if (dh <= 32) {
    return launch_bwd<T, 32>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq,
                             Skv, H, Hkv, dh, scale, causal, st);
  }
  if (dh <= 64) {
    return launch_bwd<T, 64>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq,
                             Skv, H, Hkv, dh, scale, causal, st);
  }
  if (dh <= 80) {
    return launch_bwd<T, 80>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq,
                             Skv, H, Hkv, dh, scale, causal, st);
  }
  return launch_bwd<T, 128>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq,
                            Skv, H, Hkv, dh, scale, causal, st);
}

// -- bfloat16, dh 64 or 128: TMA-fed wgmma -----------------------------------
constexpr int kWT = 64;                // rows of a streamed tile (queries or
                                       // keys) and of a warpgroup's slice
constexpr int kWStages = 4;
constexpr int kPad = 128;              // the rows' pass pads Sq to this

// consumer warpgroups of a block (each owns 64 keys, or 64 query rows):
// two where a thread's accumulators fit the 168 registers of a 384-thread
// launch, else one (dK and dV at dh 128 take 128 registers a thread)
template <int DH> constexpr int kDkdvGroups = DH == 64 ? 2 : 1;
template <int DH> constexpr int kDqGroups = 2;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The 64 x 64 accumulator x (hopper.cuh's layout) as the A fragments of
// four k16 steps, in two pieces: its bfloat16 rounding (hi) and the
// rounding of what that left (lo), so that hi + lo carries about 16 bits
// of x
__device__ __forceinline__ void to_split_frags(const float (&x)[32],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * kc + 2 * i], b = x[8 * kc + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kc][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kc][i] = bf16_pair(a - __low2float(h), b - __high2float(h));
    }
  }
}

// keep A fragments live (their registers untouched) until this point: a
// wgmma in flight reads them after its instruction has issued
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kc][i]) :: "memory");
  }
}

// d (64 x DH) += a (64 x 64, four k16 fragments) . b, b a 64-row tile in
// shared memory (N-major, boxes of 64 columns `box` bytes apart)
template <int DH>
__device__ __forceinline__ void rs_tile(float (&d)[DH / 2],
                                        const uint32_t (&a)[4][4],
                                        const uint8_t* b, int box) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t bd = hopper::desc_sw128(b + 2048 * kc, box, 1024);
    if constexpr (DH == 128) {
      hopper::wgmma_rs_n128(d, a[kc], bd);
    } else {
      hopper::wgmma_rs_n64(d, a[kc], bd);
    }
  }
}

// d (64 x 64) = a (64 x DH) . b^T (b 64 x DH), both K-major in shared
// memory, boxes of 64 columns `abox` and `bbox` bytes apart
template <int DH>
__device__ __forceinline__ void ss_tile(float (&d)[32], const uint8_t* a,
                                        int abox, const uint8_t* b,
                                        int bbox) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = kk / 4, in_box = 32 * (kk % 4);
    hopper::wgmma_ss_n64<0>(
        d, hopper::desc_sw128(a + box * abox + in_box, 16, 1024),
        hopper::desc_sw128(b + box * bbox + in_box, 16, 1024), kk > 0);
  }
}

template <int DH>
constexpr size_t dkdv_wgmma_smem() {
  return 1024 + static_cast<size_t>(2 * kDkdvGroups<DH> * kWT
                                    + 2 * kWStages * kWT) * DH * 2
         + 2 * kWStages * kWT * sizeof(float)
         + (1 + 2 * kWStages) * sizeof(uint64_t);
}

template <int DH>
constexpr size_t dq_wgmma_smem() {
  return 1024 + static_cast<size_t>(2 * kDqGroups<DH> * kWT
                                    + 2 * kWStages * kWT) * DH * 2
         + 2 * kDqGroups<DH> * kWT * sizeof(float)
         + (1 + 2 * kWStages) * sizeof(uint64_t);
}

// dK and dV of a block of 64 kG keys of one (b, kv head): K and V staged
// once; a producer thread streams the group's (query head, 64-row tile)
// pairs, heads outer, each tile's Q, dO (TMA) and lse, D (bulk copies)
// through a ring; consumer warpgroup w owns keys k0 + 64 w .. and computes
// S^T = K.Q^T and dP^T = V.dO^T (wgmma, both operands K-major), P^T and
// dS^T in registers, then dV += P^T.dO and dK += dS^T.Q (wgmma, A from
// registers, B the tile N-major)
template <int DH>
__global__ void __launch_bounds__((kDkdvGroups<DH> + 1) * 128, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ rows,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                           int Sp, int H, int Hkv, int BH, float scale_log2,
                           float scale, int causal) {
  constexpr int kG = kDkdvGroups<DH>;
  constexpr int kBoxes = DH / 64;      // 64-value boxes across a head
  constexpr int kKBox = kG * kWT * 128;  // bytes of a box of K or V
  constexpr int kTBox = kWT * 128;     // bytes of a box of a Q or dO tile
  constexpr int kTile = kBoxes * kTBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1024(smem_raw);
  uint8_t* vs = ks + kBoxes * kKBox;
  uint8_t* qs = vs + kBoxes * kKBox;   // [stage][box][row]
  uint8_t* gs = qs + kWStages * kTile;
  float* ls = reinterpret_cast<float*>(gs + kWStages * kTile);  // [stage][row]
  float* ds = ls + kWStages * kWT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ds + kWStages * kWT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kWStages;

  // the first key blocks see the most query tiles: blockIdx.y is the key
  // block, so that every (b, kv head) takes its heaviest first
  const int k0 = static_cast<int>(blockIdx.y) * kG * kWT;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int n_q = (Sq + kWT - 1) / kWT;
  const int first = causal ? k0 / kWT : 0;
  const int per_head = n_q - first;
  const int items = rep * per_head;
  const int wg = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kG * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kG) {                      // producer warpgroup: one thread
    if (threadIdx.x == kG * 128) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&gmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_expect_tx(kv_full, 2 * kBoxes * kKBox);
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
        hopper::tma_load_4d(ks + j * kKBox, &kmap, kv_full, 64 * j, hk, k0,
                            b);
        hopper::tma_load_4d(vs + j * kKBox, &vmap, kv_full, 64 * j, hk, k0,
                            b);
      }
      for (int it = 0; it < items; ++it) {
        const int s = it % kWStages;
        const int h = hk * rep + it / per_head;
        const int q0 = (first + it % per_head) * kWT;
        if (it >= kWStages) {
          hopper::mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
        }
        hopper::mbar_expect_tx(&full[s], 2 * kTile + 2 * kWT * 4);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          hopper::tma_load_4d(qs + s * kTile + j * kTBox, &qmap, &full[s],
                              64 * j, h, q0, b);
          hopper::tma_load_4d(gs + s * kTile + j * kTBox, &gmap, &full[s],
                              64 * j, h, q0, b);
        }
        const float* lrow = rows + (static_cast<int64_t>(b) * H + h) * Sp
                            + q0;
        hopper::bulk_load(ls + s * kWT, lrow, kWT * 4, &full[s]);
        hopper::bulk_load(ds + s * kWT, lrow + static_cast<int64_t>(BH) * Sp,
                          kWT * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys kr and kr + 8 of this thread (the
  // accumulator's rows), query columns 8 j + cq + {0, 1} of each tile
  const int t = threadIdx.x % 128;
  const int my_k0 = k0 + wg * kWT;
  const int kr = my_k0 + (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const uint8_t* my_k = ks + wg * kWT * 128;
  const uint8_t* my_v = vs + wg * kWT * 128;
  float dka[DH / 2], dva[DH / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  hopper::mbar_wait(kv_full, 0);

  for (int it = 0; it < items; ++it) {
    const int s = it % kWStages;
    const int q0 = (first + it % per_head) * kWT;
    hopper::mbar_wait(&full[s], (it / kWStages) & 1);
    // causal: a tile wholly before this warpgroup's keys sees none of them
    if (!causal || q0 + kWT > my_k0) {
      const uint8_t* qt = qs + s * kTile;
      const uint8_t* gt = gs + s * kTile;
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      hopper::wgmma_fence();
      ss_tile<DH>(st, my_k, kKBox, qt, kTBox);
      ss_tile<DH>(dpt, my_v, kKBox, gt, kTBox);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      // P^T = 2^(S^T scale log2(e) - lse log2(e)) (0 where the query
      // precedes the key, on the diagonal tile; 0 past Sq, whose lse is
      // +inf), dS^T = P^T (dP^T - D)
      const bool diag = causal && q0 < my_k0 + kWT;
      const float* lq = ls + s * kWT;
      const float* dt = ds + s * kWT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * j + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * j + cq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lv = i % 2 ? l2.y : l2.x, dd = i % 2 ? d2.y : d2.x;
          float p = hopper::ex2(fmaf(st[4 * j + i], scale_log2, -lv));
          if (diag && q0 + 8 * j + cq + i % 2 < kr + 8 * (i / 2)) p = 0.f;
          st[4 * j + i] = p;
          dpt[4 * j + i] = p * (dpt[4 * j + i] - dd);
        }
      }
      // dS^T and P^T each in two pieces (one rounding of either put dq
      // and dk, or dv, past BWD_TOL).  dS^T is split and its products
      // issue, then P^T is split under them: each float32 tile turns into
      // its pieces as it dies (splitting both first, or dS^T under P^T's
      // products, spilled at dh 64)
      uint32_t p_hi[4][4], p_lo[4][4], s_hi[4][4], s_lo[4][4];
      to_split_frags(dpt, s_hi, s_lo);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
      rs_tile<DH>(dka, s_hi, qt, kTBox);
      rs_tile<DH>(dka, s_lo, qt, kTBox);
      hopper::wgmma_commit();
      to_split_frags(st, p_hi, p_lo);
      hopper::fence_regs(dva);
      hopper::wgmma_fence();
      rs_tile<DH>(dva, p_hi, gt, kTBox);
      rs_tile<DH>(dva, p_lo, gt, kTBox);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_frags(p_hi);
      fence_frags(p_lo);
      fence_frags(s_hi);
      fence_frags(s_lo);
      hopper::fence_regs(dka);
      hopper::fence_regs(dva);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // dk = scale dS^T.Q and dv, rounded once; keys past Skv are not written
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kr + 8 * hr;
    if (key >= Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Skv + key) * Hkv + hk) * DH
                       + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hr] * scale,
                                dka[4 * j + 2 * hr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
    }
  }
}

// dQ of a block of 64 kG query rows of one (b, h): Q, dO and the rows' lse
// and D staged once; a producer thread streams the kv head's K and V tiles
// of 64 keys (up to the diagonal when causal) through a ring; consumer
// warpgroup w owns rows q0 + 64 w .. and computes S = Q.K^T and dP = dO.V^T
// (wgmma, K-major), dS in registers, and dQ += dS.K (A from registers, B
// the K tile N-major)
template <int DH>
__global__ void __launch_bounds__((kDqGroups<DH> + 1) * 128, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ rows,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                         int Sp, int H, int Hkv, int BH, float scale_log2,
                         float scale, int causal) {
  constexpr int kG = kDqGroups<DH>;
  constexpr int kRowsB = kG * kWT;     // query rows a block
  constexpr int kBoxes = DH / 64;
  constexpr int kQBox = kRowsB * 128;  // bytes of a box of Q or dO
  constexpr int kTBox = kWT * 128;     // bytes of a box of a K or V tile
  constexpr int kTile = kBoxes * kTBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* gs = qs + kBoxes * kQBox;
  uint8_t* ks = gs + kBoxes * kQBox;   // [stage][box][key]
  uint8_t* vs = ks + kWStages * kTile;
  float* ls = reinterpret_cast<float*>(vs + kWStages * kTile);
  float* ds = ls + kRowsB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ds + kRowsB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWStages;

  // the heaviest (last) query blocks first
  const int n_tiles = (Sq + kRowsB - 1) / kRowsB;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kRowsB;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int n_kv = (Skv + kWT - 1) / kWT;
  const int end = causal ? min(n_kv, (q0 + kRowsB - 1) / kWT + 1) : n_kv;
  const int wg = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kG * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kG) {                      // producer warpgroup: one thread
    if (threadIdx.x == kG * 128) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&gmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_expect_tx(q_full, 2 * kBoxes * kQBox + 2 * kRowsB * 4);
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
        hopper::tma_load_4d(qs + j * kQBox, &qmap, q_full, 64 * j, h, q0, b);
        hopper::tma_load_4d(gs + j * kQBox, &gmap, q_full, 64 * j, h, q0, b);
      }
      const float* lrow = rows + (static_cast<int64_t>(b) * H + h) * Sp + q0;
      hopper::bulk_load(ls, lrow, kRowsB * 4, q_full);
      hopper::bulk_load(ds, lrow + static_cast<int64_t>(BH) * Sp,
                        kRowsB * 4, q_full);
      for (int kt = 0; kt < end; ++kt) {
        const int s = kt % kWStages;
        if (kt >= kWStages) {
          hopper::mbar_wait(&empty[s], ((kt / kWStages) & 1) ^ 1);
        }
        hopper::mbar_expect_tx(&full[s], 2 * kTile);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          hopper::tma_load_4d(ks + s * kTile + j * kTBox, &kmap, &full[s],
                              64 * j, hk, kt * kWT, b);
          hopper::tma_load_4d(vs + s * kTile + j * kTBox, &vmap, &full[s],
                              64 * j, hk, kt * kWT, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows r0 and r0 + 8 of this thread, keys 8 j +
  // cq + {0, 1} of each tile
  const int t = threadIdx.x % 128;
  const int my_q0 = q0 + wg * kWT;
  const int r0 = my_q0 + (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const uint8_t* my_q = qs + wg * kWT * 128;
  const uint8_t* my_g = gs + wg * kWT * 128;
  float acc[DH / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(q_full, 0);
  const float lr[2] = {ls[r0 - q0], ls[r0 + 8 - q0]};
  const float dr[2] = {ds[r0 - q0], ds[r0 + 8 - q0]};

  for (int kt = 0; kt < end; ++kt) {
    const int s = kt % kWStages;
    const int k0 = kt * kWT;
    hopper::mbar_wait(&full[s], (kt / kWStages) & 1);
    // causal: a tile wholly after this warpgroup's rows is masked
    if (!causal || k0 < my_q0 + kWT) {
      const uint8_t* ktile = ks + s * kTile;
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      ss_tile<DH>(sc, my_q, kQBox, ktile, kTBox);
      ss_tile<DH>(dp, my_g, kQBox, vs + s * kTile, kTBox);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      // P = 2^(S scale log2(e) - lse log2(e)), 0 past Skv and, on the
      // diagonal, where the key follows the row; dS = P (dP - D)
      const bool edge = k0 + kWT > Skv || (causal && k0 + kWT > my_q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * j + cq + i % 2;
          float p = hopper::ex2(fmaf(sc[4 * j + i], scale_log2, -lr[i / 2]));
          if (edge && (col >= Skv || (causal && col > r0 + 8 * (i / 2)))) {
            p = 0.f;
          }
          dp[4 * j + i] = p * (dp[4 * j + i] - dr[i / 2]);
        }
      }
      // dS in two pieces (one rounding put dq past BWD_TOL)
      uint32_t s_hi[4][4], s_lo[4][4];
      to_split_frags(dp, s_hi, s_lo);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      rs_tile<DH>(acc, s_hi, ktile, kTBox);
      rs_tile<DH>(acc, s_lo, ktile, kTBox);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_frags(s_hi);
      fence_frags(s_lo);
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  // dq = scale dS.K, rounded once; rows past Sq are not written
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Sq) continue;
    __nv_bfloat16* out =
        dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr] * scale,
                                acc[4 * j + 2 * hr + 1] * scale);
    }
  }
}

// bfloat16 tensor maps over (B, S, heads, DH) (S the query rows Sq or the
// keys Skv), boxes of 64 values by `box` rows, 128-byte swizzle; rows past
// S read as zeros
template <int DH>
int head_map(CUtensorMap* map, const void* base, int64_t B, int64_t S,
             int64_t heads, uint32_t box) {
  const uint64_t e = 2;
  const uint64_t dims[4] = {DH, static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t str[3] = {DH * e, heads * DH * e, S * heads * DH * e};
  const uint32_t boxes[4] = {64, 1, box, 1};
  return hopper::make_map(map, base, 4, dims, str, boxes, true);
}

template <int DH>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* rows, void* dq, void* dk, void* dv, int64_t B,
                     int64_t Sq, int64_t Skv, int64_t H, int64_t Hkv,
                     float scale, int causal, cudaStream_t st) {
  constexpr int kKeys = kDkdvGroups<DH> * kWT;
  constexpr int kRowsB = kDqGroups<DH> * kWT;
  const int64_t Sp = (Sq + kPad - 1) / kPad * kPad;
  CUtensorMap q_tile, g_tile, k_block, v_block, q_block, g_block, k_tile,
      v_tile;
  if (int rc = head_map<DH>(&q_tile, q, B, Sq, H, kWT)) return rc;
  if (int rc = head_map<DH>(&g_tile, dout, B, Sq, H, kWT)) return rc;
  if (int rc = head_map<DH>(&k_block, k, B, Skv, Hkv, kKeys)) return rc;
  if (int rc = head_map<DH>(&v_block, v, B, Skv, Hkv, kKeys)) return rc;
  if (int rc = head_map<DH>(&q_block, q, B, Sq, H, kRowsB)) return rc;
  if (int rc = head_map<DH>(&g_block, dout, B, Sq, H, kRowsB)) return rc;
  if (int rc = head_map<DH>(&k_tile, k, B, Skv, Hkv, kWT)) return rc;
  if (int rc = head_map<DH>(&v_tile, v, B, Skv, Hkv, kWT)) return rc;
  constexpr size_t dkdv_bytes = dkdv_wgmma_smem<DH>();
  constexpr size_t dq_bytes = dq_wgmma_smem<DH>();
  if (cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_dkdv_wgmma_kernel<DH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dkdv_bytes))) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_dq_wgmma_kernel<DH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dq_bytes))) {
    return static_cast<int>(e);
  }
  if (int rc = launch_rows<__nv_bfloat16>(o, dout, lse, B, Sq, Sp, H, DH,
                                          rows, st)) {
    return rc;
  }
  const float scale_log2 = scale * kLog2e;
  attn_bwd_dq_wgmma_kernel<DH>
      <<<dim3(static_cast<unsigned>(B * H),
              static_cast<unsigned>((Sq + kRowsB - 1) / kRowsB)),
         (kDqGroups<DH> + 1) * 128, dq_bytes, st>>>(
          q_block, g_block, k_tile, v_tile, rows,
          static_cast<__nv_bfloat16*>(dq), static_cast<int>(Sq),
          static_cast<int>(Skv), static_cast<int>(Sp), static_cast<int>(H),
          static_cast<int>(Hkv), static_cast<int>(B * H), scale_log2, scale,
          causal);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  attn_bwd_dkdv_wgmma_kernel<DH>
      <<<dim3(static_cast<unsigned>(B * Hkv),
              static_cast<unsigned>((Skv + kKeys - 1) / kKeys)),
         (kDkdvGroups<DH> + 1) * 128, dkdv_bytes, st>>>(
          q_tile, g_tile, k_block, v_block, rows,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(Sp),
          static_cast<int>(H), static_cast<int>(Hkv), static_cast<int>(B * H),
          scale_log2, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients).
// form (kernels/flash_attention.py's `form`, as the forward's): 0 = the
// CUDA-core kernels, any dtype and dh; 1 = the wgmma kernels, bfloat16 with
// dh 64 or 128.  lse: the forward's (B, H, Sq) float32 logsumexp; rows:
// float32 scratch of 2 B H Sp, Sp = Sq for form 0 and Sq rounded up to 128
// for form 1 (bwd_rows in the wrapper).  Needs contiguous tensors on
// 16-byte boundaries, 0 < dh <= 128 with dh a multiple of 8, H a multiple
// of Hkv, B * H <= 65535, Sq and Skv < 2^31, and Sq == Skv where causal
// (the wrapper checks; a causal launch with Sq != Skv is refused).
int attn_flash_attention_bwd(int device, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, int64_t B, int64_t Sq,
                             int64_t Skv, int64_t H, int64_t Hkv, int64_t dh,
                             float scale, int causal, int dtype, int form,
                             void* rows, void* dq, void* dk, void* dv,
                             void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
      || dh < 1 || dh > 128 || dh % 8 != 0 || B * H > 65535
      || Sq > 0x7fffffff || Skv > 0x7fffffff || (causal && Sq != Skv)
      || (dtype != 0 && dtype != 1) || (form != 0 && form != 1)
      || (form == 1 && (dtype != 1 || (dh != 64 && dh != 128)
                        || (Sq + kWT - 1) / kWT > 65535
                        || (Skv + kWT - 1) / kWT > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto r = static_cast<float*>(rows);
  if (form == 1) {
    return dh == 64 ? launch_bwd_wgmma<64>(q, k, v, o, dout, l, r, dq, dk,
                                           dv, B, Sq, Skv, H, Hkv, scale,
                                           causal, st)
                    : launch_bwd_wgmma<128>(q, k, v, o, dout, l, r, dq, dk,
                                            dv, B, Sq, Skv, H, Hkv, scale,
                                            causal, st);
  }
  if (dtype == 0) {
    return dispatch_bwd<float>(q, k, v, o, dout, l, r, dq, dk, dv, B, Sq,
                               Skv, H, Hkv, dh, scale, causal, st);
  }
  return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, l, r, dq, dk, dv, B,
                                     Sq, Skv, H, Hkv, dh, scale, causal, st);
}

}  // extern "C"
