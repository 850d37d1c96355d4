// Hopper (sm_90a) backward of the model substrate's attention (attn.cu):
// the gradients of causal or non-causal grouped-query attention,
//
//   q (B, S, H, dh), k, v (B, S, Hkv, dh), o and dO (B, S, H, dh), lse
//   (B, H, S) float32 (the forward's per-row logsumexp of the scaled
//   scores)  ->  dq (B, S, H, dh), dk and dv (B, S, Hkv, dh) in q's dtype
//
// with P = exp(q.k^T scale - lse) (masked scores: causal j > i, and keys or
// rows past S, give 0), D = rowsum(dO o), dS = P (dO.v^T - D):
//
//   dv = P^T dO,  dq = scale dS k,  dk = scale dS^T q,
//
// dk and dv summed over the H / Hkv query heads that read each kv head.
// Everything is float32 on the CUDA cores; each output is rounded once to
// the input's dtype.  No atomics: every sum runs in a fixed order, so two
// launches give the same bits.  One launcher with a plain C interface
// (loaded with ctypes by src/repro_torch/kernels/_build.py), three kernels
// on the given stream:
//
//   1. attn_bwd_delta_kernel: D for every (b, h, row), a warp a row.
//   2. attn_bwd_dq_kernel: one block per (b, h, 64-row query tile); walks
//      the key tiles up to the diagonal, recomputing S = q.k^T and
//      dP = dO.v^T, then dS, and adds dS.k into registers.
//   3. attn_bwd_dkdv_kernel: one block per (b, kv head, 64-key tile), K and
//      V staged once; walks the query tiles from the diagonal on, for each
//      of the group's query heads, recomputing S and dP, and adds P^T.dO
//      and dS^T.q into registers.  Summing the group inside the block needs
//      no atomics.
//
// The JAX package has no backward kernel: it trains through jnp attention
// (src/repro/models/attention.py:77-162), whose gradient XLA derives; this
// is the gradient of the port's forward kernel, which replaces the Pallas
// `_kernel` of src/repro/kernels/flash_attention.py:25.  Bound: operations,
// the five products 10 B H S^2 dh (halved when causal) against the bytes of
// q, k, v, o, dO and the three gradients; this first form recomputes S and
// dP in both passes (seven products) on the CUDA cores, float32, so it sits
// far above that bound: mma.sync or wgmma tiles are later work.
//
// Thread layout (256 threads, attn_tiles.cuh): thread (ty, tx) of 16 x 16
// holds the 4 x 4 score entries of rows 4 ty.. and columns 4 tx.. of a
// 64 x 64 tile, and of a 64 x dh accumulator rows 4 ty.. and columns
// tx + 16 c.  Operands of the score products are staged d-major (float4
// reads without bank conflicts), those of the accumulating products
// row-major; the 64 x 64 P or dS tile goes through shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]: a warp a (b, i, h) row
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      int64_t rows, int S, int H, int dh,
                      float* __restrict__ delta) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* orow = o + r * dh;
  const T* grow = dout + r * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) {
    acc = fmaf(to_f(orow[d]), to_f(grow[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(~0u, acc, off);
  }
  if (lane == 0) {                     // r = (b S + i) H + h
    const int64_t h = r % H, bi = r / H;
    delta[(bi / S * H + h) * S + bi % S] = acc;
  }
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

// P and dS from the scores: rows q0 + 4 ty + i, keys k0 + 4 tx + j; lse and
// D of the tile's rows in ls and ds
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* __restrict__ ls,
                                      const float* __restrict__ ds, int q0,
                                      int k0, int ty, int tx, int S,
                                      float scale, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool live = row < S && col < S && (!causal || col <= row);
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

// the rows' lse and D into shared memory (0 past S)
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
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int H, int Hkv, int dh, float scale, int causal) {
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
  const int n_tiles = (S + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const int64_t q_off = (static_cast<int64_t>(b) * S + q0) * q_stride
                        + static_cast<int64_t>(h) * dh;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride
                          + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(q + q_off, q_stride, min(kRows, S - q0), dh, qs);
  stage<T, DHP, true>(dout + q_off, q_stride, min(kRows, S - q0), dh, gs);
  stage_rows(lse, delta, (static_cast<int64_t>(b) * H + h) * S, q0, S, ls,
             ds);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (S + kKeys - 1) / kKeys;
  const int end = causal ? min(n_kv, (q0 + kRows - 1) / kKeys + 1) : n_kv;
  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kKeys;
    const int rows = min(kKeys, S - k0);
    const T* kb = k + kv_base + k0 * kv_stride;
    __syncthreads();                   // the last tile's kr and ps are read
    stage<T, DHP, true>(kb, kv_stride, rows, dh, ks);
    stage<T, DHP, true>(v + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                        vs);
    stage<T, DHP, false>(kb, kv_stride, rows, dh, kr);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DHP>(qs, gs, ks, vs, ty, tx, s, dp);
    probs(s, dp, ls, ds, q0, k0, ty, tx, S, scale, causal);
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
    if (row >= S) continue;
    T* out = dq + (static_cast<int64_t>(b) * S + row) * q_stride
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
                     T* __restrict__ dv, int S, int H, int Hkv, int dh,
                     float scale, int causal) {
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
  const int64_t kv_off = (static_cast<int64_t>(b) * S + k0) * kv_stride
                         + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(k + kv_off, kv_stride, min(kKeys, S - k0), dh, ks);
  stage<T, DHP, true>(v + kv_off, kv_stride, min(kKeys, S - k0), dh, vs);

  float dka[4][kCols], dva[4][kCols];  // keys k0 + 4 ty + i, cols tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int n_q = (S + kRows - 1) / kRows;
  const int first = causal ? k0 / kRows : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kRows;
      const int rows = min(kRows, S - q0);
      const int64_t q_off = (static_cast<int64_t>(b) * S + q0) * q_stride
                            + static_cast<int64_t>(h) * dh;
      __syncthreads();                 // the last tile's operands are read
      stage<T, DHP, true>(q + q_off, q_stride, rows, dh, qs);
      stage<T, DHP, true>(dout + q_off, q_stride, rows, dh, gs);
      stage<T, DHP, false>(q + q_off, q_stride, rows, dh, qr);
      stage<T, DHP, false>(dout + q_off, q_stride, rows, dh, gr);
      stage_rows(lse, delta, (static_cast<int64_t>(b) * H + h) * S, q0, S,
                 ls, ds);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<DHP>(qs, gs, ks, vs, ty, tx, s, dp);
      probs(s, dp, ls, ds, q0, k0, ty, tx, S, scale, causal);
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
    if (key >= S) continue;
    const int64_t at = (static_cast<int64_t>(b) * S + key) * kv_stride
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
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int64_t B, int64_t S, int64_t H,
               int64_t Hkv, int64_t dh, float scale, int causal,
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
  const int64_t rows = B * S * H;
  attn_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             st>>>(static_cast<const T*>(o), gt, rows,
                                   static_cast<int>(S), static_cast<int>(H),
                                   static_cast<int>(dh), delta);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const unsigned tiles = static_cast<unsigned>((S + kRows - 1) / kRows);
  attn_bwd_dq_kernel<T, DHP><<<dim3(tiles, static_cast<unsigned>(B * H)),
                               kThreads, dq_bytes, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(Hkv), static_cast<int>(dh),
      scale, causal);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, DHP><<<dim3(tiles, static_cast<unsigned>(B * Hkv)),
                                 kThreads, dkdv_bytes, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(Hkv),
      static_cast<int>(dh), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int64_t B, int64_t S, int64_t H,
                 int64_t Hkv, int64_t dh, float scale, int causal,
                 cudaStream_t st) {
  if (dh <= 32) {
    return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             H, Hkv, dh, scale, causal, st);
  }
  if (dh <= 64) {
    return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             H, Hkv, dh, scale, causal, st);
  }
  if (dh <= 80) {
    return launch_bwd<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             H, Hkv, dh, scale, causal, st);
  }
  return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                            H, Hkv, dh, scale, causal, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients).
// lse: the forward's (B, H, S) float32 logsumexp; delta: (B, H, S) float32
// scratch.  Needs contiguous tensors on 16-byte boundaries, 0 < dh <= 128
// with dh a multiple of 8, H a multiple of Hkv, B * H <= 65535 and S <
// 2^31 (the wrapper checks).
int attn_flash_attention_bwd(int device, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, int64_t B, int64_t S,
                             int64_t H, int64_t Hkv, int64_t dh, float scale,
                             int causal, int dtype, void* delta, void* dq,
                             void* dk, void* dv, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || dh < 1
      || dh > 128 || dh % 8 != 0 || B * H > 65535 || S > 0x7fffffff
      || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto d = static_cast<float*>(delta);
  if (dtype == 0) {
    return dispatch_bwd<float>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H,
                               Hkv, dh, scale, causal, st);
  }
  return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, l, d, dq, dk, dv, B, S,
                                     H, Hkv, dh, scale, causal, st);
}

}  // extern "C"
