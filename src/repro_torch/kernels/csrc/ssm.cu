// Hopper (sm_90a) kernel of the Mamba mixer (jamba): the selective scan
// that follows the mixer's three products.  It replaces no Pallas kernel:
// the JAX package scans with jax.lax.associative_scan inside chunks of 128
// steps (src/repro/models/mamba.py:46) and lax.scan over the chunks.
//
// Launcher with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py): device index, raw device pointers,
// sizes, the dtype flag of x and out (0 = float32, 1 = bfloat16) and a
// cudaStream_t; allocates nothing and returns cudaGetLastError():
//
//   ssm_scan   for each batch row b, channel c and step t, in float32:
//                dt  = softplus(dt_pre[b, t, c] + dt_bias[c])
//                h_n = exp(dt A[c, n]) h_n + dt x[b, t, c] B[b, t, n]
//                out[b, t, c] = sum_n h_n C[b, t, n] + D[c] x[b, t, c]
//              with A = -exp(A_log), h from h0 (or zeros); writes out (x's
//              dtype) and the last h (B, di, kDs) float32
//
// softplus is JAX's logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|)).
//
// Bound: the exponentials, kDs decays and the softplus's one a (b, t, c),
// on the SFUs (16 an SM a clock); the bytes (x, dt_pre and out, 8 a
// (b, t, c) in bfloat16) come close behind.  Design: a thread a (b, c)
// keeps its kDs states, A and D in registers for the whole scan, so h
// never leaves the SM; a block takes kChannels channels of one batch row
// (grid: di / kChannels x B, 512 blocks of 4 warps at jamba's prefill,
// one wave of 4 blocks an SM).  The steps run in tiles of kTile through
// two shared-memory buffers: while a tile runs, the block's cp.async
// copies (16-byte pieces spread over the threads) bring the next tile's
// x and dt_pre columns and B and C rows; two barriers a tile.  A tile
// first takes its kTile softplus values (independent of one another and
// of h), then the steps.  The decays are 2^(dt A log2 e), A log2 e kept
// per state: one multiply and one SFU ex2.approx.ftz each (2 ulp; a decay
// below 2^-126 flushes to 0), where expf adds its range reduction and
// exp2f a denormal test and two scalings to every one; the softplus takes
// expf and log1pf.  The decays do not depend on h, so the chain a step is
// kDs multiply-adds.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDs = 16;          // states a channel (ssm_scan.DS)
constexpr int kChannels = 128;   // channels (threads) a block
constexpr int kTile = 16;        // steps a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^x on the SFU, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch does
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const auto at = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(at), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One tile of the block's inputs: x and dt_pre for its kChannels
// channels, B and C (kDs each), for kTile steps.
template <typename T>
struct __align__(16) Tile {
  T x[kTile][kChannels];
  float dt[kTile][kChannels];
  float bc[kTile][2 * kDs];            // [step][B | C]
};

// The copies of the tile of steps t0 .. t0 + kTile - 1 (those below S;
// channels from c0, those below di) into `tile`, as 16-byte pieces spread
// over the block's threads; di is a multiple of 8, so a piece of x (8
// bfloat16 or 4 float32 channels) or dt_pre (4) lies wholly in or out.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& tile, const T* x,
                                          const float* dt_pre,
                                          const float* bm, const float* cm,
                                          int64_t row0, int64_t t0, int64_t S,
                                          int64_t c0, int64_t di, int tid) {
  constexpr int kXEach = 16 / sizeof(T), kXPieces = kChannels / kXEach;
  constexpr int kDPieces = kChannels / 4;
#pragma unroll
  for (int i = tid; i < kTile * kXPieces; i += kChannels) {
    const int k = i / kXPieces, q = i % kXPieces;
    const int64_t t = t0 + k, ch = c0 + q * kXEach;
    if (t < S && ch < di) {
      cp_async16(&tile.x[k][q * kXEach], x + (row0 + t) * di + ch);
    }
  }
#pragma unroll
  for (int i = tid; i < kTile * kDPieces; i += kChannels) {
    const int k = i / kDPieces, q = i % kDPieces;
    const int64_t t = t0 + k, ch = c0 + q * 4;
    if (t < S && ch < di) {
      cp_async16(&tile.dt[k][q * 4], dt_pre + (row0 + t) * di + ch);
    }
  }
  if (tid < kTile * 8) {                 // 8 pieces a step: 4 of B, 4 of C
    const int k = tid / 8, q = tid % 8;
    const int64_t t = t0 + k;
    if (t < S) {
      cp_async16(&tile.bc[k][q * 4],
                 (q < 4 ? bm : cm) + (row0 + t) * kDs + (q % 4) * 4);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kChannels, 4)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt_pre,
                const float* __restrict__ dt_bias,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ d_skip,
                const float* __restrict__ h0, int64_t S, int64_t di,
                T* __restrict__ out, float* __restrict__ h_last) {
  __shared__ Tile<T> tiles[2];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t c = c0 + tid;
  const bool live = c < di;
  const int64_t row0 = b * S;                 // (b, 0) as a row of (B, S)

  load_tile(tiles[0], x, dt_pre, bm, cm, row0, 0, S, c0, di, tid);
  cp_commit();

  float a[kDs], h[kDs];
  float bias = 0.f, dskip = 0.f;
#pragma unroll
  for (int n = 0; n < kDs; ++n) {
    a[n] = live ? -expf(a_log[c * kDs + n]) * kLog2e : 0.f;   // A log2 e
    h[n] = live && h0 != nullptr ? h0[(b * di + c) * kDs + n] : 0.f;
  }
  if (live) {
    bias = dt_bias[c];
    dskip = d_skip[c];
  }

  for (int64_t t0 = 0, j = 0; t0 < S; t0 += kTile, ++j) {
    const Tile<T>& cur = tiles[j & 1];
    if (t0 + kTile < S) {
      load_tile(tiles[(j + 1) & 1], x, dt_pre, bm, cm, row0, t0 + kTile, S,
                c0, di, tid);
    }
    cp_commit();
    cp_wait<1>();                    // this thread's copies of tile j
    __syncthreads();                 // everyone's
    const int64_t steps = S - t0 < kTile ? S - t0 : kTile;
    float dt[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float v = cur.dt[k][tid] + bias;
      dt[k] = k < steps ? fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k < steps) {
        const float xv = to_float(cur.x[k][tid]);
        const float dtx = dt[k] * xv;
        const float* brow = cur.bc[k];
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < kDs; ++n) {
          const float decay = ex2(dt[k] * a[n]);
          h[n] = fmaf(decay, h[n], dtx * brow[n]);
          y = fmaf(h[n], brow[kDs + n], y);
        }
        if (live) {
          out[(row0 + t0 + k) * di + c] = from_float<T>(fmaf(dskip, xv, y));
        }
      }
    }
    __syncthreads();                 // tile j read: its buffer is free
  }
  if (live) {
    float4* hp = reinterpret_cast<float4*>(h_last + (b * di + c) * kDs);
#pragma unroll
    for (int q = 0; q < kDs / 4; ++q) {
      hp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  }
}

template <typename T>
int launch_scan(const void* x, const float* dt_pre, const float* dt_bias,
                const float* bm, const float* cm, const float* a_log,
                const float* d_skip, const float* h0, int64_t B, int64_t S,
                int64_t di, void* out, float* h_last, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  ssm_scan_kernel<T><<<grid, kChannels, 0, st>>>(
      static_cast<const T*>(x), dt_pre, dt_bias, bm, cm, a_log, d_skip, h0,
      S, di, static_cast<T*>(out), h_last);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, S, di) in the dtype flag's type, dt_pre (B, S, di), bm and cm
// (B, S, ds), a_log (di, ds), dt_bias and d_skip (di), h0 (B, di, ds) or
// null: float32, contiguous, on 16-byte boundaries, di a multiple of 8;
// out like x, h_last (B, di, ds) float32.  ds must be kDs.
int ssm_scan(int device, const void* x, const void* dt_pre,
             const void* dt_bias, const void* bm, const void* cm,
             const void* a_log, const void* d_skip, const void* h0,
             int64_t B, int64_t S, int64_t di, int64_t ds, int dtype,
             void* out, void* h_last, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (ds != kDs || B < 1 || B > 65535 || S < 0 || di < 1 || di % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto hl = static_cast<float*>(h_last);
  if (dtype == 0) {
    return launch_scan<float>(x, f(dt_pre), f(dt_bias), f(bm), f(cm),
                              f(a_log), f(d_skip), f(h0), B, S, di, out, hl,
                              st);
  }
  if (dtype == 1) {
    return launch_scan<__nv_bfloat16>(x, f(dt_pre), f(dt_bias), f(bm), f(cm),
                                      f(a_log), f(d_skip), f(h0), B, S, di,
                                      out, hl, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
