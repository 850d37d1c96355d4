// What the Mamba scan's two kernels share (ssm.cu, the forward; ssm_bwd.cu,
// its gradient): the state size they are built for, the spacing of the
// states the forward saves for the backward, and the device helpers.
//
// The saved states ("checkpoints"): where autograd records, the forward
// writes h as it enters every kChunk-th step, ckpt (B, ceil(S / kChunk),
// di, kDs) float32, ckpt[b, j] the state before step j kChunk (h0, or
// zeros, for j = 0).  The backward restarts each chunk's recurrence from
// its entry and keeps the chunk's states in registers, which a spacing of
// 8 lets fit (16 steps of a thread's 16 pairs would not).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssm {

constexpr int kDs = 16;            // states a channel (ssm_scan.DS)
constexpr int kChunk = 8;          // steps between saved states (CHUNK)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch does
}

// 2^x on the SFU, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(-|v|), one multiply and one SFU ex2
__device__ __forceinline__ float exp_neg_abs(float v) {
  return ex2(-fabsf(v) * kLog2e);
}

// JAX's softplus, logaddexp(v, 0): max(v, 0) + log1p(e), e = exp(-|v|)
// in (0, 1].  log1p(e) = e q(e), q a degree-8 polynomial fitted to
// log1p(e) / e on [0, 1] (Chebyshev least squares; within 2.6e-7 of
// log1p relative, in float32): 8 multiply-adds, where log1pf takes some
// 30 instructions and a branch, which the scans, bound by issue, pay
// once a (b, t, channel).
__device__ __forceinline__ float softplus_of(float v, float e) {
  float q = 0.0051859976f;
  q = fmaf(q, e, -0.029210234f);
  q = fmaf(q, e, 0.07754031f);
  q = fmaf(q, e, -0.13583934f);
  q = fmaf(q, e, 0.1905595f);
  q = fmaf(q, e, -0.24825647f);
  q = fmaf(q, e, 0.3331601f);
  q = fmaf(q, e, -0.49999255f);
  q = fmaf(q, e, 0.99999994f);
  return fmaf(e, q, fmaxf(v, 0.f));
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

// The 16-byte copies of a tile's rows of one (B, S, di) tensor into dst
// (kRows x kWidth, row-major in shared memory): steps t0 ..
// t0 + rows - 1 (those below S), channels c0 .. c0 + width - 1 (those below
// di, a multiple of 8, so a piece of 8 bfloat16 or 4 float32 channels lies
// wholly in or out), spread over `threads` threads from `tid`.
template <int kRows, int kWidth, int kThreads, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          int64_t row0, int64_t t0,
                                          int64_t S, int64_t c0, int64_t di,
                                          int tid) {
  constexpr int kEach = 16 / sizeof(T), kPieces = kWidth / kEach;
  static_assert(kWidth % kEach == 0, "rows of whole 16-byte pieces");
#pragma unroll
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int k = i / kPieces, q = i % kPieces;
    const int64_t t = t0 + k, ch = c0 + q * kEach;
    if (t < S && ch < di) {
      cp_async16(dst + k * kWidth + q * kEach, src + (row0 + t) * di + ch);
    }
  }
}

// The B and C rows of steps t0 .. t0 + rows - 1 into bc[k] = [B | C]: 8
// pieces a step.
template <int kRows, int kThreads>
__device__ __forceinline__ void copy_bc(float (*bc)[2 * kDs], const float* bm,
                                        const float* cm, int64_t row0,
                                        int64_t t0, int64_t S, int tid) {
#pragma unroll
  for (int i = tid; i < kRows * 8; i += kThreads) {
    const int k = i / 8, q = i % 8;
    const int64_t t = t0 + k;
    if (t < S) {
      cp_async16(&bc[k][q * 4],
                 (q < 4 ? bm : cm) + (row0 + t) * kDs + (q % 4) * 4);
    }
  }
}

// A tile's rows from shared memory into a (B, S, di) tensor as 16-byte
// stores (the same pieces as copy_rows).
template <int kRows, int kWidth, int kThreads, typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* src,
                                           int64_t row0, int64_t t0,
                                           int64_t S, int64_t c0, int64_t di,
                                           int tid) {
  constexpr int kEach = 16 / sizeof(T), kPieces = kWidth / kEach;
#pragma unroll
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int k = i / kPieces, q = i % kPieces;
    const int64_t t = t0 + k, ch = c0 + q * kEach;
    if (t < S && ch < di) {
      *reinterpret_cast<uint4*>(dst + (row0 + t) * di + ch) =
          *reinterpret_cast<const uint4*>(src + k * kWidth + q * kEach);
    }
  }
}

}  // namespace ssm
