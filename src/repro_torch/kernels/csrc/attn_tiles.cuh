// Tiles of the attention kernels' CUDA-core forms (attn.cu's
// flash_attention_kernel and attn_bwd.cu's backward): 64 query rows or keys
// a tile, staged into shared memory as float32 by 256 threads (16 row groups
// x 16 column groups).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;              // query rows per block
constexpr int kKeys = 64;              // keys per kv tile
constexpr int kThreads = 256;          // 16 x 16 thread groups
constexpr int kPRow = kKeys + 4;       // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float* x = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = x[i];
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(x[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch does
}

// Stage up to kRows rows of dh values (16-byte vectors; row r at
// src + r * stride) into shared memory as float32, zeros past `rows` and
// past dh.  d-major: dst[d * kRows + r], neighbouring threads on
// neighbouring rows; row-major: dst[r * DHP + d].
template <typename T, int DHP, bool kDMajor>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      int64_t stride, int rows, int dh,
                                      float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = DHP / kVec;
  for (int it = threadIdx.x; it < kRows * kVecs; it += kThreads) {
    const int r = kDMajor ? it % kRows : it / kVecs;
    const int d0 = (kDMajor ? it / kRows : it % kVecs) * kVec;
    float x[kVec];
    if (r < rows && d0 < dh) {
      unpack(__ldg(reinterpret_cast<const uint4*>(src + r * stride + d0)),
             x, T());
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
    if constexpr (kDMajor) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[(d0 + i) * kRows + r] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(dst + r * DHP + d0 + i) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
    }
  }
}

}  // namespace
