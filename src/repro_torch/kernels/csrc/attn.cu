// Hopper (sm_90a) kernel of the model substrate's prefill: causal or
// non-causal attention with an online softmax and grouped-query heads.
//
//   q (B, S, H, dh), k and v (B, S, Hkv, dh), row-major, float32 or
//   bfloat16 (dtype flag 0 or 1)  ->  o (B, S, H, dh) in q's dtype
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, hk] * scale) v[b, j, hk]
//
// with hk = h / (H / Hkv), scores and sums in float32, masked scores set to
// -1e30 (causal: j > i) and the result divided by max(l, 1e-30), as
// ref.flash_attention_ref computes it.  One launcher with a plain C
// interface (loaded with ctypes by src/repro_torch/kernels/_build.py); it
// takes the device index, raw device pointers, the sizes, the scale, the
// causal and dtype flags and a cudaStream_t, allocates nothing and returns
// cudaGetLastError().
//
// Replaces the Pallas `_kernel` of src/repro/kernels/flash_attention.py:25
// (`pallas_call` at :87).  That grid ran its kv axis in order on one core
// and carried the softmax state in VMEM scratch; here one thread block owns
// one (64-row query tile, batch x head) and walks the kv tiles itself,
// skipping the causal tiles past the diagonal.  Bound: operations, 4 B H
// S^2 dh (halved when causal) against the bytes of q, k, v and o.  This
// first form computes in float32 on the CUDA cores (67 TFLOP/s on an H100,
// not the 989 of the bf16 tensor cores): `wgmma`, TMA and warp
// specialisation are later work.
//
// Layout: 256 threads as 16 row groups x 16 column groups.  Thread (ty, tx)
// holds scores for rows 4ty..4ty+3 and keys 4tx..4tx+3 of the tile, and
// output columns tx + 16c.  Q and K are staged d-major (q[d][row]), so
// the Q.K^T loop reads one float4 of each per d without bank conflicts;
// V is staged row-major.  The probabilities go through shared memory
// (over K's tile, once the scores are computed) to the P.V product.  The
// kv head is read in place from the (B, S, Hkv, dh) layout: no repeat, no
// transposed copy.  Tiles past S and columns past dh are staged as zeros,
// and keys past S are masked, so any S works.

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

// Floats of shared memory: q (d-major), k (d-major; later the
// probabilities), v (row-major).
template <int DHP> constexpr int k_floats() {
  return DHP * kKeys > kRows * kPRow ? DHP * kKeys : kRows * kPRow;
}
template <int DHP> constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DHP * kRows + k_floats<DHP>());
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// DHP: dh padded up to one of the instantiated widths (a multiple of 16
// and of the 16-byte vector).
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int Hkv, int dh, float scale, int causal) {
  constexpr int kCols = DHP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [DHP][kRows]
  float* vs = qs + DHP * kRows;        // [kKeys][DHP]
  float* ks = vs + DHP * kKeys;        // [DHP][kKeys], then ps
  float* ps = ks;                      // [kRows][kPRow]

  const int n_tiles = (S + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const T* qb = q + (static_cast<int64_t>(b) * S + q0) * q_stride
                + static_cast<int64_t>(h) * dh;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_stride
                          + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(qb, q_stride, min(kRows, S - q0), dh, qs);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: the tiles up to the one holding the block's last row
  const int n_kv = (S + kKeys - 1) / kKeys;
  const int end = causal ? min(n_kv, (q0 + kRows - 1) / kKeys + 1) : n_kv;
  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kKeys;
    const int rows = min(kKeys, S - k0);
    __syncthreads();                   // the last tile's ps and vs are read
    stage<T, DHP, true>(k + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                        ks);
    stage<T, DHP, false>(v + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                         vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kRows
                                                         + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kKeys
                                                         + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

    // online softmax, one row per 16-lane group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = col < S && (!causal || col <= row);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = col < S && (!causal || col <= row);
        s[i][j] = live ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                   // every thread is done with ks
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPRow + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j4 = 0; j4 < kKeys; j4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + i) * kPRow + j4);
        p[i][0] = pr.x;
        p[i][1] = pr.y;
        p[i][2] = pr.z;
        p[i][3] = pr.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j4 + jj) * DHP + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float x = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i][jj], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(b) * S + row) * q_stride
              + static_cast<int64_t>(h) * dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(orow + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t H, int64_t Hkv, int64_t dh, float scale,
           int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DHP>();
  if (cudaError_t e = cudaFuncSetAttribute(
          flash_attention_kernel<T, DHP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((S + kRows - 1) / kRows),
                  static_cast<unsigned>(B * H));
  flash_attention_kernel<T, DHP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(Hkv), static_cast<int>(dh),
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t B, int64_t S, int64_t H, int64_t Hkv, int64_t dh,
             float scale, int causal, cudaStream_t st) {
  if (dh <= 32) return launch<T, 32>(q, k, v, o, B, S, H, Hkv, dh, scale,
                                     causal, st);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, B, S, H, Hkv, dh, scale,
                                     causal, st);
  if (dh <= 80) return launch<T, 80>(q, k, v, o, B, S, H, Hkv, dh, scale,
                                     causal, st);
  return launch<T, 128>(q, k, v, o, B, S, H, Hkv, dh, scale, causal, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  Needs contiguous
// tensors on 16-byte boundaries, 0 < dh <= 128 with dh a multiple of 8,
// H a multiple of Hkv, B * H <= 65535 and S < 2^31 (the wrapper checks).
int attn_flash_attention(int device, const void* q, const void* k,
                         const void* v, int64_t B, int64_t S, int64_t H,
                         int64_t Hkv, int64_t dh, float scale, int causal,
                         int dtype, void* o, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || dh < 1
      || dh > 128 || dh % 8 != 0 || B * H > 65535 || S > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, o, B, S, H, Hkv, dh, scale, causal, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, dh, scale,
                                   causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
