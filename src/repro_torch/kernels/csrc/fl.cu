// Hopper (sm_90a) kernels of the FL protocol path: the reputation-weighted
// merge (paper Eq. 1) and the per-trainer model distance (paper Eq. 4).
//
// Both read a stacked (n, P) tensor of trainer models, row-major, in
// float32 or bfloat16 (dtype flag 0 or 1), and accumulate in float32;
// weighted_agg also takes T such stacks at once, (T, n, P) with (T, n)
// scores, one task per grid row (the cross-task megastep).
// Two launchers with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py).  Each takes the device index, raw
// device pointers, the sizes, the dtype flag and a cudaStream_t, allocates
// nothing and returns cudaGetLastError():
//
//   fl_weighted_agg    out[t, p] = sum_i s[t, i] * w[t, i, p]
//                                  / max(sum_i s[t, i], 1e-12)
//   fl_model_distance  out[i] = || l[i, :] - g[:] ||_2
//
// Both are bound by the bytes they read: two or three float operations per
// element against 3.35 TB/s of HBM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kAggBlock = 256;       // weighted_agg: threads per block
constexpr int kDistBlock = 512;      // model_distance: threads per block

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eq. 1.  Columns are independent, so one thread owns a column p (threads
// of a warp on neighbouring columns: every row read is coalesced) and
// walks the n rows in order, accumulating s[i] * w[i, p] in float32.  A
// grid-stride loop covers any P; the tail needs no padding, because a
// thread past P does nothing.  Each block sums the scores itself (n is
// small) before the column loop.  Grid row blockIdx.y is task t: its
// stack, scores and output start t stacks in, and every task's sums run
// in the same order as a launch on that task alone, so row t of a
// batched launch is bit-identical to it.
template <typename T>
__global__ void __launch_bounds__(kAggBlock)
weighted_agg_kernel(const T* __restrict__ w, const float* __restrict__ s,
                    int64_t n, int64_t P, T* __restrict__ out) {
  const int64_t task = blockIdx.y;
  w += task * n * P;
  s += task * n;
  out += task * P;
  __shared__ float denom;
  if (threadIdx.x < 32) {
    float acc = 0.f;
    for (int64_t i = threadIdx.x; i < n; i += 32) acc += s[i];
    acc = warp_sum(acc);
    if (threadIdx.x == 0) denom = fmaxf(acc, 1e-12f);
  }
  __syncthreads();
  const float d = denom;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kAggBlock;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kAggBlock
                   + threadIdx.x; p < P; p += step) {
    const T* col = w + p;
    float acc = 0.f;
#pragma unroll 8
    for (int64_t i = 0; i < n; ++i) {
      acc = fmaf(__ldg(s + i), to_float(col[i * P]), acc);
    }
    out[p] = from_float<T>(acc / d);
  }
}

// Squared differences of one 16-byte vector (4 floats or 8 bfloat16s)
// added into four float32 accumulators.
__device__ __forceinline__ void sq_diff(const uint4& a, const uint4& b,
                                        float* acc, float) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float d = x[k] - y[k];
    acc[k] = fmaf(d, d, acc[k]);
  }
}
__device__ __forceinline__ void sq_diff(const uint4& a, const uint4& b,
                                        float* acc, __nv_bfloat16) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = __bfloat162float(x[k]) - __bfloat162float(y[k]);
    acc[k & 3] = fmaf(d, d, acc[k & 3]);
  }
}

// Eq. 4.  One block per row i: a loop inside the block over P takes the
// place of the TPU grid's sequential axis, which carried the sum in its
// output block.  Where the row and g are 16-byte aligned at the same
// index, threads read 16-byte vectors (neighbouring threads on
// neighbouring vectors) into four accumulators; the unaligned head and
// the tail, and rows whose alignment differs from g's, go element by
// element.  A warp then block reduction in float32, then sqrt; thread 0
// writes.  No atomics, and a fixed reduction order: the result does not
// change from run to run.
template <typename T>
__global__ void __launch_bounds__(kDistBlock)
model_distance_kernel(const T* __restrict__ l, const T* __restrict__ g,
                      int64_t P, float* __restrict__ out) {
  constexpr int64_t kVec = 16 / sizeof(T);
  const T* __restrict__ row = l + static_cast<int64_t>(blockIdx.x) * P;
  const int t = threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uintptr_t ra = reinterpret_cast<uintptr_t>(row);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  int64_t head = P;                  // elements before the vector body
  if ((ra & 15u) == (ga & 15u) && (ra % sizeof(T)) == 0) {
    head = static_cast<int64_t>(((16u - (ra & 15u)) & 15u) / sizeof(T));
    if (head > P) head = P;
  }
  for (int64_t k = t; k < head; k += kDistBlock) {
    const float d = to_float(row[k]) - to_float(g[k]);
    acc[0] = fmaf(d, d, acc[0]);
  }
  const int64_t nv = (P - head) / kVec;
  const uint4* __restrict__ rv = reinterpret_cast<const uint4*>(row + head);
  const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(g + head);
  for (int64_t v = t; v < nv; v += kDistBlock) {
    sq_diff(__ldg(rv + v), __ldg(gv + v), acc, T());
  }
  for (int64_t k = head + nv * kVec + t; k < P; k += kDistBlock) {
    const float d = to_float(row[k]) - to_float(g[k]);
    acc[1] = fmaf(d, d, acc[1]);
  }
  float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __shared__ float partial[kDistBlock / 32];
  const int lane = t & 31, warp = t >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kDistBlock / 32 ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) out[blockIdx.x] = sqrtf(v);
  }
}

int64_t blocks_for(int64_t items, int64_t per_block) {
  return (items + per_block - 1) / per_block;
}

}  // namespace

extern "C" {

// T stacks of (n, P); dtype: 0 = float32, 1 = bfloat16 (w and out); s is
// float32 (T, n).
int fl_weighted_agg(int device, const void* w, const void* s, int64_t T,
                    int64_t n, int64_t P, int dtype, void* out,
                    void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (T < 1 || T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int64_t grid = blocks_for(P, kAggBlock);
  if (grid < 1) grid = 1;
  if (grid > 132 * 8) grid = 132 * 8;  // grid-stride beyond 8 blocks per SM
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(T));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sf = static_cast<const float*>(s);
  if (dtype == 0) {
    weighted_agg_kernel<float><<<blocks, kAggBlock, 0, st>>>(
        static_cast<const float*>(w), sf, n, P, static_cast<float*>(out));
  } else if (dtype == 1) {
    weighted_agg_kernel<__nv_bfloat16>
        <<<blocks, kAggBlock, 0, st>>>(
            static_cast<const __nv_bfloat16*>(w), sf, n, P,
            static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (l and g); out is float32, one per row.
int fl_model_distance(int device, const void* l, const void* g, int64_t n,
                      int64_t P, int dtype, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto of = static_cast<float*>(out);
  if (dtype == 0) {
    model_distance_kernel<float><<<static_cast<unsigned>(n), kDistBlock, 0,
                                   st>>>(static_cast<const float*>(l),
                                         static_cast<const float*>(g), P, of);
  } else if (dtype == 1) {
    model_distance_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(n), kDistBlock, 0, st>>>(
            static_cast<const __nv_bfloat16*>(l),
            static_cast<const __nv_bfloat16*>(g), P, of);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
