// Hopper (sm_90a) kernels of the MoE FFN: the expert-grouped matmul
//
//   x (E, C, d), w (E, d, f), row-major, float32 or bfloat16 (dtype flag 0
//   or 1)  ->  o (E, C, f) in x's dtype
//
//   o[e, c, n] = sum_k x[e, c, k] * w[e, k, n]
//
// multiplied and summed in float32 and rounded once to the output's dtype,
// as ref.gmm_ref computes it.  One launcher with a plain C interface
// (loaded with ctypes by src/repro_torch/kernels/_build.py); it takes the
// device index, raw device pointers, the sizes, the dtype flag, the form
// (chosen by kernels/gmm.py's `form`), a float32 scratch for the decode's
// partial sums and a cudaStream_t, allocates nothing and returns
// cudaGetLastError().
//
// Replaces the Pallas `_kernel` of src/repro/kernels/gmm.py:18
// (`pallas_call` at :43), which padded C and f up to its blocks; here the
// tiles' tails are zeros (TMA's fill, or staged) and masked on the write,
// so any E, C, d and f run with no padded copy.  Bound: operations (2 E C
// d f) at the prefill's C of thousands of rows, bytes (the weights, E d f
// elements) at the decode's C of a few tokens.  Five forms:
//
//   * kWgmma: C > 32, bfloat16, rows of x and w a multiple of 16 bytes
//     and both on 16 bytes (the prefill).  A block owns a 128 x 256 output
//     tile: a producer warpgroup (one thread issues; its registers go to
//     the consumers by setmaxnreg) keeps TMA loads of 64-deep k-slices of
//     x (128 x 64) and w (64 x 256, four 64-column boxes) in flight
//     through a ring of 4 shared-memory stages (mbarriers full / empty);
//     two consumer warpgroups of 64 rows each run wgmma m64n256k16 from
//     shared memory into float32 registers (x K-major; w N-major through
//     the transpose bit, no transposed copy).  The tensor maps are 3-D
//     over (E, C, d) and (E, d, f), the expert outermost, so a tile never
//     reads the next expert's rows, and TMA's zero fill covers the C, d
//     and f tails.  Each output is rounded once from its register.
//   * kWmma: C > 32, bfloat16, the rows or pointers TMA cannot take:
//     WMMA 16 x 16 x 16 on 128 x 128 tiles staged by all 256 threads.
//   * kSimt: C > 32, float32: the CUDA cores in full float32 (it must not
//     round through TF32), 128 x 128 tiles of 8 x 8 outputs a thread.
//   * kStream: C <= 32, bfloat16, TMA rows (the decode).  The weights'
//     bytes bound it, so d is split over blocks too (512 rows each, more
//     than 1,000 blocks at moonshot's shapes): the same kernel with one
//     consumer warpgroup on a 64-row tile (C rows live; the tensor cores
//     have time to spare), a producer warp and a 2-stage ring, two blocks
//     an SM, streams each block's 512 x 256 slab of w by TMA and writes
//     its float32 partial sums to a scratch; a second pass adds the
//     splits in order and rounds once.  No atomics: one answer every run.
//   * kSkinny: C <= 32, float32 or rows TMA cannot take: a block streams
//     a 256-column slab of w from device memory into registers for up to
//     8 rows of x; the warps' partial sums are added in a fixed order.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSkinnyC = 32;           // the decode's form up to this C

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch does
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive values from p as float32: one 16-byte load (bfloat16)
// or two (float32) where `vec` says the launch's rows are 16-byte aligned
// and all eight lie inside the row; else one by one, zeros past `valid`.
__device__ __forceinline__ void load8(const float* p, bool vec, int valid,
                                      float* out) {
  if (vec && valid >= 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = i < valid ? __ldg(p + i) : 0.f;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec,
                                      int valid, float* out) {
  if (vec && valid >= 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(x[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = i < valid ? to_f(p[i]) : 0.f;
}

// The same eight values kept as bfloat16 (the tensor-core form).
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, bool vec,
                                            int valid) {
  if (vec && valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 u;
  __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = i < valid ? p[i] : __float2bfloat16(0.f);
  return u;
}

// -- C > 32, bfloat16: tensor cores ------------------------------------------
constexpr int kTM = 128, kTN = 128, kTK = 32, kPad = 8;

__global__ void __launch_bounds__(kThreads, 2)
gmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ o, int C, int d, int f, int vec) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 as[kTM][kTK + kPad];
  __shared__ __align__(128) __nv_bfloat16 bs[kTK][kTN + kPad];
  __shared__ __align__(128) float cs[kThreads / 32][16 * 16];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const __nv_bfloat16* xe = x + static_cast<int64_t>(e) * C * d;
  const __nv_bfloat16* we = w + static_cast<int64_t>(e) * d * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int k0 = 0; k0 < d; k0 += kTK) {
    for (int it = threadIdx.x; it < kTM * kTK / 8; it += kThreads) {
      const int r = it / (kTK / 8), kk = (it % (kTK / 8)) * 8;
      const int row = c0 + r, col = k0 + kk;
      *reinterpret_cast<uint4*>(&as[r][kk]) =
          row < C ? load8_bf16(xe + static_cast<int64_t>(row) * d + col, vec,
                               d - col)
                  : zero;
    }
    for (int it = threadIdx.x; it < kTK * kTN / 8; it += kThreads) {
      const int kk = it / (kTN / 8), cc = (it % (kTN / 8)) * 8;
      const int row = k0 + kk, col = n0 + cc;
      *reinterpret_cast<uint4*>(&bs[kk][cc]) =
          row < d ? load8_bf16(we + static_cast<int64_t>(row) * f + col, vec,
                               f - col)
                  : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], &as[wr + 16 * i][kk], kTK + kPad);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(b[j], &bs[kk][wc + 16 * j], kTN + kPad);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                   // the tiles are read before restaging
  }

  float* scratch = cs[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = c0 + wr + 16 * i + r, col = n0 + wc + 16 * j + cc;
      if (row < C) {
        __nv_bfloat16* orow = o + (static_cast<int64_t>(e) * C + row) * f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (col + q < f) {
            orow[col + q] = __float2bfloat16(scratch[r * 16 + cc + q]);
          }
        }
      }
      __syncwarp();                    // the scratch is read before reuse
    }
  }
}

// -- C > 32, float32: CUDA cores ---------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, int C, int d, int f, int vec) {
  __shared__ __align__(16) float as[kBK][kBM];   // x tile, d-major
  __shared__ __align__(16) float bs[kBK][kBN];   // w tile, row-major

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* xe = x + static_cast<int64_t>(e) * C * d;
  const T* we = w + static_cast<int64_t>(e) * d * f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += kBK) {
    {  // x: 128 rows x 16 depth, eight depth values a load
      const int r = threadIdx.x / 2, kk = (threadIdx.x % 2) * 8;
      const int row = c0 + r, col = k0 + kk;
      float v[8];
      if (row < C) {
        load8(xe + static_cast<int64_t>(row) * d + col, vec, d - col, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) as[kk + i][r] = v[i];
    }
    {  // w: 16 depth rows x 128 columns, eight columns a load
      const int kk = threadIdx.x / 16, cc = (threadIdx.x % 16) * 8;
      const int row = k0 + kk, col = n0 + cc;
      float v[8];
      if (row < d) {
        load8(we + static_cast<int64_t>(row) * f + col, vec, f - col, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&bs[kk][cc]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&bs[kk][cc + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();                   // the tiles are read before restaging
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = c0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= C) continue;
    T* orow = o + (static_cast<int64_t>(e) * C + row) * f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (col < f) store(orow + col, acc[i][j]);
    }
  }
}

// -- C <= 32: the weights streamed once --------------------------------------
constexpr int kSC = 8;                 // rows of x a block
constexpr int kSN = 256;               // columns a block: 32 lanes x 8
constexpr int kSK = 512;               // depth of x staged at a time
constexpr int kWarps = kThreads / 32;  // slices of d

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ o, int C, int d, int f, int vec) {
  __shared__ float xs[kSC][kSK];
  __shared__ float red[kWarps][kSN];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kSC, n0 = blockIdx.x * kSN;
  const T* xe = x + static_cast<int64_t>(e) * C * d;
  const T* we = w + static_cast<int64_t>(e) * d * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * 8;

  float acc[kSC][8];
#pragma unroll
  for (int c = 0; c < kSC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += kSK) {
    const int depth = min(kSK, d - k0);
    __syncthreads();                   // the last chunk of x is read
    for (int it = threadIdx.x; it < kSC * kSK; it += kThreads) {
      const int c = it / kSK, k = it % kSK;
      xs[c][k] = c0 + c < C && k < depth
                     ? to_f(xe[static_cast<int64_t>(c0 + c) * d + k0 + k])
                     : 0.f;
    }
    __syncthreads();
    // warp w takes rows w, w + 8, ... of the chunk: the warps' loads of
    // the slab interleave
#pragma unroll 4
    for (int k = warp; k < depth; k += kWarps) {
      float v[8];
      load8(we + static_cast<int64_t>(k0 + k) * f + col, vec, f - col, v);
#pragma unroll
      for (int c = 0; c < kSC; ++c) {
        const float xv = xs[c][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(xv, v[j], acc[c][j]);
      }
    }
  }

  // the warps' partial sums, added in warp order, one row at a time
#pragma unroll
  for (int c = 0; c < kSC; ++c) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][lane * 8 + j] = acc[c][j];
    __syncthreads();
    const int row = c0 + c, n = n0 + threadIdx.x;
    if (row < C && n < f) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
      store(o + (static_cast<int64_t>(e) * C + row) * f + n, s);
    }
  }
}

// -- kWgmma and kStream: bfloat16, TMA-fed wgmma ----------------------------
//
// A block owns a (64 WGS) x 256 output tile of one expert.  One producer
// (thread 128 WGS) keeps TMA loads of 64-deep k-slices of x (64 WGS x 64)
// and w (64 x 256, four 64-column boxes) in flight through a ring of
// STAGES shared-memory stages (mbarriers full / empty); WGS consumer
// warpgroups of 64 rows each run wgmma m64n256k16 from shared memory into
// float32 registers.  kWgmma (the prefill): WGS = 2 and a producer
// warpgroup that gives its registers to the consumers (setmaxnreg); the
// whole of d; bfloat16 out.  kStream (the decode, C <= 32 rows live of
// the 64): WGS = 1 and a producer warp, two blocks an SM; a block takes
// kDSplit rows of d and writes its float32 partial sums to
// part[split][e][c][n], which gmm_split_sum_kernel adds in split order.
constexpr int kGN = 256;               // columns a block
constexpr int kGK = 64;                // depth of a slice (128 swizzled bytes)
constexpr int kGBox = kGK * 64 * 2;    // one 64-column box of w, 8 KB
constexpr int kGBBytes = kGK * kGN * 2;          // w slice, 32 KB
constexpr int kDSplit = 512;           // rows of d a kStream block

template <int WGS>
constexpr int gmm_threads() { return 128 * WGS + (WGS == 2 ? 128 : 32); }

template <int WGS, int STAGES>
constexpr size_t gmm_smem() {
  return 1024 + STAGES * (64 * WGS * 128 + kGBBytes)
         + 2 * STAGES * sizeof(uint64_t);
}

template <int WGS, int STAGES, bool SPLIT>
__global__ void __launch_bounds__(gmm_threads<WGS>(), 3 - WGS)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                 int E, int C, int d, int f) {
  constexpr int kBM = 64 * WGS;
  constexpr int kABytes = kBM * 128;                // x slice
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* as = base;                               // [stage][rows][64]
  uint8_t* bs = base + STAGES * kABytes;            // [stage][4][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * kGBBytes);
  uint64_t* empty = full + STAGES;

  const int e = blockIdx.z, n0 = blockIdx.x * kGN;
  const int m0 = SPLIT ? 0 : blockIdx.y * kBM;
  const int k_begin = SPLIT ? blockIdx.y * kDSplit : 0;
  const int k_end = SPLIT ? min(d, k_begin + kDSplit) : d;
  const int n_k = (k_end - k_begin + kGK - 1) / kGK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * WGS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the role, warp-uniform to the compiler (a shuffle), so that the
  // roles' branches take setmaxnreg's register counts
  const int wg = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == WGS) {                     // producer: one thread issues
    if constexpr (WGS == 2) hopper::regs_dec<40>();
    if (threadIdx.x == 128 * WGS) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&wmap);
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % STAGES;
        const int k = k_begin + kb * kGK;
        if (kb >= STAGES) {
          hopper::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        }
        hopper::mbar_expect_tx(&full[s], kABytes + kGBBytes);
        hopper::tma_load_3d(as + s * kABytes, &xmap, &full[s], k, m0, e);
#pragma unroll
        for (int j = 0; j < kGN / 64; ++j) {
          hopper::tma_load_3d(bs + s * kGBBytes + j * kGBox, &wmap, &full[s],
                              n0 + 64 * j, k, e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes rows m0 + 64 half ...
  if constexpr (WGS == 2) hopper::regs_inc<232>();
  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) acc[i] = 0.f;
  const int half = wg;
  // one slice's products stay in flight while the next slice's issue; a
  // stage is released once the products that read it are done
  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % STAGES;
    hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
    const uint8_t* a = as + s * kABytes + half * 64 * 128;
    const uint8_t* b = bs + s * kGBBytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      hopper::wgmma_ss_n256<1>(acc,
                               hopper::desc_sw128(a + 32 * kk, 16, 1024),
                               hopper::desc_sw128(b + 2048 * kk, kGBox, 1024),
                               1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (kb > 0) hopper::mbar_arrive(&empty[(kb + STAGES - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  // the accumulator's layout (hopper.cuh): rows r and r + 8, columns
  // 8j + 2(l % 4) + {0, 1}; f is even, so a pair is in or out together
  const int t = threadIdx.x % 128;
  const int r = m0 + half * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int c = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kGN / 8; ++j) {
    const int col = c + 8 * j;
    if (col >= f) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= C) continue;
      const int64_t at = (static_cast<int64_t>(e) * C + row) * f + col;
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(
            part + static_cast<int64_t>(blockIdx.y) * E * C * f + at) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + at) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// o[i] = sum over the splits, in order, of part[split][i], rounded once
__global__ void gmm_split_sum_kernel(const float* __restrict__ part,
                                     __nv_bfloat16* __restrict__ o,
                                     int64_t n, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n + i];
    o[i] = __float2bfloat16(s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the forms, as kernels/gmm.py's FORMS numbers them
enum Form { kSimt = 0, kWmma = 1, kWgmma = 2, kSkinny = 3, kStream = 4 };

// kWgmma (SPLIT false: 2 consumer warpgroups, 4 stages) or kStream
// (SPLIT true: 1 consumer warpgroup, 2 stages, d split by kDSplit, then
// the splits added in order)
template <bool SPLIT>
int launch_wgmma(const void* x, const void* w, void* o, float* part,
                 int64_t E, int64_t C, int64_t d, int64_t f,
                 cudaStream_t st) {
  constexpr int kWGS = SPLIT ? 1 : 2, kStages = SPLIT ? 2 : 4;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[3] = {static_cast<uint64_t>(d),
                             static_cast<uint64_t>(C),
                             static_cast<uint64_t>(E)};
  const uint64_t xstrides[2] = {static_cast<uint64_t>(d) * 2,
                                static_cast<uint64_t>(C * d) * 2};
  const uint32_t xbox[3] = {kGK, 64 * kWGS, 1};
  const uint64_t wdims[3] = {static_cast<uint64_t>(f),
                             static_cast<uint64_t>(d),
                             static_cast<uint64_t>(E)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(f) * 2,
                                static_cast<uint64_t>(d * f) * 2};
  const uint32_t wbox[3] = {64, kGK, 1};
  if (int rc = hopper::make_map(&xmap, x, 3, xdims, xstrides, xbox, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&wmap, w, 3, wdims, wstrides, wbox, true)) {
    return rc;
  }
  constexpr size_t smem = gmm_smem<kWGS, kStages>();
  auto kernel = gmm_wgmma_kernel<kWGS, kStages, SPLIT>;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const int splits = static_cast<int>((d + kDSplit - 1) / kDSplit);
  const dim3 grid(static_cast<unsigned>((f + kGN - 1) / kGN),
                  SPLIT ? static_cast<unsigned>(splits)
                        : static_cast<unsigned>((C + 127) / 128),
                  static_cast<unsigned>(E));
  kernel<<<grid, gmm_threads<kWGS>(), smem, st>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(o), part, static_cast<int>(E),
      static_cast<int>(C), static_cast<int>(d), static_cast<int>(f));
  if (SPLIT) {
    const int64_t n = E * C * f;
    const unsigned blocks = static_cast<unsigned>(
        n / 256 + 1 < 132 * 8 ? n / 256 + 1 : 132 * 8);
    gmm_split_sum_kernel<<<blocks, 256, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(o), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int form, const void* x, const void* w, void* o, int64_t E,
             int64_t C, int64_t d, int64_t f, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(o);
  const int Ci = static_cast<int>(C), di = static_cast<int>(d);
  const int fi = static_cast<int>(f);
  // 16-byte loads of eight values need rows of a multiple of 16 bytes for
  // bfloat16 and of 16 bytes (two loads of four) for float32
  const int vec = (d * sizeof(T)) % 16 == 0 && (f * sizeof(T)) % 16 == 0
                  && aligned16(x) && aligned16(w);
  const unsigned ue = static_cast<unsigned>(E);
  if (form == kSkinny) {
    const dim3 grid(static_cast<unsigned>((f + kSN - 1) / kSN),
                    static_cast<unsigned>((C + kSC - 1) / kSC), ue);
    gmm_skinny_kernel<T><<<grid, kThreads, 0, st>>>(xt, wt, ot, Ci, di, fi,
                                                     vec);
  } else if constexpr (sizeof(T) == 2) {
    const dim3 grid(static_cast<unsigned>((f + kTN - 1) / kTN),
                    static_cast<unsigned>((C + kTM - 1) / kTM), ue);
    gmm_tc_kernel<<<grid, kThreads, 0, st>>>(xt, wt, ot, Ci, di, fi, vec);
  } else {
    const dim3 grid(static_cast<unsigned>((f + kBN - 1) / kBN),
                    static_cast<unsigned>((C + kBM - 1) / kBM), ue);
    gmm_kernel<T><<<grid, kThreads, 0, st>>>(xt, wt, ot, Ci, di, fi, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and o).  form: a Form, which
// must suit the dtype, C and (kWgmma, kStream) rows of d and f values a
// multiple of 16 bytes with x and w on 16 bytes; kStream writes
// ceil(d / 512) x E x C x f float32 partial sums to `part`.  Needs
// contiguous tensors, E, C, d, f >= 1, E <= 65535, C < 2^20 and d, f <
// 2^31 (the wrapper checks).
int moe_gmm(int device, const void* x, const void* w, int64_t E, int64_t C,
            int64_t d, int64_t f, int dtype, int form, void* part, void* o,
            void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (E < 1 || C < 1 || d < 1 || f < 1 || E > 65535 || C >= (1 << 20)
      || d > 0x7fffffff || f > 0x7fffffff || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool skinny = C <= kSkinnyC;
  const bool tma = dtype == 1 && d % 8 == 0 && f % 8 == 0 && aligned16(x)
                   && aligned16(w);
  const bool fits = form == kSkinny ? skinny
                    : form == kStream ? skinny && tma && part != nullptr
                    : form == kWgmma ? !skinny && tma
                    : form == kWmma ? !skinny && dtype == 1
                    : form == kSimt && !skinny && dtype == 0;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (form == kWgmma) return launch_wgmma<false>(x, w, o, p, E, C, d, f, st);
  if (form == kStream) return launch_wgmma<true>(x, w, o, p, E, C, d, f, st);
  if (dtype == 0) return dispatch<float>(form, x, w, o, E, C, d, f, st);
  return dispatch<__nv_bfloat16>(form, x, w, o, E, C, d, f, st);
}

}  // extern "C"
