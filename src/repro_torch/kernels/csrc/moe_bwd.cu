// Hopper (sm_90a) kernels of the MoE FFN's backward: the gradient of the
// expert-grouped matmul o (E, C, f) = x (E, C, d) w (E, d, f)
//
//   dx (E, C, d) = dy (E, C, f) w^T      dx[e, c, k] = sum_n dy[e, c, n] w[e, k, n]
//   dw (E, d, f) = x^T dy                dw[e, k, n] = sum_c x[e, c, k] dy[e, c, n]
//
// multiplied and summed in float32 and rounded once to the inputs' dtype
// (float32 or bfloat16, dtype flag 0 or 1), as autograd computes them
// through kernels/gmm.py's gmm_torch.  One launcher with a plain C
// interface (loaded with ctypes by src/repro_torch/kernels/_build.py); it
// takes the device index, raw device pointers, the sizes, the dtype flag,
// the form (kernels/gmm.py bwd_form), the rows of C a split of dw's sum
// takes, a float32 scratch for the splits' partial sums and a
// cudaStream_t, allocates nothing and returns cudaGetLastError().
//
// Replaces no Pallas kernel: the JAX package differentiates its expert
// products through jnp (src/repro/models/moe.py), so this is the gradient
// of the forward kernel that replaces src/repro/kernels/gmm.py:18.  Bound:
// operations, 4 E C d f, over the bf16 tensor-core peak at a training
// step's C of thousands of rows (its bytes, x, w and dy read and dx, dw
// written once, take 0.42 ms of the 0.72 at moonshot's shapes).
//
// Both gradients are products out[e] (M x N) = A[e] (M x K) B[e] (K x N)
// over a range of K, one operand of each read transposed:
//
//   * dx: M = C, N = d, K = f; A = dy as it is, B(k, n) = w[n, k].
//   * dw: M = d, N = f, K = C; A(m, k) = x[k, m], B = dy as it is.  The sum
//     over C is split over `splits` chunks of `chunk` rows (a multiple of
//     32) only where the output tiles alone leave the card short of them
//     (kernels/gmm.py `bwd_chunk`); each split writes its float32 partial
//     sums to the scratch and a second pass adds the splits in order and
//     rounds once.  No atomics: one answer every run.
//
// Three forms (kernels/gmm.py bwd_form):
//   * kWgmma (bfloat16, rows TMA can read: d and f multiples of 8, x, w, dy
//     on 16 bytes): the forward's TMA / wgmma pipeline, both products in
//     one persistent launch, each transposed operand read as it lies by
//     the hardware (gmm_bwd_wgmma_kernel, below);
//   * kWmma (other bfloat16): WMMA 16 x 16 x 16 on 128 x 128 tiles (32
//     deep), 8 warps of 32 x 64 outputs, all 256 threads staging each
//     transposed operand as it lies, float32 sums;
//   * kSimt (float32): the CUDA cores in full float32 (no TF32), 128 x 128
//     tiles (16 deep) of 8 x 8 outputs a thread.
// Tails of M, N and K read as zeros and are masked (or clipped) on the
// write, so any E, C, d and f run with no padded copy.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

// the forms, as kernels/gmm.py's BWD_FORMS numbers them
enum Form { kSimt = 0, kWmma = 1, kWgmma = 2 };

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as torch does
}

// Eight consecutive float32 values from p: two 16-byte loads where `vec`
// says the rows are 16-byte aligned and all eight lie inside; else one by
// one, zeros from `valid` on.
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

// Eight consecutive bfloat16 values, kept as they are.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, bool vec,
                                            int valid) {
  if (vec && valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 u;
  __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = i < valid ? p[i] : __float2bfloat16(0.f);
  return u;
}

// The operands of one product.  A(m, k) is a[k * lda + m] when TA (A read
// transposed), a[m * lda + k] otherwise; B(k, n) is b[n * ldb + k] when TB,
// b[k * ldb + n] otherwise; expert e starts a_e (b_e) values further on.
// blockIdx.z is e + E * split; split s sums k in [s * chunk, (s + 1) *
// chunk) within [0, K).  With one split the output is `o` in the inputs'
// dtype, else the float32 scratch `part` [split][e][M][N].
struct Problem {
  const void* a;
  const void* b;
  int64_t a_e, b_e;
  int lda, ldb, M, N, K, chunk, E;
  void* o;
  float* part;
  int vec;
};

// -- bfloat16: tensor cores ------------------------------------------------
constexpr int kTM = 128, kTN = 128, kTK = 32, kPad = 8;
constexpr int kTileVals = kTM * (kTK + kPad) > kTK * (kTM + kPad)
                              ? kTM * (kTK + kPad) : kTK * (kTM + kPad);

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, 2)
gmm_bwd_tc_kernel(Problem pr) {
  using namespace nvcuda;
  // A as [m][k] (ld kTK + kPad) or, read transposed, [k][m] (ld kTM +
  // kPad); B as [k][n] or [n][k] the same way
  __shared__ __align__(128) __nv_bfloat16 as[kTileVals];
  __shared__ __align__(128) __nv_bfloat16 bs[kTileVals];
  __shared__ __align__(128) float cs[kThreads / 32][16 * 16];

  const int e = blockIdx.z % pr.E, split = blockIdx.z / pr.E;
  const int k_begin = split * pr.chunk;
  const int k_end = min(pr.K, k_begin + pr.chunk);
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(pr.a)
                           + e * pr.a_e;
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(pr.b)
                           + e * pr.b_e;
  const bool vec = pr.vec != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 64;
  constexpr int lda_s = TA ? kTM + kPad : kTK + kPad;
  constexpr int ldb_s = TB ? kTK + kPad : kTN + kPad;
  using ALayout = typename std::conditional<TA, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major,
                                            wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    for (int it = threadIdx.x; it < kTM * kTK / 8; it += kThreads) {
      if (TA) {                        // rows k, m contiguous
        const int kk = it / (kTM / 8), mm = (it % (kTM / 8)) * 8;
        const int row = k0 + kk, col = m0 + mm;
        *reinterpret_cast<uint4*>(&as[kk * lda_s + mm]) =
            row < k_end ? load8_bf16(a + static_cast<int64_t>(row) * pr.lda
                                         + col, vec, pr.M - col)
                        : zero;
      } else {                         // rows m, k contiguous
        const int r = it / (kTK / 8), kk = (it % (kTK / 8)) * 8;
        const int row = m0 + r, col = k0 + kk;
        *reinterpret_cast<uint4*>(&as[r * lda_s + kk]) =
            row < pr.M ? load8_bf16(a + static_cast<int64_t>(row) * pr.lda
                                        + col, vec, k_end - col)
                       : zero;
      }
    }
    for (int it = threadIdx.x; it < kTK * kTN / 8; it += kThreads) {
      if (TB) {                        // rows n, k contiguous
        const int r = it / (kTK / 8), kk = (it % (kTK / 8)) * 8;
        const int row = n0 + r, col = k0 + kk;
        *reinterpret_cast<uint4*>(&bs[r * ldb_s + kk]) =
            row < pr.N ? load8_bf16(b + static_cast<int64_t>(row) * pr.ldb
                                        + col, vec, k_end - col)
                       : zero;
      } else {                         // rows k, n contiguous
        const int kk = it / (kTN / 8), nn = (it % (kTN / 8)) * 8;
        const int row = k0 + kk, col = n0 + nn;
        *reinterpret_cast<uint4*>(&bs[kk * ldb_s + nn]) =
            row < k_end ? load8_bf16(b + static_cast<int64_t>(row) * pr.ldb
                                         + col, vec, pr.N - col)
                        : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
          fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wr + 16 * i;
        wmma::load_matrix_sync(fa[i], TA ? &as[kk * lda_s + m]
                                         : &as[m * lda_s + kk], lda_s);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wc + 16 * j;
        wmma::load_matrix_sync(fb[j], TB ? &bs[n * ldb_s + kk]
                                         : &bs[kk * ldb_s + n], ldb_s);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                   // the tiles are read before restaging
  }

  float* scratch = cs[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
  const int64_t plane = static_cast<int64_t>(pr.M) * pr.N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wr + 16 * i + r, col = n0 + wc + 16 * j + cc;
      if (row < pr.M) {
        const int64_t at = e * plane + static_cast<int64_t>(row) * pr.N;
        if (pr.part != nullptr) {
          float* prow = pr.part + split * pr.E * plane + at;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (col + q < pr.N) prow[col + q] = scratch[r * 16 + cc + q];
          }
        } else {
          __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(pr.o) + at;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (col + q < pr.N) {
              orow[col + q] = __float2bfloat16(scratch[r * 16 + cc + q]);
            }
          }
        }
      }
      __syncwarp();                    // the scratch is read before reuse
    }
  }
}

// -- float32: CUDA cores ---------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 16;

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, 2)
gmm_bwd_kernel(Problem pr) {
  __shared__ __align__(16) float as[kBK][kBM];   // A tile, k-major
  __shared__ __align__(16) float bs[kBK][kBN];   // B tile, k-major

  const int e = blockIdx.z % pr.E, split = blockIdx.z / pr.E;
  const int k_begin = split * pr.chunk;
  const int k_end = min(pr.K, k_begin + pr.chunk);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* a = static_cast<const float*>(pr.a) + e * pr.a_e;
  const float* b = static_cast<const float*>(pr.b) + e * pr.b_e;
  const bool vec = pr.vec != 0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    float v[8];
    if (TA) {                          // 16 rows k x 128 m, eight m a load
      const int kk = threadIdx.x / 16, mm = (threadIdx.x % 16) * 8;
      const int row = k0 + kk, col = m0 + mm;
      if (row < k_end) {
        load8(a + static_cast<int64_t>(row) * pr.lda + col, vec, pr.M - col,
              v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&as[kk][mm]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&as[kk][mm + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {                           // 128 rows m x 16 k, eight k a load
      const int r = threadIdx.x / 2, kk = (threadIdx.x % 2) * 8;
      const int row = m0 + r, col = k0 + kk;
      if (row < pr.M) {
        load8(a + static_cast<int64_t>(row) * pr.lda + col, vec, k_end - col,
              v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) as[kk + i][r] = v[i];
    }
    if (TB) {                          // 128 rows n x 16 k, eight k a load
      const int r = threadIdx.x / 2, kk = (threadIdx.x % 2) * 8;
      const int row = n0 + r, col = k0 + kk;
      if (row < pr.N) {
        load8(b + static_cast<int64_t>(row) * pr.ldb + col, vec, k_end - col,
              v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) bs[kk + i][r] = v[i];
    } else {                           // 16 rows k x 128 n, eight n a load
      const int kk = threadIdx.x / 16, nn = (threadIdx.x % 16) * 8;
      const int row = k0 + kk, col = n0 + nn;
      if (row < k_end) {
        load8(b + static_cast<int64_t>(row) * pr.ldb + col, vec, pr.N - col,
              v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&bs[kk][nn]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&bs[kk][nn + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();                   // the tiles are read before restaging
  }

  const int64_t plane = static_cast<int64_t>(pr.M) * pr.N;
  float* out = pr.part != nullptr ? pr.part + split * pr.E * plane
                                  : static_cast<float*>(pr.o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= pr.M) continue;
    float* orow = out + e * plane + static_cast<int64_t>(row) * pr.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (col < pr.N) orow[col] = acc[i][j];
    }
  }
}

// o[i] = sum over the splits, in order, of part[split][i], rounded once
template <typename T>
__global__ void gmm_bwd_split_sum_kernel(const float* __restrict__ part,
                                         T* __restrict__ o, int64_t n,
                                         int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n + i];
    store(o + i, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- bfloat16, TMA rows: the forward's TMA / wgmma pipeline, persistent --
//
// Both products in one launch: a tile list of dx's E x ceil(C / 128) x
// ceil(d / 256) tiles, then dw's E x splits x ceil(d / 128) x ceil(f / 256),
// walked by one block an SM (tile blockIdx.x, + gridDim.x, ..).  A block is
// gmm_wgmma_kernel's: a producer warpgroup whose one issuing thread keeps
// TMA loads of 64-deep k-slices of A (128 x 64) and B (64 x 256) in flight
// through a ring of 3 stages (mbarriers full / empty), running on into the
// next tile's slices while the consumers write the last tile out; two
// consumer warpgroups of 64 rows each run wgmma m64n256k16 into float32
// registers and release a stage once its products are done.  The slice
// counter runs on across tiles, so the ring's phases do too.  A tile goes
// out through shared memory: each warpgroup rounds its 64 x 256 outputs
// once into a bfloat16 staging buffer in the 128-byte swizzle (its own, 4
// boxes of 64 x 64) and one thread starts TMA stores of it, clipped at the
// tensor's edges; they run while the next tile's products do (the
// register-to-global writes they replace cost 0.40-0.69 ms of the call at
// moonshot's shapes, tools/bwd_split.py).
//
//   * dx (problem 0): A = dy (E, C, f), K-major; B(k, n) = w[e, n, k], rows
//     of w K-major (a box of 64 f x 256 rows of d), the transpose bit 0.
//   * dw (problem 1): A(m, k) = x[e, k, m], M-major (two boxes of 64 d x 64
//     rows of C), wgmma's A-transpose bit; B = dy (E, C, f), N-major (four
//     boxes of 64 f x 64 rows of C), the transpose bit, as the forward's w.
//     A split's k range ends on a multiple of 16 rows (the wrapper's chunk
//     is a multiple of 32): the last slice issues only the k16 steps inside
//     its split, so no row of the next split is multiplied.
//
// The tensor maps are 3-D with the expert outermost; TMA's zero fill
// covers every tail of C, d and f, and the stores are clipped.  Each
// output is rounded once from its register (or, split, written as float32
// from the registers for gmm_bwd_split_sum_kernel).
constexpr int kWN = 256;                 // columns a tile
constexpr int kWM = 128;                 // rows a tile: 2 warpgroups
constexpr int kWK = 64;                  // depth of a slice (128 bytes)
constexpr int kWStages = 3;
constexpr int kWBox = kWK * 64 * 2;      // one 64 x 64 box, 8 KB
constexpr int kWABytes = kWM * kWK * 2;  // A slice, 16 KB
constexpr int kWBBytes = kWN * kWK * 2;  // B slice, 32 KB
constexpr int kWThreads = 384;
constexpr int kWEpi = kWM * kWN * 2;     // the tile, staged: 64 KB
constexpr size_t kWSmem = 1024 + kWStages * (kWABytes + kWBBytes) + kWEpi
                          + 2 * kWStages * sizeof(uint64_t);

// one product's tile grid
struct WgProduct {
  int M, N, K;            // out[e] (M x N) = A[e] (M x K) . B[e] (K x N)
  int tiles_m, tiles_n, splits, chunk;
  int64_t tiles;          // E x splits x tiles_m x tiles_n
  float* part;            // (splits, E, M, N) float32 where splits > 1
};

struct WgTile {
  int p, e, split, m0, n0, k_begin, k_end;
};

__device__ __forceinline__ WgTile wg_tile(int64_t t, const WgProduct& dx,
                                          const WgProduct& dw) {
  WgTile w;
  w.p = t < dx.tiles ? 0 : 1;
  const WgProduct& pr = w.p == 0 ? dx : dw;
  if (w.p == 1) t -= dx.tiles;
  const int per_e = pr.splits * pr.tiles_m * pr.tiles_n;
  w.e = static_cast<int>(t / per_e);
  int r = static_cast<int>(t - static_cast<int64_t>(w.e) * per_e);
  w.split = r / (pr.tiles_m * pr.tiles_n);
  r -= w.split * pr.tiles_m * pr.tiles_n;
  w.m0 = (r / pr.tiles_n) * kWM;
  w.n0 = (r % pr.tiles_n) * kWN;
  w.k_begin = w.split * pr.chunk;
  w.k_end = min(pr.K, w.k_begin + pr.chunk);
  return w;
}

// The consumers' products of one tile: slices it0 .. of the ring; returns
// the slice counter after the tile.  P 0: dx (A and B K-major), 1: dw (A
// M-major, B N-major).
template <int P>
__device__ __forceinline__ int wg_products(float (&acc)[kWN / 2],
                                           const uint8_t* as,
                                           const uint8_t* bs, uint64_t* full,
                                           uint64_t* empty, int half,
                                           const WgTile& w, int it) {
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
  const int n_k = (w.k_end - w.k_begin + kWK - 1) / kWK;
  for (int kb = 0; kb < n_k; ++kb, ++it) {
    const int s = it % kWStages;
    hopper::mbar_wait(&full[s], (it / kWStages) & 1);
    const uint8_t* a = as + s * kWABytes + half * (kWABytes / 2);
    const uint8_t* b = bs + s * kWBBytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      if constexpr (P == 0) {
        // dx: the k tail past f is TMA's zeros
        hopper::wgmma_ss_n256<0, 0>(
            acc, hopper::desc_sw128(a + 32 * kk, 16, 1024),
            hopper::desc_sw128(b + 32 * kk, 16, 1024), 1);
      } else if (w.k_begin + kb * kWK + 16 * kk < w.k_end) {
        // dw: no k16 step past the split's end (a branch a step ran
        // faster than reading zeros for A there, tools/bwd_split.py)
        hopper::wgmma_ss_n256<1, 1>(
            acc, hopper::desc_sw128(a + 2048 * kk, kWBox, 1024),
            hopper::desc_sw128(b + 2048 * kk, kWBox, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    // the previous slice's products are done: its stage is free
    if (kb > 0) hopper::mbar_arrive(&empty[(it + kWStages - 1) % kWStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::mbar_arrive(&empty[(it + kWStages - 1) % kWStages]);
  return it;
}

// A warpgroup's 64 x 256 outputs into `ep` (4 boxes of 64 rows x 128
// bytes, the 128-byte swizzle: chunk c of row r at c ^ (r % 8)), rounded
// once, then TMA stores of the boxes inside the tensor by the group's
// first thread.  The accumulator's layout (hopper.cuh): rows r and r + 8,
// columns 8j + 2(l % 4) + {0, 1}.  The staging is reused a tile later,
// once the stores that read it have.
__device__ __forceinline__ void wg_stage(const float (&acc)[kWN / 2],
                                         uint8_t* ep, const CUtensorMap* map,
                                         const WgProduct& pr, const WgTile& w,
                                         int half) {
  const int t = threadIdx.x % 128;
  if (t == 0) hopper::bulk_wait_read<0>();
  hopper::bar_sync(1 + half, 128);
  const int r = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int cb = 8 * (j % 8) + 2 * (t % 4);    // column in the box
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          ep + (j / 8) * kWBox + row * 128 + (((cb / 8) ^ (row % 8)) << 4)
          + (cb % 8) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  hopper::fence_proxy_async_smem();
  hopper::bar_sync(1 + half, 128);
  const int m0 = w.m0 + 64 * half;
  if (t == 0 && m0 < pr.M) {
#pragma unroll
    for (int b = 0; b < kWN / 64; ++b) {
      if (w.n0 + 64 * b < pr.N) {
        hopper::tma_store_3d(map, ep + b * kWBox, w.n0 + 64 * b, m0, w.e);
      }
    }
    hopper::bulk_commit();
  }
}

// Split partial sums: float32 straight from the registers.  N is even, so
// a pair is in or out together.
__device__ __forceinline__ void wg_store(const float (&acc)[kWN / 2],
                                         const WgProduct& pr, int E,
                                         const WgTile& w, int half) {
  const int t = threadIdx.x % 128;
  const int r = w.m0 + half * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int c = w.n0 + 2 * (t % 4);
  const int64_t plane = static_cast<int64_t>(pr.M) * pr.N;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int col = c + 8 * j;
    if (col >= pr.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= pr.M) continue;
      const int64_t at = w.e * plane + static_cast<int64_t>(row) * pr.N + col;
      *reinterpret_cast<float2*>(pr.part + w.split * E * plane + at) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap dy_a,
                     const __grid_constant__ CUtensorMap w_b,
                     const __grid_constant__ CUtensorMap x_a,
                     const __grid_constant__ CUtensorMap dy_b,
                     const __grid_constant__ CUtensorMap dx_o,
                     const __grid_constant__ CUtensorMap dw_o,
                     const WgProduct dx, const WgProduct dw, int E) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* as = base;                               // [stage][128 x 64]
  uint8_t* bs = base + kWStages * kWABytes;         // [stage][256 x 64]
  uint8_t* epi = bs + kWStages * kWBBytes;          // [group][4][64 x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kWEpi);
  uint64_t* empty = full + kWStages;
  const int64_t tiles = dx.tiles + dw.tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {                         // producer: one thread issues
    hopper::regs_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&dy_a);
      hopper::prefetch_map(&w_b);
      hopper::prefetch_map(&x_a);
      hopper::prefetch_map(&dy_b);
      int it = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const WgTile w = wg_tile(t, dx, dw);
        for (int k = w.k_begin; k < w.k_end; k += kWK, ++it) {
          const int s = it % kWStages;
          if (it >= kWStages) {
            hopper::mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
          }
          hopper::mbar_expect_tx(&full[s], kWABytes + kWBBytes);
          uint8_t* a = as + s * kWABytes;
          uint8_t* b = bs + s * kWBBytes;
          if (w.p == 0) {
            hopper::tma_load_3d(a, &dy_a, &full[s], k, w.m0, w.e);
            hopper::tma_load_3d(b, &w_b, &full[s], k, w.n0, w.e);
          } else {
#pragma unroll
            for (int h = 0; h < kWM / 64; ++h) {
              hopper::tma_load_3d(a + h * kWBox, &x_a, &full[s],
                                  w.m0 + 64 * h, k, w.e);
            }
#pragma unroll
            for (int j = 0; j < kWN / 64; ++j) {
              hopper::tma_load_3d(b + j * kWBox, &dy_b, &full[s],
                                  w.n0 + 64 * j, k, w.e);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes rows m0 + 64 half ..
  hopper::regs_inc<232>();
  float acc[kWN / 2];
  uint8_t* ep = epi + wg * (kWEpi / 2);
  int it = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WgTile w = wg_tile(t, dx, dw);
    if (w.p == 0) {
      it = wg_products<0>(acc, as, bs, full, empty, wg, w, it);
      wg_stage(acc, ep, &dx_o, dx, w, wg);
    } else {
      it = wg_products<1>(acc, as, bs, full, empty, wg, w, it);
      if (dw.splits > 1) {
        wg_store(acc, dw, E, w, wg);
      } else {
        wg_stage(acc, ep, &dw_o, dw, w, wg);
      }
    }
  }
  // the stores have read the staging before the block leaves
  if (threadIdx.x % 128 == 0) hopper::bulk_wait<0>();
}

WgProduct wg_product(int64_t E, int64_t M, int64_t N, int64_t K,
                     int64_t chunk, float* part) {
  WgProduct pr;
  pr.M = static_cast<int>(M);
  pr.N = static_cast<int>(N);
  pr.K = static_cast<int>(K);
  pr.tiles_m = static_cast<int>((M + kWM - 1) / kWM);
  pr.tiles_n = static_cast<int>((N + kWN - 1) / kWN);
  pr.chunk = static_cast<int>(chunk < K ? chunk : K);
  pr.splits = static_cast<int>((K + pr.chunk - 1) / pr.chunk);
  pr.tiles = E * pr.splits * static_cast<int64_t>(pr.tiles_m) * pr.tiles_n;
  pr.part = pr.splits > 1 ? part : nullptr;
  return pr;
}

// the wgmma form: dx and dw in one persistent launch (dw's sum over C
// split by `chunk` rows), then the splits added in order where there are
// several
int launch_bwd_wgmma(const void* x, const void* w, const void* dy, int64_t E,
                     int64_t C, int64_t d, int64_t f, int64_t chunk,
                     float* part, void* dx, void* dw, cudaStream_t st) {
  const uint64_t cdf[3] = {static_cast<uint64_t>(f),
                           static_cast<uint64_t>(C),
                           static_cast<uint64_t>(E)};
  const uint64_t cdf_str[2] = {static_cast<uint64_t>(f) * 2,
                               static_cast<uint64_t>(C * f) * 2};
  const uint64_t ddf[3] = {static_cast<uint64_t>(f),
                           static_cast<uint64_t>(d),
                           static_cast<uint64_t>(E)};
  const uint64_t ddf_str[2] = {static_cast<uint64_t>(f) * 2,
                               static_cast<uint64_t>(d * f) * 2};
  const uint64_t cdd[3] = {static_cast<uint64_t>(d),
                           static_cast<uint64_t>(C),
                           static_cast<uint64_t>(E)};
  const uint64_t cdd_str[2] = {static_cast<uint64_t>(d) * 2,
                               static_cast<uint64_t>(C * d) * 2};
  const uint32_t box_a[3] = {kWK, kWM, 1};        // 64 f x 128 rows of C
  const uint32_t box_wb[3] = {kWK, kWN, 1};       // 64 f x 256 rows of d
  const uint32_t box_64[3] = {64, kWK, 1};        // 64 x 64 rows
  CUtensorMap dy_a, w_b, x_a, dy_b, dx_o, dw_o;
  if (int rc = hopper::make_map(&dy_a, dy, 3, cdf, cdf_str, box_a, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&w_b, w, 3, ddf, ddf_str, box_wb, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&x_a, x, 3, cdd, cdd_str, box_64, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&dy_b, dy, 3, cdf, cdf_str, box_64, true)) {
    return rc;
  }
  // the outputs: dx (E, C, d) and dw (E, d, f), boxes of 64 x 64
  if (int rc = hopper::make_map(&dx_o, dx, 3, cdd, cdd_str, box_64, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&dw_o, dw, 3, ddf, ddf_str, box_64, true)) {
    return rc;
  }
  const WgProduct pdx = wg_product(E, C, d, f, f, nullptr);
  const WgProduct pdw = wg_product(E, d, f, C, chunk, part);
  if (cudaError_t e = cudaFuncSetAttribute(
          gmm_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kWSmem))) {
    return static_cast<int>(e);
  }
  int device = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return static_cast<int>(e);
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device)) {
    return static_cast<int>(e);
  }
  const int64_t tiles = pdx.tiles + pdw.tiles;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  gmm_bwd_wgmma_kernel<<<blocks, kWThreads, kWSmem, st>>>(
      dy_a, w_b, x_a, dy_b, dx_o, dw_o, pdx, pdw, static_cast<int>(E));
  if (pdw.splits > 1) {
    const int64_t n = E * d * f;
    const unsigned sum_blocks = static_cast<unsigned>(
        n / 256 + 1 < 132 * 8 ? n / 256 + 1 : 132 * 8);
    gmm_bwd_split_sum_kernel<<<sum_blocks, 256, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dw), n, pdw.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool TA, bool TB>
void launch_product(const Problem& pr, int dtype, int splits,
                    cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((pr.N + 127) / 128),
                  static_cast<unsigned>((pr.M + 127) / 128),
                  static_cast<unsigned>(pr.E * splits));
  if (dtype == 1) {
    gmm_bwd_tc_kernel<TA, TB><<<grid, kThreads, 0, st>>>(pr);
  } else {
    gmm_bwd_kernel<TA, TB><<<grid, kThreads, 0, st>>>(pr);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, dy, dx and dw).  form: a Form,
// which must suit the dtype (kWgmma: bfloat16 with d and f multiples of 8
// and x, w, dy on 16 bytes; kWmma: bfloat16; kSimt: float32).  chunk: the
// rows of C each split of dw's sum takes, a multiple of 32 (or C itself);
// with more than one split, `part` holds ceil(C / chunk) x E x d x f
// float32 partial sums.  Needs contiguous tensors, E, C, d, f >= 1, C <
// 2^20, d, f < 2^23 and E times the splits <= 65535 (the wrapper checks).
int moe_gmm_bwd(int device, const void* x, const void* w, const void* dy,
                int64_t E, int64_t C, int64_t d, int64_t f, int dtype,
                int form, int64_t chunk, void* part, void* dx, void* dw,
                void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (E < 1 || C < 1 || d < 1 || f < 1 || C >= (1 << 20) || d >= (1 << 23)
      || f >= (1 << 23) || (dtype != 0 && dtype != 1) || chunk < 1
      || (chunk < C && chunk % 32 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t splits = (C + chunk - 1) / chunk;
  if (E * splits > 65535 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tma = dtype == 1 && d % 8 == 0 && f % 8 == 0 && aligned16(x)
                   && aligned16(w) && aligned16(dy);
  const bool fits = form == kWgmma ? tma
                    : form == kWmma ? dtype == 1
                    : form == kSimt && dtype == 0;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form == kWgmma) {
    return launch_bwd_wgmma(x, w, dy, E, C, d, f, chunk,
                            static_cast<float*>(part), dx, dw, st);
  }
  const int64_t size = dtype == 1 ? 2 : 4;
  const int vec = (d * size) % 16 == 0 && (f * size) % 16 == 0
                  && aligned16(x) && aligned16(w) && aligned16(dy);
  const int Ei = static_cast<int>(E), Ci = static_cast<int>(C);
  const int di = static_cast<int>(d), fi = static_cast<int>(f);
  // dx = dy w^T: the sum over f within a block
  const Problem pdx{dy, w, C * f, d * f, fi, fi, Ci, di, fi, fi, Ei, dx,
                    nullptr, vec};
  launch_product<false, true>(pdx, dtype, 1, st);
  // dw = x^T dy: the sum over C split over blocks
  const Problem pdw{x, dy, C * d, C * f, di, fi, di, fi, Ci,
                    static_cast<int>(chunk < C ? chunk : C), Ei, dw,
                    splits > 1 ? static_cast<float*>(part) : nullptr, vec};
  launch_product<true, false>(pdw, dtype, static_cast<int>(splits), st);
  if (splits > 1) {
    const int64_t n = E * d * f;
    const unsigned blocks = static_cast<unsigned>(
        n / 256 + 1 < 132 * 8 ? n / 256 + 1 : 132 * 8);
    const float* p = static_cast<const float*>(part);
    if (dtype == 1) {
      gmm_bwd_split_sum_kernel<<<blocks, 256, 0, st>>>(
          p, static_cast<__nv_bfloat16*>(dw), n, static_cast<int>(splits));
    } else {
      gmm_bwd_split_sum_kernel<<<blocks, 256, 0, st>>>(
          p, static_cast<float*>(dw), n, static_cast<int>(splits));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
