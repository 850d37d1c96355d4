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
// the rows of C a split of dw's sum takes, a float32 scratch for the
// splits' partial sums and a cudaStream_t, allocates nothing and returns
// cudaGetLastError().
//
// Replaces no Pallas kernel: the JAX package differentiates its expert
// products through jnp (src/repro/models/moe.py), so this is the gradient
// of the forward kernel that replaces src/repro/kernels/gmm.py:18.  Bound:
// operations, 4 E C d f, over the bf16 tensor-core peak at a training
// step's C of thousands of rows.
//
// One generic tiled product, out[e] (M x N) = op(A[e]) op(B[e]) over a
// range of K, serves both gradients; the operand that is read transposed
// is staged as it lies in memory (16-byte loads along its contiguous axis)
// and handed to the product in the matching layout:
//
//   * dx: M = C, N = d, K = f; A = dy as it is, B(k, n) = w[n, k].
//   * dw: M = d, N = f, K = C; A(m, k) = x[k, m], B = dy as it is.  The sum
//     over C is split over `splits` blocks of `chunk` rows (a multiple of
//     the k tile) where the output tiles alone leave the card short of
//     blocks (kernels/gmm.py `bwd_chunk`); each split writes its float32
//     partial sums to the scratch and a second pass adds the splits in
//     order and rounds once.  No atomics: one answer every run.
//
// Two forms of the tile, chosen by the dtype:
//   * bfloat16: WMMA 16 x 16 x 16 on 128 x 128 tiles (32 deep), 8 warps of
//     32 x 64 outputs, all 256 threads staging, float32 sums;
//   * float32: the CUDA cores in full float32 (no TF32), 128 x 128 tiles
//     (16 deep) of 8 x 8 outputs a thread.
// Tails of M, N and K read as zeros and are masked on the write, so any
// E, C, d and f run with no padded copy.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <type_traits>

namespace {

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

// dtype: 0 = float32, 1 = bfloat16 (x, w, dy, dx and dw).  chunk: the rows
// of C each split of dw's sum takes, a multiple of 32 (or C itself);
// with more than one split, `part` holds ceil(C / chunk) x E x d x f
// float32 partial sums.  Needs contiguous tensors, E, C, d, f >= 1, C <
// 2^20, d, f < 2^23 and E times the splits <= 65535 (the wrapper checks).
int moe_gmm_bwd(int device, const void* x, const void* w, const void* dy,
                int64_t E, int64_t C, int64_t d, int64_t f, int dtype,
                int64_t chunk, void* part, void* dx, void* dw, void* stream) {
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
  const auto st = static_cast<cudaStream_t>(stream);
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
