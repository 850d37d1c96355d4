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
//              dtype), the last h (B, di, kDs) float32 and, where ckpt is
//              not null, the state entering every kChunk-th step (ssm.cuh)
//
// softplus is JAX's logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|)).
//
// Bound: the exponentials, kDs decays and the softplus's one a (b, t, c),
// on the SFUs (16 an SM a clock); the bytes (x, dt_pre and out, 8 a
// (b, t, c) in bfloat16) come close behind.  The issue slots come next:
// a state takes five instructions a step (the decay's multiply, its ex2,
// dt x times B, the update's and y's multiply-adds), which at 4 warp
// instructions an SM a clock is 0.64 ms at jamba's prefill, before
// anything else a step does.
//
// Design: a thread takes a (b, c), its kDs states in registers for the
// whole scan with their A and D, so h never leaves the SM; a block of
// kThreads takes kChannels channels of one batch row (grid: di / kChannels
// x B; 64 channels, 1,024 blocks of 2 warps at jamba's prefill, all
// resident at 8 blocks an SM).  The steps run in tiles of kTile through
// two shared-memory buffers: while a tile runs, the block's cp.async
// copies (16-byte pieces spread over the threads) bring the next tile's x
// and dt_pre columns and B and C rows; two barriers a tile.  Each step
// takes its softplus first, by one SFU ex2 and a polynomial for log1p
// (ssm.cuh: log1pf cost some 30 instructions a step), then its decays,
// 2^(dt A log2 e) with A log2 e kept per state: one multiply and one SFU
// ex2.approx.ftz each (2 ulp; a decay below 2^-126 flushes to 0).  The
// decays do not depend on h, so the chain a step is kDs multiply-adds; y
// is one chain of them too, which takes fewer instructions than a tree.
// A whole tile runs with no test a step; the last, short one steps in a
// loop.  The outputs of a tile, and the states entering its chunks where
// the backward needs them, are staged in shared memory and leave as
// 16-byte stores after the tile.
//
// tools/bwd_split.py builds and times the alternatives as text edits of
// this file; each ran slower: 2 or 4 threads a channel (more warps, but
// each thread repeats the step's own work), other blocks and tiles, y as
// a tree, and a share of the decays on the FMA pipes (an exponential
// there takes some ten issue slots, where the SFU's takes one).

#include <cstddef>

#include "ssm.cuh"

namespace {

using namespace ssm;

constexpr int kThreads = 64;               // threads a block, a channel each
constexpr int kChannels = kThreads;
constexpr int kMinBlocks = 8;              // blocks an SM (the launch bound)
constexpr int kTile = 16;                  // steps a tile
static_assert(kTile % kChunk == 0, "tile of chunks");

// One tile of the block's inputs for kTile steps: dt_pre and x for its
// kChannels channels, B and C (kDs each).
template <typename T>
struct __align__(16) Tile {
  float dt[kTile][kChannels];
  float bc[kTile][2 * kDs];            // [step][B | C]
  T x[kTile][kChannels];
};

// The block's shared memory: two tiles of inputs, and a tile's outputs and
// the states entering its chunks, staged for 16-byte stores.  A channel's
// row of kDs states is 4 pieces of 16 bytes, piece q kept at q ^ ((channel
// >> 1) & 3), so that the 8 threads of a store phase write 8 different
// bank groups.
template <typename T>
struct __align__(16) Smem {
  Tile<T> tile[2];
  T out[kTile][kChannels];
  float4 ck[kTile / kChunk][kChannels][kDs / 4];
};

__device__ __forceinline__ int ck_piece(int channel, int q) {
  return q ^ ((channel >> 1) & 3);
}

// The states staged in sm.ck for the chunks of the tile from t0 (those
// below S) into ckpt: the block's kChannels x kDs floats of a chunk are one
// run of the (B, n_ck, di, kDs) tensor, written as 16-byte stores.
template <typename T>
__device__ __forceinline__ void store_ck(const Smem<T>& sm, float* ckpt,
                                         int64_t b, int64_t n_ck, int64_t t0,
                                         int64_t S, int64_t c0, int64_t di,
                                         int tid) {
  constexpr int kPieces = kChannels * kDs / 4;
#pragma unroll
  for (int e = 0; e < kTile / kChunk; ++e) {
    if (t0 + e * kChunk >= S) break;
    float4* dst = reinterpret_cast<float4*>(
        ckpt + ((b * n_ck + t0 / kChunk + e) * di + c0) * kDs);
#pragma unroll
    for (int u = tid; u < kPieces; u += kThreads) {
      const int r = u / (kDs / 4), q = u % (kDs / 4);
      if (c0 + r < di) dst[u] = sm.ck[e][r][ck_piece(r, q)];
    }
  }
}

// The cp.async copies of the tile of steps t0 .. (those below S) into
// `tile`, as 16-byte pieces spread over the block's threads.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& tile, const T* x,
                                          const float* dt_pre,
                                          const float* bm, const float* cm,
                                          int64_t row0, int64_t t0, int64_t S,
                                          int64_t c0, int64_t di, int tid) {
  copy_rows<kTile, kChannels, kThreads>(&tile.x[0][0], x, row0, t0, S, c0,
                                        di, tid);
  copy_rows<kTile, kChannels, kThreads>(&tile.dt[0][0], dt_pre, row0, t0, S,
                                        c0, di, tid);
  copy_bc<kTile, kThreads>(tile.bc, bm, cm, row0, t0, S, tid);
}

// kSave: the states entering the chunks are written to ckpt (training);
// without it (serving) the tile's steps hold no test for them, and the
// launch leaves the staging space out of the block's shared memory
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt_pre,
                const float* __restrict__ dt_bias,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ d_skip,
                const float* __restrict__ h0, int64_t S, int64_t di,
                T* __restrict__ out, float* __restrict__ h_last,
                float* __restrict__ ckpt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int chl = tid;                         // the block's channel
  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t c = c0 + chl;
  const bool live = c < di;
  const int64_t row0 = b * S;                  // (b, 0) as a row of (B, S)
  const int64_t n_ck = (S + kChunk - 1) / kChunk;
  const int64_t state0 = (b * di + c) * kDs;

  load_tile(sm.tile[0], x, dt_pre, bm, cm, row0, 0, S, c0, di, tid);
  cp_commit();

  float a[kDs], h[kDs];
  float bias = 0.f, dskip = 0.f;
#pragma unroll
  for (int n = 0; n < kDs; ++n) {
    a[n] = live ? -expf(a_log[c * kDs + n]) * kLog2e : 0.f;
    h[n] = live && h0 != nullptr ? h0[state0 + n] : 0.f;
  }
  if (live) {
    bias = dt_bias[c];
    dskip = d_skip[c];
  }

  for (int64_t t0 = 0, j = 0; t0 < S; t0 += kTile, ++j) {
    const Tile<T>& cur = sm.tile[j & 1];
    if (t0 + kTile < S) {
      load_tile(sm.tile[(j + 1) & 1], x, dt_pre, bm, cm, row0, t0 + kTile, S,
                c0, di, tid);
    }
    cp_commit();
    cp_wait<1>();                    // this thread's copies of tile j
    __syncthreads();                 // everyone's; the last tile stored
    // step k of the tile with its dt: the state entering a chunk staged
    // for ckpt, then the update and y
    const auto step = [&](int k, float dt) {
      if (kSave && k % kChunk == 0) {
#pragma unroll
        for (int i = 0; i < kDs / 4; ++i) {
          sm.ck[k / kChunk][chl][ck_piece(chl, i)] =
              make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
        }
      }
      const float xv = to_float(cur.x[k][chl]);
      const float dtx = dt * xv;
      const float* brow = &cur.bc[k][0];
      const float* crow = &cur.bc[k][kDs];
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kDs; ++n) {
        const float decay = ex2(dt * a[n]);
        h[n] = fmaf(decay, h[n], dtx * brow[n]);
        y = fmaf(h[n], crow[n], y);
      }
      sm.out[k][chl] = from_float<T>(fmaf(dskip, xv, y));
    };
    if (S - t0 >= kTile) {           // a whole tile: no test a step
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float v = cur.dt[k][chl] + bias;
        step(k, softplus_of(v, exp_neg_abs(v)));
      }
    } else {                         // the last tile's steps
#pragma unroll 1
      for (int k = 0; k < S - t0; ++k) {
        const float v = cur.dt[k][chl] + bias;
        step(k, softplus_of(v, exp_neg_abs(v)));
      }
    }
    __syncthreads();                 // tile j read, its outputs staged
    store_rows<kTile, kChannels, kThreads>(out, &sm.out[0][0], row0, t0, S,
                                           c0, di, tid);
    if (kSave) store_ck(sm, ckpt, b, n_ck, t0, S, c0, di, tid);
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kDs; ++n) h_last[state0 + n] = h[n];
  }
}

template <typename T, bool kSave>
int launch_scan(const void* x, const float* dt_pre, const float* dt_bias,
                const float* bm, const float* cm, const float* a_log,
                const float* d_skip, const float* h0, int64_t B, int64_t S,
                int64_t di, void* out, float* h_last, float* ckpt,
                cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  const int smem = static_cast<int>(kSave ? sizeof(Smem<T>)
                                          : offsetof(Smem<T>, ck));
  const auto kernel = ssm_scan_kernel<T, kSave>;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) {
    return static_cast<int>(e);
  }
  // every block of the grid resident at once wants most of the SM's
  // 256 KB as shared memory
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), dt_pre, dt_bias, bm, cm, a_log, d_skip, h0,
      S, di, static_cast<T*>(out), h_last, ckpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan(const void* x, const float* dt_pre, const float* dt_bias,
                const float* bm, const float* cm, const float* a_log,
                const float* d_skip, const float* h0, int64_t B, int64_t S,
                int64_t di, void* out, float* h_last, float* ckpt,
                cudaStream_t st) {
  return ckpt != nullptr
             ? launch_scan<T, true>(x, dt_pre, dt_bias, bm, cm, a_log,
                                    d_skip, h0, B, S, di, out, h_last, ckpt,
                                    st)
             : launch_scan<T, false>(x, dt_pre, dt_bias, bm, cm, a_log,
                                     d_skip, h0, B, S, di, out, h_last,
                                     ckpt, st);
}

}  // namespace

extern "C" {

// x (B, S, di) in the dtype flag's type, dt_pre (B, S, di), bm and cm
// (B, S, ds), a_log (di, ds), dt_bias and d_skip (di), h0 (B, di, ds) or
// null: float32, contiguous, on 16-byte boundaries, di a multiple of 8;
// out like x, h_last (B, di, ds) float32, ckpt (B, ceil(S / kChunk), di,
// ds) float32 or null.  ds must be kDs.
int ssm_scan(int device, const void* x, const void* dt_pre,
             const void* dt_bias, const void* bm, const void* cm,
             const void* a_log, const void* d_skip, const void* h0,
             int64_t B, int64_t S, int64_t di, int64_t ds, int dtype,
             void* out, void* h_last, void* ckpt, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (ds != kDs || B < 1 || B > 65535 || S < 0 || di < 1 || di % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto hl = static_cast<float*>(h_last);
  const auto ck = static_cast<float*>(ckpt);
  if (dtype == 0) {
    return launch_scan<float>(x, f(dt_pre), f(dt_bias), f(bm), f(cm),
                              f(a_log), f(d_skip), f(h0), B, S, di, out, hl,
                              ck, st);
  }
  if (dtype == 1) {
    return launch_scan<__nv_bfloat16>(x, f(dt_pre), f(dt_bias), f(bm), f(cm),
                                      f(a_log), f(d_skip), f(h0), B, S, di,
                                      out, hl, ck, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
