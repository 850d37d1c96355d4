// Hopper (sm_90a) kernel of the Mamba scan's gradient (jamba's training):
// the reverse time scan of csrc/ssm.cu.  For each (b, c), state n and
// step t, in float32, with v = dt_pre + dt_bias, dt = softplus(v), decay_t
// = exp(dt_t A_n), A = -exp(A_log) and g_t = dL/dh_t:
//
//   g_t     = dy_t C_t + decay_{t+1} g_{t+1}      (from dh_last, or 0)
//   u_t     = sum_n g_t B_t
//   dx_t    = dt_t u_t + D dy_t
//   ddt_t   = x_t u_t + sum_n A_n decay_t g_t h_{t-1}
//   ddt_pre = ddt_t sigmoid(v_t)
//   dB_t   += sum_c g_t dt_t x_t          dC_t += sum_c dy_t h_t
//   dA_n   += sum_{b,t} dt_t decay_t g_t h_{t-1}, dA_log = dA A
//   dD     += sum_{b,t} dy x              ddt_bias = sum_{b,t} ddt_pre
//   dh0     = decay_1 g_1
//
// Replaces no Pallas kernel: the JAX package differentiates its associative
// scan (src/repro/models/mamba.py:46), so this is the gradient of the
// forward kernel.  One plain C launcher (loaded with ctypes by
// src/repro_torch/kernels/_build.py): device index, raw device pointers,
// sizes, the dtype flag of x, dy and dx (0 = float32, 1 = bfloat16), two
// float32 scratch buffers and a cudaStream_t; allocates nothing and returns
// the first CUDA error.
//
// Bound: the bytes (x, dt_pre, dy in, dx, ddt_pre out, the saved states
// read once); then the exponentials, each decay once, on the SFUs.  What
// holds a kernel back is the issue slots and their latency: the step back
// takes nine instructions a (channel, state), the recomputed states four
// more and dC's term one, some 225 a (b, t, channel) before anything else.
// So the design keeps the other instructions few:
//
// ssm_bwd_kernel: a thread takes kCh channels x kSt states (4 x 4): lane
// bits 0-1 pick the states (kSt p .. kSt p + 3), bits 2-4 the channels
// (kCh q .. of the warp's kWarpCh); a block of kWarps warps takes kChannels
// = kThreads channels of one batch row (grid: di / kChannels x B), and
// thread tid owns channel tid for the per-channel work.  The chunks of
// kChunk steps between the forward's saved states (ssm.cuh) go from the
// last to the first; the block's cp.async copies bring a chunk's x,
// dt_pre, dy, B, C and its entering state into one of two buffers while
// the other chunk runs.  Each chunk:
//   * the owner of a channel takes its softplus, sigmoid, dt x and dy as
//     float32 once a (b, t, channel) into shared memory, and dD's terms;
//   * the forward recomputes the chunk's states from the entering one,
//     each thread its 16 (channel, state) pairs, the states entering
//     steps 1 .. kChunk - 1 kept in registers (a spacing of 16 would not
//     fit), and takes dC's terms dy_t h_t summed over the thread's
//     channels as they come;
//   * the step back takes each decay again on the SFU (kept from the
//     forward they would not fit), u and the A q sum over the thread's
//     states, then over the channel's 4 lanes by a reduce-scatter of two
//     shuffle rounds that leaves the owner both; dB's terms summed over the
//     thread's channels;
//   * dB's and dC's terms (a thread's 4 channels' sums, 16-byte stores a
//     step) are added over the block's threads in a fixed order after the
//     chunk and leave as the block's partial, part_bc (B, S, di /
//     kChannels, 2 kDs); dx and ddt_pre are staged and leave as 16-byte
//     stores.  dA, dD and ddt_bias stay in registers over the row's steps
//     and go out as the row's partials, part_ch (B, di, kDs + 2).
// The copies and stores take a fixed count of 16-byte pieces a thread,
// their addresses from one row pointer a chunk.
//
// ssm_bwd_sum_kernel: dB and dC as each (b, t, n)'s partials added in
// block order, dA_log, dD and ddt_bias as each channel's added in row
// order.  No atomics: two launches on the same inputs are bit-equal.
//
// tools/bwd_split.py builds the layouts and trials this was measured
// against as text edits of this file.

#include <type_traits>

#include "ssm.cuh"

namespace {

using namespace ssm;

constexpr int kSt = 4;                     // states a thread
constexpr int kGroups = kDs / kSt;         // threads a channel (BWD_LANES)
constexpr int kCh = 4;                     // channels a thread
constexpr int kWarpCh = 32 / kGroups * kCh;    // channels a warp
constexpr int kWarps = 2;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChannels = kWarps * kWarpCh;    // ssm_scan.BWD_CHANNELS
constexpr int kMinBlocks = 4;              // blocks an SM (the launch bound)
constexpr int kK = kChunk;                 // steps a chunk
constexpr int kSums = 2 * kDs;             // a step's dB | dC
constexpr int kPieces = kSums / 4;         // .. as 16-byte pieces
constexpr int kPartCh = kDs + 2;           // dA (kDs), dD, ddt_bias
static_assert(kGroups == 4 && kCh == 4, "the lanes' layout");
static_assert(kChannels == kThreads, "a thread owns a channel");

template <typename T>
struct __align__(16) BwdTile {
  float dt[kK][kChannels];             // dt_pre
  float bc[kK][kSums];                 // [step][B | C]
  float4 h0[kChannels][kDs / 4];       // the state entering the chunk
  T x[kK][kChannels];
  T dy[kK][kChannels];
};

// The block's shared memory: two chunks of inputs; a chunk's per-channel
// values as float32; each thread's dB | dC terms a step, [warp][step][q]
// (q = lane >> 2), the two halves of a row swapped where q is odd, so that
// a quarter warp's 16-byte stores reach 32 banks; the outputs, staged.
template <typename T>
struct __align__(16) BwdSmem {
  BwdTile<T> tile[2];
  float dt[kK][kChannels];             // softplus(v)
  float dtx[kK][kChannels];            // dt x
  float dy[kK][kChannels];
  float sg[kK][kChannels];             // sigmoid(v)
  float4 red[kWarps][kK][32 / kGroups][kPieces];
  T dx[kK][kChannels];
  float ddt[kK][kChannels];
};

// The cp.async copies of `rows` steps of a (B, S, di) tensor's block
// columns into dst[kK][kChannels]: `src` at the first row's first column,
// `live` columns (a multiple of 16 bytes); each thread a fixed count of
// 16-byte pieces
template <typename T>
__device__ __forceinline__ void copy_chunk_rows(T* dst, const T* src,
                                                int64_t di, int rows,
                                                int live, int tid) {
  constexpr int kEach = 16 / sizeof(T), kRow = kChannels / kEach;
  constexpr int kAll = kK * kRow;
#pragma unroll
  for (int r = 0; r < (kAll + kThreads - 1) / kThreads; ++r) {
    const int i = tid + r * kThreads, k = i / kRow, e = i % kRow * kEach;
    if ((kAll % kThreads == 0 || i < kAll) && k < rows && e < live) {
      cp_async16(dst + k * kChannels + e, src + k * di + e);
    }
  }
}

// the staged outputs' pieces back out (copy_chunk_rows the other way)
template <typename T>
__device__ __forceinline__ void store_chunk_rows(T* dst, const T* src,
                                                 int64_t di, int rows,
                                                 int live, int tid) {
  constexpr int kEach = 16 / sizeof(T), kRow = kChannels / kEach;
  constexpr int kAll = kK * kRow;
#pragma unroll
  for (int r = 0; r < (kAll + kThreads - 1) / kThreads; ++r) {
    const int i = tid + r * kThreads, k = i / kRow, e = i % kRow * kEach;
    if ((kAll % kThreads == 0 || i < kAll) && k < rows && e < live) {
      *reinterpret_cast<uint4*>(dst + k * di + e) =
          *reinterpret_cast<const uint4*>(src + k * kChannels + e);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_chunk(BwdTile<T>& tile, const T* x,
                                           const float* dt_pre, const T* dy,
                                           const float* bm, const float* cm,
                                           const float* ckpt, int64_t b,
                                           int64_t n_ck, int64_t jc,
                                           int64_t S, int64_t c0, int64_t di,
                                           int tid) {
  const int64_t t0 = jc * kK, row = b * S + t0, at = row * di + c0;
  const int rows = S - t0 < kK ? static_cast<int>(S - t0) : kK;
  const int live = di - c0 < kChannels ? static_cast<int>(di - c0)
                                       : kChannels;
  copy_chunk_rows(&tile.x[0][0], x + at, di, rows, live, tid);
  copy_chunk_rows(&tile.dy[0][0], dy + at, di, rows, live, tid);
  copy_chunk_rows(&tile.dt[0][0], dt_pre + at, di, rows, live, tid);
  // B and C: a step's 2 x 4 pieces
#pragma unroll
  for (int r = 0; r < (kK * 8 + kThreads - 1) / kThreads; ++r) {
    const int i = tid + r * kThreads, k = i / 8, e = i % 8;
    if (((kK * 8) % kThreads == 0 || i < kK * 8) && k < rows) {
      cp_async16(&tile.bc[k][4 * e], (e < 4 ? bm : cm) + (row + k) * kDs
                                         + 4 * (e % 4));
    }
  }
  // the block's live channels' entering states: one run of floats
  const float* h = ckpt + ((b * n_ck + jc) * di + c0) * kDs;
#pragma unroll
  for (int r = 0; r < kChannels * kDs / 4 / kThreads; ++r) {
    const int u = tid + r * kThreads;
    if (u / (kDs / 4) < live) {
      cp_async16(&tile.h0[u / (kDs / 4)][u % (kDs / 4)], h + 4 * u);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// component i (a constant) of v
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the thread's kCh x kSt pairs of the chunk's entering state
template <typename T>
__device__ __forceinline__ void load_entry(const BwdTile<T>& tile, int cb,
                                           int p, float (&h)[kCh][kSt]) {
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    const float4 v = tile.h0[cb + j][p];
#pragma unroll
    for (int i = 0; i < kSt; ++i) h[j][i] = comp(v, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt_pre,
               const float* __restrict__ dt_bias,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ a_log,
               const float* __restrict__ d_skip,
               const float* __restrict__ ckpt, const T* __restrict__ dy,
               const float* __restrict__ dh_last, int64_t S, int64_t di,
               T* __restrict__ dx, float* __restrict__ ddt_pre,
               float* __restrict__ part_bc, float* __restrict__ part_ch,
               float* __restrict__ dh0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int p = lane & (kGroups - 1);          // states kSt p + n
  const int q = lane / kGroups;                // channels cb + j
  const int cb = warp * kWarpCh + kCh * q;     // (of the block's)
  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t n_ck = (S + kK - 1) / kK;
  const int64_t nblk = gridDim.x;
  const int live = di - c0 < kChannels ? static_cast<int>(di - c0)
                                       : kChannels;
  const bool owns = tid < live;                // the owned channel is live

  float a2[kCh][kSt], g_in[kCh][kSt], da[kCh][kSt];
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    const int64_t c = c0 + cb + j;
    const bool on = cb + j < live;
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      const int64_t at = c * kDs + kSt * p + n;
      a2[j][n] = on ? -expf(a_log[at]) * kLog2e : 0.f;
      g_in[j][n] = on && dh_last != nullptr ? dh_last[b * di * kDs + at]
                                            : 0.f;
      da[j][n] = 0.f;
    }
  }
  float bias = 0.f, dskip = 0.f, dd = 0.f, dbias = 0.f;
  if (owns) {
    bias = dt_bias[c0 + tid];
    dskip = d_skip[c0 + tid];
  } else {
    // a channel past di is never copied: zeros keep it finite (dt =
    // softplus(0), x = dy = 0, h = g = 0), so it adds nothing to the sums
    for (auto& t : sm.tile) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        t.dt[k][tid] = 0.f;
        t.x[k][tid] = from_float<T>(0.f);
        t.dy[k][tid] = from_float<T>(0.f);
      }
#pragma unroll
      for (int i = 0; i < kDs / 4; ++i) t.h0[tid][i] = make_float4(0, 0, 0, 0);
    }
  }
  if (n_ck > 0) {
    load_chunk(sm.tile[0], x, dt_pre, dy, bm, cm, ckpt, b, n_ck, n_ck - 1, S,
               c0, di, tid);
  }
  cp_commit();

  for (int64_t i = 0; i < n_ck; ++i) {
    const int64_t jc = n_ck - 1 - i, t0 = jc * kK;
    const BwdTile<T>& cur = sm.tile[i & 1];
    if (jc > 0) {
      load_chunk(sm.tile[(i + 1) & 1], x, dt_pre, dy, bm, cm, ckpt, b, n_ck,
                 jc - 1, S, c0, di, tid);
    }
    cp_commit();
    cp_wait<1>();                    // this thread's copies of chunk jc
    __syncthreads();                 // everyone's; the last chunk flushed
    const int steps = S - t0 < kK ? static_cast<int>(S - t0) : kK;

    // `whole` (a constant) drops the test a step for a chunk of kK steps
    const auto run = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      // the owned channel's per-step values, once a (b, t, channel)
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (kWhole || k < steps) {
          const float v = cur.dt[k][tid] + bias;
          const float e = exp_neg_abs(v);
          const float r = __fdividef(1.f, 1.f + e);
          const float dt = softplus_of(v, e);
          const float xv = to_float(cur.x[k][tid]);
          const float dyv = to_float(cur.dy[k][tid]);
          sm.dt[k][tid] = dt;
          sm.dtx[k][tid] = dt * xv;
          sm.dy[k][tid] = dyv;
          sm.sg[k][tid] = v >= 0.f ? r : e * r;
          dd = fmaf(dyv, xv, dd);
        }
      }
      __syncwarp();                  // a warp reads its own channels only

      // the chunk's states: hist[k] enters step k (k >= 1; the entering
      // state is read again from the tile), dC's terms as they come
      float hist[kK][kCh][kSt];
      float h[kCh][kSt];
      load_entry(cur, cb, p, h);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (kWhole || k < steps) {
          const float4 dt4 = ld4(&sm.dt[k][cb]);
          const float4 dx4 = ld4(&sm.dtx[k][cb]);
          const float4 dy4 = ld4(&sm.dy[k][cb]);
          const float4 b4 = ld4(&cur.bc[k][kSt * p]);
          float dc[kSt] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kCh; ++j) {
#pragma unroll
            for (int n = 0; n < kSt; ++n) {
              h[j][n] = fmaf(ex2(comp(dt4, j) * a2[j][n]), h[j][n],
                             comp(dx4, j) * comp(b4, n));
              dc[n] = fmaf(comp(dy4, j), h[j][n], dc[n]);
            }
          }
          if (k + 1 < kK) {
#pragma unroll
            for (int j = 0; j < kCh; ++j) {
#pragma unroll
              for (int n = 0; n < kSt; ++n) hist[k + 1][j][n] = h[j][n];
            }
          }
          sm.red[warp][k][q][((q & 1) ^ 1) * kGroups + p] =
              make_float4(dc[0], dc[1], dc[2], dc[3]);
        }
      }

      // the step back
#pragma unroll
      for (int k = kK - 1; k >= 0; --k) {
        if (kWhole || k < steps) {
          const float4 dt4 = ld4(&sm.dt[k][cb]);
          const float4 dx4 = ld4(&sm.dtx[k][cb]);
          const float4 dy4 = ld4(&sm.dy[k][cb]);
          const float4 b4 = ld4(&cur.bc[k][kSt * p]);
          const float4 c4 = ld4(&cur.bc[k][kDs + kSt * p]);
          float hk[kCh][kSt];
          if (k == 0) {
            load_entry(cur, cb, p, hk);
          } else {
#pragma unroll
            for (int j = 0; j < kCh; ++j) {
#pragma unroll
              for (int n = 0; n < kSt; ++n) hk[j][n] = hist[k][j][n];
            }
          }
          float u[kCh], s[kCh], db[kSt] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kCh; ++j) {
            u[j] = 0.f;
            s[j] = 0.f;
#pragma unroll
            for (int n = 0; n < kSt; ++n) {
              const float decay = ex2(comp(dt4, j) * a2[j][n]);
              const float g = fmaf(comp(dy4, j), comp(c4, n), g_in[j][n]);
              u[j] = fmaf(g, comp(b4, n), u[j]);
              db[n] = fmaf(g, comp(dx4, j), db[n]);
              const float dg = decay * g;
              const float qv = dg * hk[j][n];
              s[j] = fmaf(a2[j][n], qv, s[j]);        // A log2 e q
              da[j][n] = fmaf(comp(dt4, j), qv, da[j][n]);
              g_in[j][n] = dg;
            }
          }
          sm.red[warp][k][q][(q & 1) * kGroups + p] =
              make_float4(db[0], db[1], db[2], db[3]);
          // u and s over the channel's lanes: lane p keeps channel cb + p
          // (the owned one); each round sends half of what a lane keeps
          const bool hi = lane & 2, lo = lane & 1;
          float u2[2], s2[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            u2[m] = (hi ? u[m + 2] : u[m])
                    + __shfl_xor_sync(0xffffffffu, hi ? u[m] : u[m + 2], 2);
            s2[m] = (hi ? s[m + 2] : s[m])
                    + __shfl_xor_sync(0xffffffffu, hi ? s[m] : s[m + 2], 2);
          }
          const float uo = (lo ? u2[1] : u2[0])
                           + __shfl_xor_sync(0xffffffffu, lo ? u2[0] : u2[1],
                                             1);
          const float so = (lo ? s2[1] : s2[0])
                           + __shfl_xor_sync(0xffffffffu, lo ? s2[0] : s2[1],
                                             1);
          const float ddtp = fmaf(to_float(cur.x[k][tid]), uo, so * kLn2)
                             * sm.sg[k][tid];
          sm.dx[k][tid] = from_float<T>(fmaf(sm.dt[k][tid], uo,
                                             dskip * sm.dy[k][tid]));
          sm.ddt[k][tid] = ddtp;
          dbias += ddtp;
        }
      }
    };
    if (steps == kK) {
      run(std::true_type{});
    } else {
      run(std::false_type{});
    }
    __syncthreads();                 // the chunk's outputs staged
    const int64_t at = (b * S + t0) * di + c0;
    store_chunk_rows(dx + at, &sm.dx[0][0], di, steps, live, tid);
    store_chunk_rows(ddt_pre + at, &sm.ddt[0][0], di, steps, live, tid);
    // each step's dB | dC over the block's threads: warps, then q, in order
#pragma unroll
    for (int e = tid; e < kK * kPieces; e += kThreads) {
      const int k = e / kPieces, g4 = e % kPieces;
      if (k < steps) {
        float4 sum = sm.red[0][k][0][g4];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
          for (int r = w == 0 ? 1 : 0; r < 32 / kGroups; ++r) {
            const float4 v = sm.red[w][k][r][g4 ^ ((r & 1) * kGroups)];
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
        }
        *reinterpret_cast<float4*>(
            part_bc + ((b * S + t0 + k) * nblk + blockIdx.x) * kSums
            + 4 * g4) = sum;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    const int64_t c = c0 + cb + j;
    if (cb + j < live) {
      float* pc = part_ch + (b * di + c) * kPartCh;
#pragma unroll
      for (int n = 0; n < kSt; ++n) {
        pc[kSt * p + n] = da[j][n];
        if (dh0 != nullptr) dh0[(b * di + c) * kDs + kSt * p + n] = g_in[j][n];
      }
    }
  }
  if (owns) {
    float* pc = part_ch + (b * di + c0 + tid) * kPartCh;
    pc[kDs] = dd;
    pc[kDs + 1] = dbias;
  }
}

// dB and dC: each (b, t, n)'s partials in block order; dA_log, dD and
// ddt_bias: each channel's in row order
__global__ void ssm_bwd_sum_kernel(const float* __restrict__ part_bc,
                                   const float* __restrict__ part_ch,
                                   const float* __restrict__ a_log,
                                   int64_t B, int64_t S, int64_t di,
                                   int64_t nblk, float* __restrict__ dbm,
                                   float* __restrict__ dcm,
                                   float* __restrict__ da_log,
                                   float* __restrict__ d_skip,
                                   float* __restrict__ d_bias) {
  const int64_t n_bc = B * S * kSums, n_ch = di * kPartCh;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n_bc + n_ch; i += stride) {
    if (i < n_bc) {
      const int64_t row = i / kSums;
      const int o = static_cast<int>(i % kSums);
      const float* p = part_bc + row * nblk * kSums + o;
      float sum = 0.f;
      for (int64_t k = 0; k < nblk; ++k) sum += p[k * kSums];
      (o < kDs ? dbm : dcm)[row * kDs + o % kDs] = sum;
    } else {
      const int64_t e = i - n_bc, c = e / kPartCh;
      const int o = static_cast<int>(e % kPartCh);
      float sum = 0.f;
      for (int64_t b = 0; b < B; ++b) sum += part_ch[(b * di + c) * kPartCh
                                                     + o];
      if (o < kDs) {
        da_log[c * kDs + o] = sum * -expf(a_log[c * kDs + o]);
      } else if (o == kDs) {
        d_skip[c] = sum;
      } else {
        d_bias[c] = sum;
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const float* dt_pre, const float* dt_bias,
               const float* bm, const float* cm, const float* a_log,
               const float* d_skip, const float* ckpt, const void* dy,
               const float* dh_last, int64_t B, int64_t S, int64_t di,
               float* part_bc, float* part_ch, void* dx, float* ddt_pre,
               float* dbm, float* dcm, float* da_log, float* dd,
               float* dbias, float* dh0, cudaStream_t st) {
  const int64_t nblk = (di + kChannels - 1) / kChannels;
  const int smem = static_cast<int>(sizeof(BwdSmem<T>));
  if (cudaError_t e = cudaFuncSetAttribute(
          ssm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem)) {
    return static_cast<int>(e);
  }
  cudaFuncSetAttribute(ssm_bwd_kernel<T>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  ssm_bwd_kernel<T><<<dim3(static_cast<unsigned>(nblk),
                           static_cast<unsigned>(B)), kThreads, smem, st>>>(
      static_cast<const T*>(x), dt_pre, dt_bias, bm, cm, a_log, d_skip, ckpt,
      static_cast<const T*>(dy), dh_last, S, di, static_cast<T*>(dx),
      ddt_pre, part_bc, part_ch, dh0);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int64_t total = B * S * kSums + di * kPartCh;
  const int64_t blocks = (total + 255) / 256;
  ssm_bwd_sum_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                       256, 0, st>>>(part_bc, part_ch, a_log, B, S, di, nblk,
                                     dbm, dcm, da_log, dd, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and dy (B, S, di) in the dtype flag's type; dt_pre (B, S, di), bm and
// cm (B, S, ds), a_log (di, ds), dt_bias and d_skip (di), ckpt (B, ceil(S
// / kChunk), di, ds) from the forward, dh_last (B, di, ds) or null:
// float32, contiguous, on 16-byte boundaries, di a multiple of 8.
// Scratch: part_bc (B, S, ceil(di / kChannels), 2 ds) and part_ch (B, di,
// ds + 2) float32.  Out: dx like x, ddt_pre (B, S, di), dbm and dcm (B, S,
// ds), da_log (di, ds), dd and dbias (di) float32, dh0 (B, di, ds) float32
// or null.  ds must be kDs.
int ssm_scan_bwd(int device, const void* x, const void* dt_pre,
                 const void* dt_bias, const void* bm, const void* cm,
                 const void* a_log, const void* d_skip, const void* ckpt,
                 const void* dy, const void* dh_last, int64_t B, int64_t S,
                 int64_t di, int64_t ds, int dtype, void* part_bc,
                 void* part_ch, void* dx, void* ddt_pre, void* dbm,
                 void* dcm, void* da_log, void* dd, void* dbias, void* dh0,
                 void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (ds != kDs || B < 1 || B > 65535 || S < 0 || di < 1 || di % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    return launch_bwd<float>(x, f(dt_pre), f(dt_bias), f(bm), f(cm),
                             f(a_log), f(d_skip), f(ckpt), dy, f(dh_last), B,
                             S, di, w(part_bc), w(part_ch), dx, w(ddt_pre),
                             w(dbm), w(dcm), w(da_log), w(dd), w(dbias),
                             w(dh0), st);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(
        x, f(dt_pre), f(dt_bias), f(bm), f(cm), f(a_log), f(d_skip),
        f(ckpt), dy, f(dh_last), B, S, di, w(part_bc), w(part_ch), dx,
        w(ddt_pre), w(dbm), w(dcm), w(da_log), w(dd), w(dbias), w(dh0), st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
