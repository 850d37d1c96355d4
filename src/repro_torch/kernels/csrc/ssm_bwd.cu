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
// the first CUDA error.  Two launches:
//
// ssm_bwd_kernel: the forward's layout, kLanes threads of one warp a
// (b, c), kOwn states each; a block of kThreads takes kChannels channels of
// one batch row (grid: di / kChannels x B).  The chunks of kChunk steps go
// from the last to the first.  For each, the block's cp.async copies bring
// x, dt_pre, dy, B and C (two buffers: the next chunk's copies run during
// this one), a thread loads its states' entry from the forward's saved
// states (ckpt, ssm.cuh), recomputes the chunk's kChunk + 1 states into
// registers (h never leaves the SM), then runs the recurrence back with
// the decays taken again on the SFU (the recomputed exponentials are the
// kernel's bound).  u and the A q sum join over a channel's lanes by
// shuffles; the step's dB and dC terms (8 a thread) meet over the warp's 8
// channels in a reduce-scatter of three shuffle rounds, one value a lane,
// staged a warp a row in shared memory; after the chunk each (t, n) is
// added over the block's warps in warp order and written as the block's
// partial, part_bc (B, S, di / kChannels, 2 kDs).  dx and ddt_pre are
// staged and leave as 16-byte stores.  dA, dD and ddt_bias stay in
// registers over the row's steps and go out as the row's partials, part_ch
// (B, di, kDs + 2).
//
// ssm_bwd_sum_kernel: dB and dC as each (b, t, n)'s partials added in
// block order, dA_log, dD and ddt_bias as each channel's added in row
// order.  No atomics: two launches on the same inputs are bit-equal.

#include <type_traits>

#include "ssm.cuh"

namespace {

using namespace ssm;

constexpr int kLanes = 4;                  // threads a channel
constexpr int kOwn = kDs / kLanes;         // states a thread
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;              // blocks an SM (the launch bound)
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = kThreads / kLanes;   // ssm_scan.BWD_CHANNELS
constexpr int kK = kChunk;                 // steps a chunk
constexpr int kPartCh = kDs + 2;           // dA (kDs), dD, ddt_bias
static_assert(kOwn == 4 && kLanes == 4, "the reduce-scatter's layout");

template <typename T>
struct __align__(16) BwdTile {
  float dt[kK][kChannels];             // dt_pre
  float bc[kK][2 * kDs];               // [step][B | C]
  T x[kK][kChannels];
  T dy[kK][kChannels];
};

template <typename T>
struct __align__(16) BwdSmem {
  BwdTile<T> tile[2];
  T dx[kK][kChannels];
  float ddt[kK][kChannels];
  float red[kWarps][kK][32];           // a warp's dB / dC sums a step
};

template <typename T>
__device__ __forceinline__ void load_chunk(BwdTile<T>& tile, const T* x,
                                           const float* dt_pre, const T* dy,
                                           const float* bm, const float* cm,
                                           int64_t row0, int64_t t0,
                                           int64_t S, int64_t c0, int64_t di,
                                           int tid) {
  copy_rows<kK, kChannels, kThreads>(&tile.x[0][0], x, row0, t0, S, c0, di,
                                     tid);
  copy_rows<kK, kChannels, kThreads>(&tile.dy[0][0], dy, row0, t0, S, c0, di,
                                     tid);
  copy_rows<kK, kChannels, kThreads>(&tile.dt[0][0], dt_pre, row0, t0, S, c0,
                                     di, tid);
  copy_bc<kK, kThreads>(tile.bc, bm, cm, row0, t0, S, tid);
}

// a thread's kOwn = 4 saved states, one 16-byte load
__device__ __forceinline__ void load4(float (&h)[kOwn], const float* at) {
  const float4 v = *reinterpret_cast<const float4*>(at);
  h[0] = v.x;
  h[1] = v.y;
  h[2] = v.z;
  h[3] = v.w;
}

// The sums of v[0..7] over the 8 channels of the warp (lane bits 2-4),
// one value a lane: lane l ends with the sum of v[l >> 2] over the lanes
// that share its l & 3.  Three rounds, each halving what a lane keeps.
__device__ __forceinline__ float reduce_scatter8(float (&v)[8], int lane) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? v[i] : v[i + 4];
      const float keep = up ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? v[i] : v[i + 2];
      const float keep = up ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
  const bool up = lane & 4;
  const float send = up ? v[0] : v[1];
  const float keep = up ? v[1] : v[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
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
  const int part = tid % kLanes;               // states part * kOwn + n
  const int chl = tid / kLanes;                // the block's channel
  const int base = lane & ~(kLanes - 1);       // the channel's first lane
  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t c = c0 + chl;
  const bool live = c < di;
  const int64_t row0 = b * S;
  const int64_t n_ck = (S + kK - 1) / kK;
  const int64_t nblk = gridDim.x;
  const int64_t state0 = (b * di + c) * kDs + part * kOwn;

  float a2[kOwn], g_in[kOwn], da[kOwn], hin[kOwn];
  float bias = 0.f, dskip = 0.f, dd = 0.f, dbias = 0.f;
#pragma unroll
  for (int n = 0; n < kOwn; ++n) {
    a2[n] = live ? -expf(a_log[c * kDs + part * kOwn + n]) * kLog2e : 0.f;
    g_in[n] = live && dh_last != nullptr ? dh_last[state0 + n] : 0.f;
    da[n] = 0.f;
    hin[n] = 0.f;
  }
  if (live) {
    bias = dt_bias[c];
    dskip = d_skip[c];
  } else if (part == 0) {
    // a channel past di is never copied: zeros keep its lanes finite (dt
    // = softplus(0), x = dy = 0, h = g = 0), so it adds nothing to the
    // warp's dB and dC sums
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      for (auto& t : sm.tile) {
        t.dt[k][chl] = 0.f;
        t.x[k][chl] = from_float<T>(0.f);
        t.dy[k][chl] = from_float<T>(0.f);
      }
    }
  }
  if (n_ck > 0) {
    load_chunk(sm.tile[0], x, dt_pre, dy, bm, cm, row0, (n_ck - 1) * kK, S,
               c0, di, tid);
    if (live) {
      load4(hin, ckpt + ((b * n_ck + n_ck - 1) * di + c) * kDs
                     + part * kOwn);
    }
  }
  cp_commit();

  for (int64_t i = 0; i < n_ck; ++i) {
    const int64_t jc = n_ck - 1 - i, t0 = jc * kK;
    const BwdTile<T>& cur = sm.tile[i & 1];
    if (jc > 0) {
      load_chunk(sm.tile[(i + 1) & 1], x, dt_pre, dy, bm, cm, row0, t0 - kK,
                 S, c0, di, tid);
    }
    cp_commit();
    cp_wait<1>();                    // this thread's copies of chunk jc
    __syncthreads();                 // everyone's; the last chunk flushed
    const int steps = S - t0 < kK ? static_cast<int>(S - t0) : kK;

    // the chunk's states: hist[k] enters step k, hist[k + 1] leaves it
    float hist[kK + 1][kOwn];
#pragma unroll
    for (int n = 0; n < kOwn; ++n) hist[0][n] = hin[n];
    if (jc > 0 && live) {            // the next chunk's entry, early
      load4(hin, ckpt + ((b * n_ck + jc - 1) * di + c) * kDs + part * kOwn);
    }
    // the chunk's steps, recomputed then run back; `whole` (a constant)
    // drops the test a step for a chunk of kK steps
    const auto run = [&](auto whole) {
      // dt and sigmoid(v) of steps q kLanes + part (one exp serves both)
      float sp[kK / kLanes], sg[kK / kLanes];
#pragma unroll
      for (int q = 0; q < kK / kLanes; ++q) {
        const float v = cur.dt[q * kLanes + part][chl] + bias;
        const float e = exp_neg_abs(v);
        const float r = __frcp_rn(1.f + e);
        sp[q] = softplus_of(v, e);
        sg[q] = v >= 0.f ? r : e * r;
      }
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (decltype(whole)::value || k < steps) {
          const float dt = __shfl_sync(0xffffffffu, sp[k / kLanes],
                                       base | (k % kLanes));
          const float dtx = dt * to_float(cur.x[k][chl]);
          const float* brow = &cur.bc[k][part * kOwn];
#pragma unroll
          for (int n = 0; n < kOwn; ++n) {
            hist[k + 1][n] = fmaf(ex2(dt * a2[n]), hist[k][n],
                                  dtx * brow[n]);
          }
        }
      }
#pragma unroll
      for (int k = kK - 1; k >= 0; --k) {
        if (decltype(whole)::value || k < steps) {
          const float dt = __shfl_sync(0xffffffffu, sp[k / kLanes],
                                       base | (k % kLanes));
          const float sgv = __shfl_sync(0xffffffffu, sg[k / kLanes],
                                        base | (k % kLanes));
          const float xv = to_float(cur.x[k][chl]);
          const float dyv = to_float(cur.dy[k][chl]);
          const float dtx = dt * xv;
          const float* brow = &cur.bc[k][part * kOwn];
          const float* crow = &cur.bc[k][kDs + part * kOwn];
          float v[8];
          float u = 0.f, s = 0.f;
#pragma unroll
          for (int n = 0; n < kOwn; ++n) {
            const float decay = ex2(dt * a2[n]);
            const float g = fmaf(dyv, crow[n], g_in[n]);
            v[n] = g * dtx;                        // dB's term
            v[kOwn + n] = dyv * hist[k + 1][n];    // dC's term
            u = fmaf(g, brow[n], u);
            const float q = decay * g * hist[k][n];
            s = fmaf(a2[n], q, s);                 // A log2 e q
            da[n] = fmaf(dt, q, da[n]);
            g_in[n] = decay * g;
          }
#pragma unroll
          for (int o = kLanes / 2; o > 0; o /= 2) {
            u += __shfl_xor_sync(0xffffffffu, u, o);
            s += __shfl_xor_sync(0xffffffffu, s, o);
          }
          const float ddtp = fmaf(xv, u, s * kLn2) * sgv;
          if (part == 0) {
            sm.dx[k][chl] = from_float<T>(fmaf(dt, u, dskip * dyv));
            sm.ddt[k][chl] = ddtp;
            dd = fmaf(dyv, xv, dd);
            dbias += ddtp;
          }
          sm.red[warp][k][lane] = reduce_scatter8(v, lane);
        }
      }
    };
    if (steps == kK) {
      run(std::true_type{});
    } else {
      run(std::false_type{});
    }
    __syncthreads();                 // the chunk's outputs staged
    store_rows<kK, kChannels, kThreads>(dx, &sm.dx[0][0], row0, t0, S, c0,
                                        di, tid);
    store_rows<kK, kChannels, kThreads>(ddt_pre, &sm.ddt[0][0], row0, t0, S,
                                        c0, di, tid);
#pragma unroll
    for (int e = tid; e < kK * 32; e += kThreads) {
      const int k = e / 32, j = e % 32;
      if (k < steps) {
        float sum = sm.red[0][k][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += sm.red[w][k][j];
        part_bc[((row0 + t0 + k) * nblk + blockIdx.x) * 32 + j] = sum;
      }
    }
  }
  if (live) {
    float* pc = part_ch + (b * di + c) * kPartCh;
#pragma unroll
    for (int n = 0; n < kOwn; ++n) {
      pc[part * kOwn + n] = da[n];
      if (dh0 != nullptr) dh0[state0 + n] = g_in[n];
    }
    if (part == 0) {
      pc[kDs] = dd;
      pc[kDs + 1] = dbias;
    }
  }
}

// The lane of a warp's reduce-scatter that holds state n of dB (which 0)
// or dC (which 1): lane (which kOwn + n % kOwn) kLanes + n / kOwn.
__global__ void ssm_bwd_sum_kernel(const float* __restrict__ part_bc,
                                   const float* __restrict__ part_ch,
                                   const float* __restrict__ a_log,
                                   int64_t B, int64_t S, int64_t di,
                                   int64_t nblk, float* __restrict__ dbm,
                                   float* __restrict__ dcm,
                                   float* __restrict__ da_log,
                                   float* __restrict__ d_skip,
                                   float* __restrict__ d_bias) {
  const int64_t n_bc = B * S * 2 * kDs, n_ch = di * kPartCh;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n_bc + n_ch; i += stride) {
    if (i < n_bc) {
      const int64_t row = i / (2 * kDs);
      const int o = static_cast<int>(i % (2 * kDs));
      const int n = o % kDs, which = o / kDs;
      const int j = (which * kOwn + n % kOwn) * kLanes + n / kOwn;
      const float* p = part_bc + row * nblk * 32 + j;
      float sum = 0.f;
      for (int64_t k = 0; k < nblk; ++k) sum += p[k * 32];
      (which == 0 ? dbm : dcm)[row * kDs + n] = sum;
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
  ssm_bwd_kernel<T><<<dim3(static_cast<unsigned>(nblk),
                           static_cast<unsigned>(B)), kThreads, smem, st>>>(
      static_cast<const T*>(x), dt_pre, dt_bias, bm, cm, a_log, d_skip, ckpt,
      static_cast<const T*>(dy), dh_last, S, di, static_cast<T*>(dx),
      ddt_pre, part_bc, part_ch, dh0);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const int64_t total = B * S * 2 * kDs + di * kPartCh;
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
