// Hopper (sm_90a) kernel of the xLSTM's sLSTM blocks: the whole time scan
// of the stabilised exponential-gate recurrence in ONE cooperative launch.
//
//   wx (B, S, 4d) in float32 or bfloat16 (dtype flag 0 or 1; gate-major,
//   [zi | ii | ff | oo], each d wide), r (nh, dh, 4 dh) block-diagonal
//   recurrent weights in wx's dtype (per head [zi | ii | ff | oo], each dh
//   wide), state h0 (in hbuf[0]), c0, n0, m0 (B, d) float32
//   ->  y (B, S, d) float32 and the final state hN, cN, nN, mN (B, d)
//
// and per step, in float32, as the JAX package's xlstm._slstm_cell
// computes it:
//
//   gates = wx[:, t] + per-head h_{t-1} @ r      (rearranged to gate-major)
//   logf  = log_sigmoid(ff);  m' = max(logf + m, ii)
//   c' = exp(logf + m - m') c + exp(ii - m') tanh(zi)
//   n' = exp(logf + m - m') n + exp(ii - m')
//   h' = sigmoid(oo) c' / max(n', 1e-6)
//
// One launcher with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py); it takes the device index, raw device
// pointers, the sizes, the dtype flag and a cudaStream_t, allocates nothing
// and returns the first CUDA error (cudaErrorCooperativeLaunchTooLarge
// where the blocks cannot all be resident at once).
//
// Replaces the Pallas `_kernel` of src/repro/kernels/slstm_scan.py:25
// (`pallas_call` at :93), which ran its time blocks in order on one core
// with the state and the block-diagonal weights expanded to a dense
// (d, 4d) resident in VMEM.  Here the scan is one cooperative launch of
// d / U blocks, U state dimensions each (16 at xlstm-1.3b: 128 blocks on
// the H100's 132 SMs), with a grid barrier per time step:
//
//   * A block's dimensions lie in one head.  It keeps in shared memory, as
//     float32, the four gate columns of that head's r for its dimensions
//     (dh x 4U: 128 KB at dh = 512), read once: the block-diagonal weights
//     directly, not the dense expansion, which is 3/4 zeros.
//   * Thread (b, u) of the first B U threads owns the state c, n, m, h of
//     batch row b and dimension u in registers for the whole scan, and
//     prefetches the next step's four wx values.
//   * Per step the block reads h_{t-1} of its head (B x dh) into shared
//     memory from a double-buffered (2, B, d) float32 array in device
//     memory, with loads that skip L1 (__ldcg); 512 threads as (slice p of
//     dh, gate column j) sum h r over their slice for every batch row; the
//     owners add the slices and wx, update the state, write y and h_t into
//     the other buffer; then the grid barrier.  Step t reads buffer t % 2
//     and writes (t + 1) % 2, so no block overwrites a row another block
//     may still be reading: one barrier a step suffices.
//
// Bound: operations, the recurrence's 8 B S d dh float32 FLOPs (4.1 ms at
// xlstm-1.3b's prefill), above the bytes of wx, y and the state moved once
// (0.24 ms there); and the chain of S dependent steps, each a grid
// barrier, which no parallelism shortens.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// B <= MAXB batch rows; the dot products keep MAXB sums in registers.
template <typename T, int MAXB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const T* __restrict__ wx, const T* __restrict__ r,
                  float* __restrict__ hbuf, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ y, float* __restrict__ hN,
                  float* __restrict__ cN, float* __restrict__ nN,
                  float* __restrict__ mN, int B, int S, int nh, int dh,
                  int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int d = nh * dh;
  const int J = 4 * U;                 // gate columns of the block
  const int P = kThreads / J;          // slices of the dot products
  const int L = (dh + P - 1) / P;
  float* rs = smem;                    // [dh][J]
  float* hs = rs + dh * J;             // [B][dh]
  float* part = hs + B * dh;           // [P][B][J]

  const int u0 = blockIdx.x * U;
  const int head = u0 / dh, off = u0 - head * dh;
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  for (int idx = threadIdx.x; idx < dh * J; idx += kThreads) {
    const int i = idx / J, j = idx % J, g = j / U, u = j % U;
    rs[idx] = to_f(r[(static_cast<int64_t>(head) * dh + i) * 4 * dh
                     + g * dh + off + u]);
  }

  const int tid = threadIdx.x;
  const bool owner = tid < B * U;
  const int ob = tid / U, ou = tid % U;
  const int64_t unit = static_cast<int64_t>(ob) * d + u0 + ou;
  const T* wx_row = wx + static_cast<int64_t>(ob) * S * d4 + u0 + ou;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  float wn[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner) {
    c = c0[unit];
    n = n0[unit];
    m = m0[unit];
#pragma unroll
    for (int g = 0; g < 4; ++g) wn[g] = to_f(wx_row[g * d]);
  }
  const int p = tid / J, j = tid % J;
  const int i0 = min(dh, p * L), i1 = min(dh, i0 + L);

  for (int t = 0; t < S; ++t) {
    const float* hin = hbuf + static_cast<int64_t>(t & 1) * B * d;
    float* hout = hbuf + static_cast<int64_t>((t + 1) & 1) * B * d;
    for (int idx = tid; idx < B * dh; idx += kThreads) {
      const int b = idx / dh, i = idx % dh;
      hs[idx] = __ldcg(hin + static_cast<int64_t>(b) * d + head * dh + i);
    }
    float wt[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) wt[g] = wn[g];
    if (owner && t + 1 < S) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wn[g] = to_f(wx_row[(t + 1) * d4 + g * d]);
      }
    }
    __syncthreads();

    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float rv = rs[i * J + j];
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) acc[b] = fmaf(hs[b * dh + i], rv, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) part[(p * B + b) * J + j] = acc[b];
    }
    __syncthreads();

    if (owner) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.f;
        for (int q = 0; q < P; ++q) s += part[(q * B + ob) * J + g * U + ou];
        gate[g] = wt[g] + s;
      }
      const float zi = gate[0], ii = gate[1], ff = gate[2], oo = gate[3];
      const float logf = fminf(ff, 0.f) - log1pf(expf(-fabsf(ff)));
      const float m_new = fmaxf(logf + m, ii);
      const float fw = expf(logf + m - m_new);
      const float iw = expf(ii - m_new);
      c = fw * c + iw * tanhf(zi);
      n = fw * n + iw;
      h = 1.f / (1.f + expf(-oo)) * c / fmaxf(n, 1e-6f);
      m = m_new;
      y[(static_cast<int64_t>(ob) * S + t) * d + u0 + ou] = h;
      hout[unit] = h;
    }
    grid.sync();
  }

  if (owner) {
    hN[unit] = h;
    cN[unit] = c;
    nN[unit] = n;
    mN[unit] = m;
  }
}

size_t smem_bytes(int B, int dh, int U) {
  const int J = 4 * U, P = kThreads / J;
  return sizeof(float) * (static_cast<size_t>(dh) * J
                          + static_cast<size_t>(B) * dh
                          + static_cast<size_t>(P) * B * J);
}

template <typename T, int MAXB>
int launch(int device, const void* wx, const void* r, void* hbuf,
           const void* c0, const void* n0, const void* m0, void* y, void* hN,
           void* cN, void* nN, void* mN, int B, int S, int nh, int dh, int U,
           cudaStream_t st) {
  auto kernel = slstm_scan_kernel<T, MAXB>;
  const size_t smem = smem_bytes(B, dh, U);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int coop = 0, sms = 0, per_sm = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &coop, cudaDevAttrCooperativeLaunch, device)) {
    return static_cast<int>(e);
  }
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem)) {
    return static_cast<int>(e);
  }
  const int blocks = nh * dh / U;
  if (static_cast<int64_t>(per_sm) * sms < blocks) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const T* wx_t = static_cast<const T*>(wx);
  const T* r_t = static_cast<const T*>(r);
  float* hbuf_t = static_cast<float*>(hbuf);
  const float* c0_t = static_cast<const float*>(c0);
  const float* n0_t = static_cast<const float*>(n0);
  const float* m0_t = static_cast<const float*>(m0);
  float* y_t = static_cast<float*>(y);
  float* hN_t = static_cast<float*>(hN);
  float* cN_t = static_cast<float*>(cN);
  float* nN_t = static_cast<float*>(nN);
  float* mN_t = static_cast<float*>(mN);
  void* args[] = {&wx_t, &r_t, &hbuf_t, &c0_t, &n0_t, &m0_t, &y_t, &hN_t,
                  &cN_t, &nN_t, &mN_t, &B, &S, &nh, &dh, &U};
  if (cudaError_t e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads),
          args, smem, st)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int device, const void* wx, const void* r, void* hbuf,
             const void* c0, const void* n0, const void* m0, void* y,
             void* hN, void* cN, void* nN, void* mN, int B, int S, int nh,
             int dh, int U, cudaStream_t st) {
#define SLSTM_LAUNCH(MAXB)                                                  \
  return launch<T, MAXB>(device, wx, r, hbuf, c0, n0, m0, y, hN, cN, nN,    \
                         mN, B, S, nh, dh, U, st)
  if (B <= 1) SLSTM_LAUNCH(1);
  if (B <= 2) SLSTM_LAUNCH(2);
  if (B <= 4) SLSTM_LAUNCH(4);
  if (B <= 8) SLSTM_LAUNCH(8);
  SLSTM_LAUNCH(16);
#undef SLSTM_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (wx and r).  hbuf is (2, B, d) float32
// with h0 in its first half; the other state tensors and the outputs are
// contiguous float32.  Needs 1 <= B <= 16, S >= 1, U a power of two <= 16
// dividing dh, B U <= 512 and the shared memory within 227 KB (the
// wrapper checks).
int slstm_scan(int device, const void* wx, const void* r, void* hbuf,
               const void* c0, const void* n0, const void* m0, int64_t B,
               int64_t S, int64_t nh, int64_t dh, int64_t U, int dtype,
               void* y, void* hN, void* cN, void* nN, void* mN,
               void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || B > 16 || S < 1 || S > 0x7fffffff || nh < 1 || dh < 1
      || U < 1 || U > 16 || (U & (U - 1)) != 0 || dh % U != 0
      || B * U > kThreads || smem_bytes(B, dh, U) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), s = static_cast<int>(S);
  const int h = static_cast<int>(nh), w = static_cast<int>(dh);
  const int u = static_cast<int>(U);
  if (dtype == 0) {
    return dispatch<float>(device, wx, r, hbuf, c0, n0, m0, y, hN, cN, nN,
                           mN, b, s, h, w, u, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(device, wx, r, hbuf, c0, n0, m0, y, hN,
                                   cN, nN, mN, b, s, h, w, u, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
