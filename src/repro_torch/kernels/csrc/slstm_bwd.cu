// Hopper (sm_90a) kernel of the sLSTM's backward: the reverse time scan.
//
//   wx (B, S, 4d) and r (nh, dh, 4 dh) in float32 or bfloat16 (dtype flag 0
//   or 1), as the forward took them; h0, c0, n0, m0 (B, d), y (B, S, d) and
//   the forward's per-step states (B, 3, S, d) = (c, n, m) after each step,
//   float32 (csrc/slstm.cu writes them where autograd records); dy (B, S,
//   d) and the final state's gradients dhN, dcN, dnN, dmN (B, d), float32
//   ->  dgates (B, S, 4d) float32, gate-major [zi | ii | ff | oo] (the
//   gradient of wx before its cast), and dh0, dc0, dn0, dm0 (B, d)
//
// Per step t from S - 1 down to 0, in float32, autograd's formula of the
// forward cell (kernels/slstm_scan.py _cell_bwd): the gates recomputed,
//
//   gates = wx[:, t] + per-head h_{t-1} @ r;  t1 = log_sigmoid(ff) + m
//   m' = max(t1, ii);  fw = exp(t1 - m');  iw = exp(ii - m');  z = tanh(zi)
//   c' = fw c + iw z;  n' = fw n + iw;  s = sigmoid(oo);  h' = s c' / max(n', 1e-6)
//
// then, from dh = dy[:, t] + dh_rec (+ dhN at the last step) and the
// carries dc, dn, dm of (c', n', m'):
//
//   dn += -dh s c' / ncl^2 where n' >= 1e-6 (the clamp passes no gradient
//   below it);  dc += dh s / ncl;  doo = dh c' / ncl s (1 - s)
//   dfw = dc c + dn n;  diw = dc z + dn;  dzi = dc iw (1 - z^2)
//   dm' = dm - dfw fw - diw iw, to t1 and ii by the max (a tie halves it)
//   dt1 = dfw fw + its share;  dii = diw iw + its share
//   dff = dt1 sigmoid(-ff);  carries (dc fw, dn fw, dt1) to step t - 1
//   dh_rec of step t - 1 = per-head dgates_t @ r^T
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// recurrence (src/repro/models/xlstm.py), so this is the gradient of the
// forward kernel that replaces src/repro/kernels/slstm_scan.py:25.  One
// plain C launcher (loaded with ctypes by src/repro_torch/kernels/
// _build.py); it takes the device index, raw device pointers, the sizes,
// U, the dtype flag, a float32 scratch and a cudaStream_t, allocates
// nothing and returns the first CUDA error.
//
// Design: the forward's grid form run backwards.  One cooperative launch
// of d / U blocks (U state dimensions each, a power of two up to 16
// dividing dh, the wrapper's bwd_plan) over up to 16 batch rows, a grid
// barrier a step.  A block keeps its head's r columns for its dimensions
// in shared memory as float32 (dh x 4U, rows padded by one value), read
// once.  Thread (b, u) of the first B U threads owns batch row b and
// dimension u, and its carries, in registers.  Per step:
//
//   1. h_{t-1} of the head (B x dh, y's previous row or h0) into shared
//      memory; 512 threads as (slice of dh, gate column) recompute the
//      block's gates (the forward's product);
//   2. the owners run the cell back, write dgates_t and keep them in
//      shared memory;
//   3. each thread takes one dimension i of the head and adds, for every
//      row, sum_j dgates[b][j] r[i][j] over the block's 4U gate columns:
//      the block's share of dh_rec(t - 1), written to a double-buffered
//      scratch (2, d / U, B, dh);
//   4. the grid barrier; the owners then sum the dh / U shares of their
//      dimension in block order (loads that skip L1: the shares were
//      written by other blocks this launch).  One answer every run.
//
// Bound: operations, dh_rec's and (in the wrapper's one matmul) dr's
// products, 16 B S d dh; the gates' recomputation doubles the kernel's
// product, in float32 on the CUDA cores.  And the chain of S dependent
// steps, each a grid barrier, which no parallelism shortens.

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

struct Args {
  const void* wx;
  const void* r;
  const float* h0;
  const float* c0;
  const float* n0;
  const float* m0;
  const float* y;
  const float* states;
  const float* dy;
  const float* dhN;
  const float* dcN;
  const float* dnN;
  const float* dmN;
  float* dpart;
  float* dgates;
  float* dh0;
  float* dc0;
  float* dn0;
  float* dm0;
  int B, S, nh, dh, U;
};

// B <= MAXB batch rows; the products keep MAXB sums in registers.
template <typename T, int MAXB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, dh = a.dh, U = a.U;
  const int d = a.nh * dh;
  const int J = 4 * U;                 // gate columns of the block
  const int JP = J + 1;                // a row of rs, padded
  const int P = kThreads / J;          // slices of the gates' product
  const int L = (dh + P - 1) / P;
  float* rs = smem;                    // [dh][J + 1]
  float* hs = rs + dh * JP;            // [B][dh]
  float* part = hs + B * dh;           // [P][B][J]
  float* dgs = part + P * B * J;       // [B][J]

  const int u0 = blockIdx.x * U;
  const int head = u0 / dh, off = u0 - head * dh;
  const int kb = off / U, nk = dh / U; // the block's place in its head
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const T* wx = static_cast<const T*>(a.wx);
  const T* r = static_cast<const T*>(a.r);
  for (int idx = threadIdx.x; idx < dh * J; idx += kThreads) {
    const int i = idx / J, j = idx % J, g = j / U, u = j % U;
    rs[i * JP + j] = to_f(r[(static_cast<int64_t>(head) * dh + i) * 4 * dh
                            + g * dh + off + u]);
  }

  const int tid = threadIdx.x;
  const bool owner = tid < B * U;
  const int ob = tid / U, ou = tid % U;
  const int64_t unit = static_cast<int64_t>(ob) * d + u0 + ou;
  const int64_t sd = static_cast<int64_t>(S) * d;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  if (owner) {
    dc = a.dcN[unit];
    dn = a.dnN[unit];
    dm = a.dmN[unit];
  }
  const int p = tid / J, j = tid % J;
  const int i0 = min(dh, p * L), i1 = min(dh, i0 + L);
  // the dh_rec shares of (buffer, block of the head, row) for dimension i
  const int64_t share_b = static_cast<int64_t>(dh);
  const int64_t share_k = static_cast<int64_t>(B) * dh;
  const int64_t share_buf = static_cast<int64_t>(a.nh) * nk * share_k;
  float* my_share = a.dpart + static_cast<int64_t>(blockIdx.x) * share_k;

  for (int t = S - 1; t >= 0; --t) {
    // 1. h_{t-1} of the head, and the gates' product
    for (int idx = tid; idx < B * dh; idx += kThreads) {
      const int b = idx / dh, i = idx % dh;
      const int64_t col = static_cast<int64_t>(head) * dh + i;
      hs[idx] = t > 0 ? a.y[(static_cast<int64_t>(b) * S + t - 1) * d + col]
                      : a.h0[static_cast<int64_t>(b) * d + col];
    }
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float c_p = 0.f, n_p = 0.f, m_p = 0.f, dh_t = 0.f;
    if (owner) {
      const T* w = wx + (static_cast<int64_t>(ob) * S + t) * d4 + u0 + ou;
#pragma unroll
      for (int g = 0; g < 4; ++g) wt[g] = to_f(w[g * d]);
      if (t > 0) {
        const float* st = a.states + (static_cast<int64_t>(ob) * 3 * S + t - 1)
                                         * d + u0 + ou;
        c_p = st[0];
        n_p = st[sd];
        m_p = st[2 * sd];
      } else {
        c_p = a.c0[unit];
        n_p = a.n0[unit];
        m_p = a.m0[unit];
      }
      dh_t = a.dy[(static_cast<int64_t>(ob) * S + t) * d + u0 + ou];
      if (t == S - 1) {
        dh_t += a.dhN[unit];
      } else {
        // the shares of dh_rec(t) written at step t + 1, in block order
        const float* sh = a.dpart + ((t + 1) & 1) * share_buf
                          + static_cast<int64_t>(head) * nk * share_k
                          + ob * share_b + off + ou;
        float rec = 0.f;
        for (int k = 0; k < nk; ++k) rec += __ldcg(sh + k * share_k);
        dh_t += rec;
      }
    }
    __syncthreads();

    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float rv = rs[i * JP + j];
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

    // 2. the cell back
    if (owner) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.f;
        for (int q = 0; q < P; ++q) s += part[(q * B + ob) * J + g * U + ou];
        gate[g] = wt[g] + s;
      }
      const float zi = gate[0], ii = gate[1], ff = gate[2], oo = gate[3];
      const float ez = expf(-fabsf(ff));
      const float t1 = fminf(ff, 0.f) - log1pf(ez) + m_p;
      const float m_new = fmaxf(t1, ii);
      const float fw = expf(t1 - m_new);
      const float iw = expf(ii - m_new);
      const float z = tanhf(zi);
      const float c_new = fw * c_p + iw * z;
      const float n_new = fw * n_p + iw;
      const float s = 1.f / (1.f + expf(-oo));
      const float ncl = fmaxf(n_new, 1e-6f);
      const float dq = dh_t / ncl;
      if (n_new >= 1e-6f) dn += -dh_t * (s * c_new) / (ncl * ncl);
      dc += dq * s;
      const float doo = dq * c_new * s * (1.f - s);
      const float dfw = dc * c_p + dn * n_p;
      const float diw = dc * z + dn;
      const float dzi = dc * iw * (1.f - z * z);
      const float de1 = dfw * fw, de2 = diw * iw;
      const float dmn = dm - de1 - de2;
      const float share = t1 == ii ? 0.5f * dmn : dmn;
      const float dt1 = de1 + (t1 >= ii ? share : 0.f);
      const float dii = de2 + (ii >= t1 ? share : 0.f);
      // log_sigmoid's derivative, sigmoid(-ff), as torch takes it
      const float dff = dt1 * (ff < 0.f ? 1.f - ez / (1.f + ez)
                                        : ez / (1.f + ez));
      const float dg[4] = {dzi, dii, dff, doo};
      float* out = a.dgates + (static_cast<int64_t>(ob) * S + t) * d4 + u0
                   + ou;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[g * d] = dg[g];
        dgs[ob * J + g * U + ou] = dg[g];
      }
      dc *= fw;
      dn *= fw;
      dm = dt1;
    }
    __syncthreads();

    // 3. the block's share of dh_rec(t - 1) for every dimension of the head
    float* share_out = my_share + (t & 1) * share_buf;
    for (int i = tid; i < dh; i += kThreads) {
      float racc[MAXB];
#pragma unroll
      for (int b = 0; b < MAXB; ++b) racc[b] = 0.f;
      for (int jj = 0; jj < J; ++jj) {
        const float rv = rs[i * JP + jj];
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < B) racc[b] = fmaf(dgs[b * J + jj], rv, racc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) share_out[b * share_b + i] = racc[b];
      }
    }
    // 4. every block's shares before any owner sums them
    grid.sync();
  }

  if (owner) {
    const float* sh = a.dpart + static_cast<int64_t>(head) * nk * share_k
                      + ob * share_b + off + ou;     // buffer 0: step 0's
    float rec = 0.f;
    for (int k = 0; k < nk; ++k) rec += __ldcg(sh + k * share_k);
    a.dh0[unit] = rec;
    a.dc0[unit] = dc;
    a.dn0[unit] = dn;
    a.dm0[unit] = dm;
  }
}

size_t smem_bytes(int B, int dh, int U) {
  const int J = 4 * U, P = kThreads / J;
  return sizeof(float) * (static_cast<size_t>(dh) * (J + 1)
                          + static_cast<size_t>(B) * dh
                          + static_cast<size_t>(P) * B * J
                          + static_cast<size_t>(B) * J);
}

template <typename T, int MAXB>
int launch(int device, Args args, cudaStream_t st) {
  auto kernel = slstm_bwd_kernel<T, MAXB>;
  const size_t smem = smem_bytes(args.B, args.dh, args.U);
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
  const int blocks = args.nh * args.dh / args.U;
  // refused, never run in part, where the blocks cannot all be resident
  if (static_cast<int64_t>(per_sm) * sms < blocks) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* params[] = {&args};
  if (cudaError_t e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads),
          params, smem, st)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int device, const Args& args, cudaStream_t st) {
  if (args.B <= 1) return launch<T, 1>(device, args, st);
  if (args.B <= 2) return launch<T, 2>(device, args, st);
  if (args.B <= 4) return launch<T, 4>(device, args, st);
  if (args.B <= 8) return launch<T, 8>(device, args, st);
  return launch<T, 16>(device, args, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (wx and r).  Needs 1 <= B <= 16, S >=
// 1, U a power of two <= 16 dividing dh, the shared memory within 227 KB,
// every tensor contiguous and dpart (2, d / U, B, dh) float32 (the wrapper
// checks); refuses a launch whose d / U blocks cannot all be resident.
int slstm_scan_bwd(int device, const void* wx, const void* r, const void* h0,
                   const void* c0, const void* n0, const void* m0,
                   const void* y, const void* states, const void* dy,
                   const void* dhN, const void* dcN, const void* dnN,
                   const void* dmN, int64_t B, int64_t S, int64_t nh,
                   int64_t dh, int64_t U, int dtype, void* dpart,
                   void* dgates, void* dh0, void* dc0, void* dn0, void* dm0,
                   void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || B > 16 || S < 1 || S > 0x7fffffff || nh < 1 || dh < 1
      || U < 1 || U > 16 || (U & (U - 1)) != 0 || dh % U != 0
      || nh * dh > 0x7fffffff
      || smem_bytes(static_cast<int>(B), static_cast<int>(dh),
                    static_cast<int>(U)) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{wx, r,
                  static_cast<const float*>(h0),
                  static_cast<const float*>(c0),
                  static_cast<const float*>(n0),
                  static_cast<const float*>(m0),
                  static_cast<const float*>(y),
                  static_cast<const float*>(states),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dhN),
                  static_cast<const float*>(dcN),
                  static_cast<const float*>(dnN),
                  static_cast<const float*>(dmN),
                  static_cast<float*>(dpart), static_cast<float*>(dgates),
                  static_cast<float*>(dh0), static_cast<float*>(dc0),
                  static_cast<float*>(dn0), static_cast<float*>(dm0),
                  static_cast<int>(B), static_cast<int>(S),
                  static_cast<int>(nh), static_cast<int>(dh),
                  static_cast<int>(U)};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(device, args, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(device, args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
