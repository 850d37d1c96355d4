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
// U, the dtype flag, the form (kernels/slstm_scan.py bwd_form), a float32
// scratch and a cudaStream_t, allocates nothing and returns the first CUDA
// error.  Two forms:
//
// The cluster form (slstm_bwd_cluster_kernel: bfloat16, dh a multiple of
// 64 up to 512, the forward's cluster rule; xlstm-1.3b): the forward's
// cluster form run backwards, a cluster a head for each 4 batch rows, no
// grid barrier (below, before the kernel).
//
// The grid form (slstm_bwd_kernel: float32, or a head the cluster form
// does not take): the forward's grid form run backwards.  One cooperative
// launch of d / U blocks (U state dimensions each, a power of two up to 16
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
// products, 16 B S d dh (as two bfloat16 pieces in the cluster form); the
// gates' recomputation doubles the kernel's product.  And the chain of S
// dependent steps, which no parallelism shortens: a grid barrier a step
// in the grid form, an exchange in distributed shared memory in the
// cluster form.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// -- the cluster form ---------------------------------------------------------
//
// The forward's cluster form (csrc/slstm.cu slstm_cluster_kernel) run
// backwards: a head is one thread-block cluster of dh / 32 blocks (16 at
// xlstm-1.3b; non-portable size) for each kBRows batch rows, no
// cooperative launch, no grid barrier.  A block owns 32 state dimensions
// of its head and their 128 gate columns (local column 32 g + u: gate g of
// dimension off + u); warps 0-3 own a batch row each (lane u its
// dimension) and keep the carries dc, dn, dm in registers for the whole
// reverse scan.  Every product runs on mma.sync m16n8k16, bfloat16 in,
// float32 sums, with the two bfloat16 pieces of its float32 operand side
// by side in the mma's 8 columns (column n: piece n / 4 of row n % 4), so
// a product over kBRows rows costs one mma where two pieces would cost
// two; the pieces' sums meet by a shuffle, piece 0 + piece 1.
//
//   * r's block slice (dh x 128 bfloat16: 128 KB at dh 512) lives in
//     registers, 128 a thread, loaded once, as the A fragments of the
//     chain's product: warp w holds the dimensions' m-tiles w, w + 8, ..
//     (16 dimensions each) against all 128 columns.
//   * The chain product: dgates_t (float32, also written out) split into
//     two bfloat16 pieces (the remainder under 2^-16 of |dg|) in shared
//     memory; each warp multiplies its m-tiles: the block's share of
//     dh_{t-1} = dgates_t . r_head^T over its 128 columns, for every
//     dimension of the head and row.
//   * The exchange, a reduce-scatter in distributed shared memory: each
//     block stages, per peer k, the kBRows x 32 slab of its shares for k's
//     dimensions, and one lane a peer starts a bulk copy (cp.async.bulk)
//     into k's receive buffer for this source, completing on k's mbarrier
//     for the buffer (armed for all dh / 32 slabs).  Block k adds the
//     slabs in rank order: one answer every run.  Slabs and receive
//     buffers are double-buffered: a block sends step t - 1 only once it
//     has every peer's step t, which each peer sent only once it had read
//     its step t + 1 buffer and its copies of step t + 1 had landed.
//   * Every input of a step comes three steps ahead by bulk copies into a
//     ring of 5 shared-memory slots, started by warps 4-7 (a row each):
//     h's rows for its gates, the saved (c, n, m) of the step before, dy
//     and wx of the block's columns; no thread of the chain waits on a load
//     from device memory (loaded a step ahead into registers, they held
//     the step 1.5 us longer, tools/bwd_split.py).
//   * The gates, recomputed off the chain: those of step t - 1 need
//     h_{t-2}, y's row (or h0), nothing the reverse scan carries.  While
//     the block waits for step t's exchange each warp multiplies
//     h_{t-2}'s two pieces over its m-tiles' dimensions against
//     r_block^T, whose A fragments are its own registers transposed by
//     movmatrix (4 a 16 x 16 tile); the 8 warps' partial sums meet in
//     shared memory, added in warp order.
//
// Bound as the grid form's; per step, the chain is the exchange's
// latency, the cell and one 16 x 128 x dh product a block, the gates'
// product running while the exchange is in flight.
constexpr int kBThreads = 256;         // 8 warps
constexpr int kBDims = 32;             // state dimensions a block
constexpr int kBRows = 4;              // batch rows a cluster
constexpr int kBMaxCluster = 16;       // blocks a cluster: dh <= 512
constexpr int kBMTiles = 4;            // m-tiles a warp: dh / 16 / 8
constexpr int kBKSteps = 8;            // k16 steps of a block's 128 columns
constexpr int kBSlabStride = 36;       // floats a row of a slab (the
                                       // staging writes hit 32 banks)
constexpr int kBSlab = kBRows * kBSlabStride;
constexpr int kBPartStride = 132;      // floats a row of the gates' shares
constexpr int kBSlots = 5;             // the inputs' ring: 3 steps ahead
constexpr int kBLent = 3;              // m-tiles a warp of 0-3 lends
constexpr int kBLentTile = 128 * 16;   // bfloat16 a lent m-tile
constexpr int kBPieceStride = 136;     // bfloat16 a row of dgates' pieces
// a slot, floats: h's rows [kBRows][dh + 8] (rows padded: the fragment
// loads spread over the banks), then per row (c, n, m) [3][32], dy [32]
// and wx [4][32] bfloat16
constexpr int kBRowExtra = 3 * kBDims + kBDims + 2 * kBDims;

__host__ __device__ constexpr int bwd_slot_floats(int dh) {
  return kBRows * (dh + 8 + kBRowExtra);
}

size_t bwd_cluster_smem(int dh) {
  const size_t cs = static_cast<size_t>(dh) / kBDims;
  return sizeof(float) * (4 * cs * kBSlab
                          + kBSlots * static_cast<size_t>(bwd_slot_floats(dh))
                          + 2 * 8 * kBRows * kBPartStride
                          + 2 * kBRows * 4 * kBDims)
         + sizeof(uint16_t) * (kBRows * kBLent * kBLentTile
                               + 8 * kBPieceStride)
         + (2 + kBSlots) * sizeof(uint64_t);
}

// piece 0 (hi) or 1 (lo) of two float32 values as a bfloat16 pair
__device__ __forceinline__ uint32_t piece_pair(float2 x, bool lo) {
  __nv_bfloat16 a = __float2bfloat16_rn(x.x);
  __nv_bfloat16 b = __float2bfloat16_rn(x.y);
  if (lo) {
    a = __float2bfloat16_rn(x.x - __bfloat162float(a));
    b = __float2bfloat16_rn(x.y - __bfloat162float(b));
  }
  return static_cast<uint32_t>(__bfloat16_as_ushort(a))
         | static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16;
}

// Step tp's inputs for row r of a cluster into `slot` (bwd_slot_floats),
// completing on `bar` (one arrival a live row): h_{tp-1} (y's row, or h0
// at tp = 0), the (c, n, m) of step tp - 1 (states, or the initial state),
// dy_tp and wx_tp at the block's columns col0 ..; 9 bulk copies, one a
// lane of the calling warp
__device__ __forceinline__ void fetch_row(
    float* slot, uint64_t* bar, const float* y, const float* h0,
    const float* states, const float* c0, const float* n0, const float* m0,
    const float* dy, const __nv_bfloat16* wx, int tp, int r, int row0,
    int S, int d, int head, int dh, int col0, int lane) {
  const int hs = dh + 8;
  if (lane == 0) {
    hopper::mbar_expect_tx(bar,
                           static_cast<uint32_t>((dh + kBRowExtra) * 4));
  }
  __syncwarp();
  float* st = slot + kBRows * hs;                  // [row][3][32]
  float* dyv = st + kBRows * 3 * kBDims;           // [row][32]
  __nv_bfloat16* wxv = reinterpret_cast<__nv_bfloat16*>(
      dyv + kBRows * kBDims);                      // [row][4][32]
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const int64_t sd = static_cast<int64_t>(S) * d;
  if (lane < 9) {
    const int k = lane;
    const int64_t b = row0 + r;
    if (k == 0) {
      hopper::bulk_load(slot + r * hs,
                        tp >= 1 ? y + (b * S + tp - 1) * d + head * dh
                                : h0 + b * d + head * dh,
                        dh * 4, bar);
    } else if (k <= 3) {
      const float* init = k == 1 ? c0 : k == 2 ? n0 : m0;
      hopper::bulk_load(st + (r * 3 + k - 1) * kBDims,
                        tp >= 1 ? states + b * 3 * sd + (k - 1) * sd
                                      + static_cast<int64_t>(tp - 1) * d
                                      + col0
                                : init + b * d + col0,
                        kBDims * 4, bar);
    } else if (k == 4) {
      hopper::bulk_load(dyv + r * kBDims, dy + (b * S + tp) * d + col0,
                        kBDims * 4, bar);
    } else {
      const int g = k - 5;
      hopper::bulk_load(wxv + (r * 4 + g) * kBDims,
                        wx + (b * S + tp) * d4 + g * d + col0, kBDims * 2,
                        bar);
    }
  }
}

// The m-tiles of warps 0-3 whose gates' products warps 4-7 take (see
// gates_share): warp w's m-tiles w + 8 j for j >= kBMTiles - kBLent, as
// r_block^T tiles in shared memory for ldmatrix, [w][j][128 columns][16
// dimensions] bfloat16, a column's two 8-dimension halves swapped in
// columns 4-7 of every 8 (so that the 8 rows of an ldmatrix hit 32 banks)
__device__ __forceinline__ int lent_at(int col, int half) {
  return col * 16 + ((half ^ ((col >> 2) & 1)) << 3);
}

// A warp's share of a step's gates: h_{tp-1}'s two pieces (the slot `in`,
// column n of the mma: piece n / 4 of row n % 4) over its m-tiles'
// dimensions against r_block^T, 8 accumulators, one a k16 step of the
// block's columns, then the pieces' sums into the warp's rows of `part`
// ([8][kBRows][132]).  Warps 0-3 take their m-tiles j < kBMTiles -
// kBLent (one), after the exchange's copies; warps 4-7 their own four and,
// from `lent`, warp (w - 4)'s other three, while warps 0-3 run the cell
// (the split that measured best, tools/bwd_split.py).  r_block^T's
// tiles are the transposes of a warp's r_slice fragments (sub-matrices 0,
// 2, 1, 3 each transposed by movmatrix), or lent ones by ldmatrix.
__device__ __forceinline__ void gates_share(
    const uint32_t (&ra)[kBMTiles][kBKSteps][4], const float* in,
    float* part, const uint16_t* lent, int warp, int nmt, int q, int tig,
    int lane, int hs) {
  if (warp >= nmt) return;
  const float* hb = in + (q & 3) * hs + 2 * tig;
  const bool lo = q >= 4;
  const bool early = warp >= kBRows;
  float acc[kBKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kBKSteps; ++ks) {
    acc[ks][0] = acc[ks][1] = acc[ks][2] = acc[ks][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBMTiles; ++j) {
    const int mi = warp + 8 * j;
    if (mi < nmt && (early || j < kBMTiles - kBLent)) {
      const uint32_t b0 = piece_pair(
          *reinterpret_cast<const float2*>(hb + 16 * mi), lo);
      const uint32_t b1 = piece_pair(
          *reinterpret_cast<const float2*>(hb + 16 * mi + 8), lo);
#pragma unroll
      for (int ks = 0; ks < kBKSteps; ++ks) {
        const uint32_t at[4] = {hopper::movmatrix_trans(ra[j][ks][0]),
                                hopper::movmatrix_trans(ra[j][ks][2]),
                                hopper::movmatrix_trans(ra[j][ks][1]),
                                hopper::movmatrix_trans(ra[j][ks][3])};
        hopper::mma_bf16_16816(acc[ks], at, b0, b1);
      }
    }
  }
  if (early) {
#pragma unroll
    for (int jl = 0; jl < kBLent; ++jl) {
      const int mi = warp - kBRows + 8 * (kBMTiles - kBLent + jl);
      if (mi < nmt) {
        const uint32_t b0 = piece_pair(
            *reinterpret_cast<const float2*>(hb + 16 * mi), lo);
        const uint32_t b1 = piece_pair(
            *reinterpret_cast<const float2*>(hb + 16 * mi + 8), lo);
        // lane l: row l % 8 of matrix l / 8 (columns + 8 for matrices 1
        // and 3, dimensions + 8 for matrices 2 and 3)
        const uint16_t* tile = lent
            + ((warp - kBRows) * kBLent + jl) * kBLentTile;
        const int m = lane >> 3;
#pragma unroll
        for (int ks = 0; ks < kBKSteps; ++ks) {
          uint32_t at[4];
          hopper::ldmatrix_x4(
              at, tile + lent_at(16 * ks + (lane & 7) + 8 * (m & 1),
                                 m >> 1));
          hopper::mma_bf16_16816(acc[ks], at, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int ks = 0; ks < kBKSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[ks][i] += __shfl_xor_sync(~0u, acc[ks][i], 2);
    }
    if (tig < 2) {
      float* pp = part + (warp * kBRows + 2 * tig) * kBPartStride + 16 * ks
                  + q;
      pp[0] = acc[ks][0];
      pp[kBPartStride] = acc[ks][1];
      pp[8] = acc[ks][2];
      pp[kBPartStride + 8] = acc[ks][3];
    }
  }
}

__global__ void __launch_bounds__(kBThreads, 1)
slstm_bwd_cluster_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = a.S, B = a.B, dh = a.dh;
  const int d = a.nh * dh;
  const int cs = dh / kBDims;
  const int nmt = dh / 16;              // m-tiles of the head
  const int rank = static_cast<int>(hopper::cluster_ctarank());
  const int head = blockIdx.x / cs;
  const int off = rank * kBDims;        // the block's first dimension
  const int row0 = blockIdx.y * kBRows;
  const int live = min(kBRows, B - row0);
  const int hs = dh + 8;                // floats a row of h (bank spread)
  const int slot_f = bwd_slot_floats(dh);
  float* recv = reinterpret_cast<float*>(smem_raw);  // [2][cs][kBSlab]
  float* stage = recv + 2 * cs * kBSlab;             // [2][cs][kBSlab]
  float* ring = stage + 2 * cs * kBSlab;             // [kBSlots][slot_f]
  float* part = ring + kBSlots * slot_f;             // [2][8][kBRows][132]
  float* dgs = part + 2 * 8 * kBRows * kBPartStride;  // [2][kBRows][4][32]
  uint16_t* lent = reinterpret_cast<uint16_t*>(      // [4][kBLent][128 x 16]
      dgs + 2 * kBRows * 4 * kBDims);
  uint16_t* pieces = lent + kBRows * kBLent * kBLentTile;  // [8][136]
  uint64_t* rbar = reinterpret_cast<uint64_t*>(      // [buffer]
      pieces + 8 * kBPieceStride);
  uint64_t* ibar = rbar + 2;                         // [slot]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, tig = lane & 3;
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const int col = head * dh + off + lane;             // an owner's column
  // step tp's inputs into slot tp % kBSlots: warp 4 + r copies row r
  const float *y = a.y, *h0 = a.h0, *states = a.states, *dy = a.dy;
  const float *c0 = a.c0, *n0 = a.n0, *m0 = a.m0;
  const auto* wx = static_cast<const __nv_bfloat16*>(a.wx);
  const bool fetcher = warp >= kBRows && warp - kBRows < live;
  // a step's dgates of row warp - 4 from `dgs` to device memory
  float* const dgates = a.dgates;
  const auto store_dgates = [=](int tp) {
    const int r = warp - kBRows;
    const float* src = dgs + ((tp & 1) * kBRows + r) * 4 * kBDims + lane;
    float* dst = dgates + (static_cast<int64_t>(row0 + r) * S + tp) * d4
                 + col;
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g * d] = src[g * kBDims];
  };
  const auto fetch = [=](int tp) {
    fetch_row(ring + (tp % kBSlots) * slot_f, &ibar[tp % kBSlots], y, h0,
              states, c0, n0, m0, dy, wx, tp, warp - kBRows, row0, S, d,
              head, dh, head * dh + off, lane);
  };

  // A fragments of r_slice (rows: dimensions, k: the block's columns):
  // m-tile mi = warp + 8 j, k16 step ks = gate ks / 2, dimensions off +
  // 16 (ks % 2) + [0, 16) of the block
  uint32_t ra[kBMTiles][kBKSteps][4];
  {
    const uint16_t* rh = static_cast<const uint16_t*>(a.r)
                         + static_cast<int64_t>(head) * dh * 4 * dh;
    const int64_t row = 4 * static_cast<int64_t>(dh);
#pragma unroll
    for (int j = 0; j < kBMTiles; ++j) {
#pragma unroll
      for (int ks = 0; ks < kBKSteps; ++ks) {
        ra[j][ks][0] = ra[j][ks][1] = ra[j][ks][2] = ra[j][ks][3] = 0u;
        if (warp + 8 * j < nmt) {
          const uint16_t* p = rh + (16 * (warp + 8 * j) + q) * row
                              + (ks >> 1) * dh + off + (ks & 1) * 16
                              + 2 * tig;
          ra[j][ks][0] = *reinterpret_cast<const uint32_t*>(p);
          ra[j][ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * row);
          ra[j][ks][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          ra[j][ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * row + 8);
        }
      }
    }
  }

  // warps 0-3's lent m-tiles, r_block^T's layout: dimension i = 16 mi +
  // k of column c (gate c / 32, block dimension c % 32)
  {
    const uint16_t* rh = static_cast<const uint16_t*>(a.r)
                         + static_cast<int64_t>(head) * dh * 4 * dh;
    for (int idx = tid; idx < kBRows * kBLent * kBLentTile;
         idx += kBThreads) {
      const int k = idx & 15, c = (idx >> 4) & 127, tl = idx >> 11;
      const int mi = tl / kBLent + 8 * (kBMTiles - kBLent + tl % kBLent);
      if (mi < nmt) {
        lent[tl * kBLentTile + lent_at(c, k >> 3) + (k & 7)] =
            rh[static_cast<int64_t>(16 * mi + k) * 4 * dh
               + (c >> 5) * dh + off + (c & 31)];
      }
    }
  }

  if (tid == 0) {
    for (int i = 0; i < 2 + kBSlots; ++i) {
      hopper::mbar_init(&rbar[i], i < 2 ? 1 : live);  // slots: a row each
    }
    hopper::fence_barrier_init();
    // receive buffer b's first use: send step S - 1 (b = (S - 1) % 2) and
    // S - 2
    for (int b = 0; b < 2; ++b) {
      if (b == ((S - 1) & 1) || S >= 2) {
        hopper::mbar_expect_tx(&rbar[b], cs * kBSlab * 4);
      }
    }
  }
  __syncthreads();
  // the first steps' inputs
  if (fetcher) {
    for (int tp = S - 1; tp >= 0 && tp >= S - (kBSlots - 1); --tp) {
      fetch(tp);
    }
  }
  // rows past B in every slot: zeros, never copied
  for (int idx = tid; idx < kBSlots * slot_f; idx += kBThreads) {
    const int i = idx % slot_f;
    const int e = i - kBRows * hs;                   // past h's rows
    const int row = e < 0 ? i / hs
                    : e < kBRows * 3 * kBDims ? e / (3 * kBDims)
                    : e < kBRows * 4 * kBDims ? (e / kBDims) - 3 * kBRows
                    : (e - kBRows * 4 * kBDims) / (2 * kBDims);
    if (row >= live) ring[idx] = 0.f;
  }

  // the owners: warp w < kBRows owns row row0 + w, lane u dimension off + u
  const bool valid = warp < kBRows && row0 + warp < B;
  const int64_t ob = row0 + warp;
  const int64_t unit = ob * d + col;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  if (valid) {
    dc = a.dcN[unit];
    dn = a.dnN[unit];
    dm = a.dmN[unit];
  }
  __syncthreads();
  // every block of the cluster runs, its barriers armed, before any peer
  // copies into it
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();

  // Iteration t runs the chain of step t (t < S) and, off the chain, the
  // gates of step t - 1 (iteration S: those of step S - 1 alone): warps
  // 4-7 their shares while warps 0-3 run the cell, warps 0-3 theirs while
  // the exchange runs; `part` is double-buffered by the step's parity.
  float gate[4] = {0.f, 0.f, 0.f, 0.f};
  // an owner's row of a slot's (c, n, m) (then dy) and of its wx
  const int own_st = kBRows * hs + warp * 3 * kBDims + lane;
  const int own_dy = kBRows * hs + kBRows * 3 * kBDims + warp * kBDims + lane;
  const int own_wx = 2 * (kBRows * hs + kBRows * 4 * kBDims)
                     + warp * 4 * kBDims + lane;            // bfloat16
  const int half = (cs + 1) / 2;
  const int part_f = 8 * kBRows * kBPartStride;
  const auto slot_of = [&](int tp) { return ring + (tp % kBSlots) * slot_f; };
  const auto wait_slot = [&](int tp) {
    hopper::mbar_wait(&ibar[tp % kBSlots], ((S - 1 - tp) / kBSlots) & 1);
  };
  for (int t = S; t >= 0; --t) {
    // warps 4-7, each its row: dgates_{t+1} out to device memory
    if (fetcher && t + 1 < S) store_dgates(t + 1);
    if (warp >= kBRows && t >= 1) {
      // warps 4-7: their shares of step t - 1's gates; first each refills
      // its row of the slot step t + 1 left (its cell ran last iteration)
      if (fetcher && t < S && t >= kBSlots - 1) fetch(t - (kBSlots - 1));
      wait_slot(t - 1);
      gates_share(ra, slot_of(t - 1), part + ((t - 1) & 1) * part_f, lent,
                  warp, nmt, q, tig, lane, hs);
    }
    if (t < S) {
      const float* in = slot_of(t);                     // step t's inputs
      const float c_p = in[own_st], n_p = in[own_st + kBDims];
      const float m_p = in[own_st + 2 * kBDims];
      // 1. dh_rec of step t: the peers' slabs of send step t + 1, in rank
      // order; then the barriers armed for send step t - 1
      float dh_t = in[own_dy];
      if (t == S - 1) {
        if (valid) dh_t += a.dhN[unit];
      } else if (warp < kBRows) {
        const int b = (t + 1) & 1;
        hopper::mbar_wait(&rbar[b], ((S - 2 - t) >> 1) & 1);
        if (tid == 0 && t >= 1) {
          hopper::mbar_expect_tx(&rbar[b], cs * kBSlab * 4);
        }
        const float* rv = recv + b * cs * kBSlab + warp * kBSlabStride
                          + lane;
        float rec = 0.f;
        for (int src = 0; src < cs; ++src) rec += rv[src * kBSlab];
        dh_t += rec;
      }
      // 2. the cell back (autograd's formula, kernels/slstm_scan.py
      // _gates_bwd), in the hardware's exp2 / lg2 and approximate
      // reciprocal, as the forward's cluster form computes the cell (the
      // IEEE divisions held a step 0.12 us longer, tools/bwd_split.py)
      if (warp < kBRows) {
        const float zi = gate[0], ii = gate[1], ff = gate[2], oo = gate[3];
        const float ez = __expf(-fabsf(ff));
        const float t1 = fminf(ff, 0.f) - __logf(1.f + ez) + m_p;
        const float m_new = fmaxf(t1, ii);
        const float fw = __expf(t1 - m_new);
        const float iw = __expf(ii - m_new);
        const float z = 1.f - __fdividef(2.f, __expf(2.f * zi) + 1.f);
        const float c_new = fw * c_p + iw * z;
        const float n_new = fw * n_p + iw;
        const float s = __fdividef(1.f, 1.f + __expf(-oo));
        const float ncl = fmaxf(n_new, 1e-6f);
        const float dq = __fdividef(dh_t, ncl);
        if (n_new >= 1e-6f) dn += __fdividef(-dh_t * (s * c_new), ncl * ncl);
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
        const float sf = __fdividef(ez, 1.f + ez);
        const float dff = dt1 * (ff < 0.f ? 1.f - sf : sf);
        const float dg[4] = {dzi, dii, dff, doo};
        // dgates_t, written out by warps 4-7 a step later
        float* out = dgs + ((t & 1) * kBRows + warp) * 4 * kBDims + lane;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          out[g * kBDims] = dg[g];
          const __nv_bfloat16 hi = __float2bfloat16_rn(dg[g]);
          const __nv_bfloat16 lo = __float2bfloat16_rn(
              dg[g] - __bfloat162float(hi));
          pieces[warp * kBPieceStride + 32 * g + lane] =
              __bfloat16_as_ushort(hi);
          pieces[(kBRows + warp) * kBPieceStride + 32 * g + lane] =
              __bfloat16_as_ushort(lo);
        }
        dc *= fw;
        dn *= fw;
        dm = dt1;
      }
      __syncthreads();

      // 3. the block's share of dh_{t-1} for every dimension of the head:
      // warp w's m-tiles against the block's 128 columns (on mma.sync: a
      // wgmma m64n8k16 a k16 step, from the same registers, held the step
      // 0.66 us longer, tools/bwd_split.py)
      {
        float acc[kBMTiles][4];
#pragma unroll
        for (int j = 0; j < kBMTiles; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        }
        const uint16_t* pq = pieces + q * kBPieceStride + 2 * tig;
#pragma unroll
        for (int ks = 0; ks < kBKSteps; ++ks) {
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(pq + 16 * ks);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(pq + 16 * ks + 8);
#pragma unroll
          for (int j = 0; j < kBMTiles; ++j) {
            if (warp + 8 * j < nmt) {
              hopper::mma_bf16_16816(acc[j], ra[j][ks], b0, b1);
            }
          }
        }
        // the pieces' sums, staged into slab (m-tile / 2) at its
        // dimensions 16 (m-tile % 2) ..
        float* slab = stage + (t & 1) * cs * kBSlab;
#pragma unroll
        for (int j = 0; j < kBMTiles; ++j) {
          const int mi = warp + 8 * j;
          if (mi < nmt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[j][i] += __shfl_xor_sync(~0u, acc[j][i], 2);
            }
            if (tig < 2) {
              float* sl = slab + (mi >> 1) * kBSlab
                          + 2 * tig * kBSlabStride + (mi & 1) * 16 + q;
              sl[0] = acc[j][0];
              sl[kBSlabStride] = acc[j][1];
              sl[8] = acc[j][2];
              sl[kBSlabStride + 8] = acc[j][3];
            }
          }
        }
      }
      hopper::fence_proxy_async_smem();
      __syncthreads();
      // 4. slab k into block k's receive buffer for this source (its own
      // last): copy i to block rank + 1 + i, started by lane i % half of
      // warp i / half
      if (warp < 2 && lane < half && warp * half + lane < cs) {
        const int peer = (rank + 1 + warp * half + lane) % cs;
        const int b = t & 1;
        hopper::bulk_copy_to_peer(
            hopper::map_rank(
                hopper::smem_u32(recv + (b * cs + rank) * kBSlab), peer),
            hopper::smem_u32(stage + (b * cs + peer) * kBSlab), kBSlab * 4,
            hopper::map_rank(hopper::smem_u32(&rbar[b]), peer));
      }
    }
    if (t >= 1) {
      // warps 0-3: their shares of step t - 1's gates while the exchange
      // runs; then the owners add wx and the 8 warps' shares in order
      float* pt = part + ((t - 1) & 1) * part_f;
      if (warp < kBRows) {
        wait_slot(t - 1);
        gates_share(ra, slot_of(t - 1), pt, lent, warp, nmt, q, tig, lane,
                    hs);
      }
      if (t == S) {
        __syncthreads();
      } else if (warp < kBRows) {
        hopper::bar_sync(3, kBRows * 32);
      }
      if (valid) {
        const __nv_bfloat16* wxs =
            reinterpret_cast<const __nv_bfloat16*>(slot_of(t - 1)) + own_wx;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* pp = pt + warp * kBPartStride + 32 * g + lane;
          float sum = 0.f;
          for (int w = 0; w < min(8, nmt); ++w) {
            sum += pp[w * kBRows * kBPartStride];
          }
          gate[g] = __bfloat162float(wxs[g * kBDims]) + sum;
        }
      }
    }
  }

  if (fetcher) store_dgates(0);
  // dh0: the peers' slabs of send step 0
  if (warp < kBRows) {
    hopper::mbar_wait(&rbar[0], ((S - 1) >> 1) & 1);
    const float* rv = recv + warp * kBSlabStride + lane;
    float rec = 0.f;
    for (int src = 0; src < cs; ++src) rec += rv[src * kBSlab];
    if (valid) {
      a.dh0[unit] = rec;
      a.dc0[unit] = dc;
      a.dn0[unit] = dn;
      a.dm0[unit] = dm;
    }
  }
  // no block leaves while a copy from its shared memory may still run:
  // each arrives once it has every slab it waits for
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();
}

bool bwd_cluster_shape_ok(int64_t B, int64_t nh, int64_t dh) {
  return B >= 1 && nh >= 1 && dh % 64 == 0 && dh >= 64
         && dh / kBDims <= kBMaxCluster && (B + kBRows - 1) / kBRows <= 65535
         && nh * (dh / kBDims) <= 0x7fffffff;
}

// fills `config` (and `attr`) for the cluster form's launch
cudaError_t bwd_cluster_config(cudaLaunchConfig_t* config,
                               cudaLaunchAttribute* attr, int B, int nh,
                               int dh, cudaStream_t st) {
  const size_t smem = bwd_cluster_smem(dh);
  if (cudaError_t e = cudaFuncSetAttribute(
          slstm_bwd_cluster_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return e;
  }
  if (cudaError_t e = cudaFuncSetAttribute(
          slstm_bwd_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) {
    return e;
  }
  const int cs = dh / kBDims;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(nh * cs, (B + kBRows - 1) / kBRows);
  config->blockDim = dim3(kBThreads);
  config->dynamicSmemBytes = smem;
  config->stream = st;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// how many of the cluster form's clusters the card can hold at once
cudaError_t bwd_cluster_capacity(int* clusters, int B, int nh, int dh) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = bwd_cluster_config(&config, &attr, B, nh, dh,
                                         nullptr)) {
    return e;
  }
  return cudaOccupancyMaxActiveClusters(clusters, slstm_bwd_cluster_kernel,
                                        &config);
}

int launch_bwd_cluster(const Args& args, cudaStream_t st) {
  // refused, not run otherwise, where no GPC can hold one cluster
  int clusters = 0;
  if (cudaError_t e = bwd_cluster_capacity(&clusters, args.B, args.nh,
                                           args.dh)) {
    return static_cast<int>(e);
  }
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = bwd_cluster_config(&config, &attr, args.B, args.nh,
                                         args.dh, st)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaLaunchKernelEx(&config, slstm_bwd_cluster_kernel,
                                         args)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// form: 0 = the grid form, 1 = the cluster form.  dtype: 0 = float32, 1 =
// bfloat16 (wx and r).  The grid form needs 1 <= B <= 16, U a power of two
// <= 16 dividing dh, the shared memory within 227 KB and dpart (2, d / U,
// B, dh) float32, and refuses a launch whose d / U blocks cannot all be
// resident; the cluster form needs bfloat16, dh a multiple of 64 up to 512,
// wx, the state, y, states and dy on 16 bytes and r on 4, any B (a grid row
// of clusters a kBRows rows; dpart and U unused), and refuses where no
// cluster fits.  Both need
// S >= 1 and every tensor contiguous (the wrapper checks).
int slstm_scan_bwd(int device, const void* wx, const void* r, const void* h0,
                   const void* c0, const void* n0, const void* m0,
                   const void* y, const void* states, const void* dy,
                   const void* dhN, const void* dcN, const void* dnN,
                   const void* dmN, int64_t B, int64_t S, int64_t nh,
                   int64_t dh, int64_t U, int dtype, int form, void* dpart,
                   void* dgates, void* dh0, void* dc0, void* dn0, void* dm0,
                   void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (S < 1 || S > 0x7fffffff || nh < 1 || dh < 1 || nh * dh > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (form == 1) {
    // the bulk copies read from 16-byte boundaries
    const bool aligned = aligned16(wx) && aligned16(h0) && aligned16(c0)
                         && aligned16(n0) && aligned16(m0) && aligned16(y)
                         && aligned16(states) && aligned16(dy);
    if (dtype != 1 || !bwd_cluster_shape_ok(B, nh, dh) || !aligned
        || reinterpret_cast<uintptr_t>(r) % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (form != 0 || B < 1 || B > 16 || U < 1 || U > 16
             || (U & (U - 1)) != 0 || dh % U != 0
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
  if (form == 1) return launch_bwd_cluster(args, st);
  if (dtype == 0) return dispatch<float>(device, args, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(device, args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many of the cluster form's clusters (dh / 32 blocks each) for B rows
// the card can hold at once, into *clusters; 0 means the form cannot run.
int slstm_bwd_cluster_capacity(int device, int64_t B, int64_t nh, int64_t dh,
                               void* clusters, void* stream) {
  (void)stream;
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (!bwd_cluster_shape_ok(B, nh, dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(bwd_cluster_capacity(
      static_cast<int*>(clusters), static_cast<int>(B), static_cast<int>(nh),
      static_cast<int>(dh)));
}

}  // extern "C"
