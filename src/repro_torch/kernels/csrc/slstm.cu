// Hopper (sm_90a) kernels of the xLSTM's sLSTM blocks: the whole time scan
// of the stabilised exponential-gate recurrence in ONE launch.
//
//   wx (B, S, 4d) in float32 or bfloat16 (dtype flag 0 or 1; gate-major,
//   [zi | ii | ff | oo], each d wide), r (nh, dh, 4 dh) block-diagonal
//   recurrent weights in wx's dtype (per head [zi | ii | ff | oo], each dh
//   wide), state h0, c0, n0, m0 (B, d) float32
//   ->  y (B, S, d) float32 and the final state hN, cN, nN, mN (B, d),
//   and, where `states` is not null (autograd records), every step's
//   (c, n, m) into states (B, 3, S, d) float32 for the backward
//   (csrc/slstm_bwd.cu)
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
// pointers, the sizes, the dtype flag, the form and a cudaStream_t,
// allocates nothing and returns the first CUDA error.
//
// Replaces the Pallas `_kernel` of src/repro/kernels/slstm_scan.py:25
// (`pallas_call` at :93), which ran its time blocks in order on one core
// with the state and the block-diagonal weights expanded to a dense
// (d, 4d) resident in VMEM.  Two forms, chosen by the wrapper
// (kernels/slstm_scan.py form()) from the dtype and the head width:
//
// The cluster form (slstm_cluster_kernel: bfloat16, dh a multiple of 64 up
// to 512).  The heads are independent (r is block-diagonal), so each head
// runs on ONE thread-block cluster of dh / 32 blocks (16 at xlstm-1.3b),
// and a grid row of clusters takes each 16 batch rows; no cooperative
// launch, no grid barrier.  A block owns 32 state dimensions of its head,
// 128 gate columns:
//
//   * The recurrent product runs on the tensor cores: recT = r_blockT hT by
//     mma.sync.m16n8k16 (bfloat16 in, float32 sums), M the block's gate
//     columns, K = dh, N the batch rows (8; 16 as two n-tiles).  r is
//     exact in bfloat16; h (float32) is split into bfloat16 pieces h1 +
//     h2, the remainder under 2^-16 of |h|, so each product is exact
//     and y sits within 1e-6 of the plain version over xlstm-1.3b's
//     prefill scan (a third piece, exact to the last bit, costs a third
//     more products and bytes for 3.3e-7: tools/slstm_split.py).
//   * The block's r columns (dh x 128 bfloat16: 128 KB at dh 512) live in
//     registers as mma A fragments, 128 a thread, loaded once: the product
//     reads no weights from shared memory.  Warp (mg, kg) of the 8 takes
//     16 dimensions (its 4 m-tiles are the 4 gates of them) and a quarter
//     of K (below); the 4 quarters' partial sums meet in shared memory,
//     where the cell update (thread = dimension x batch row) adds them in
//     order.
//   * Within a k16 step the mma's k index is permuted (lane tig's four k
//     are dimensions 4 tig .. 4 tig + 3), so a B fragment is 8 contiguous
//     bytes of an h buffer laid out [dh/16][piece][n-tile][8 rows][16].
//   * The h exchange: each block splits its new h into the pieces, stages
//     them (1 KB a n-tile, already in the B layout) and one lane a peer
//     starts a bulk copy (cp.async.bulk, the TMA unit) into every block's
//     next buffer, its own last, completing on that block's mbarrier for
//     this source; no barrier across the cluster a step.  The copies
//     start one after another, so warp kg's share of K is the slices of
//     blocks kg, kg + 4, .. (whose copies reach a block spread over the
//     exchange), each waited for and multiplied as it lands.  h and the
//     staged slab are double-buffered, so a copy never lands on what a
//     block still reads.  The next step's wx is loaded during the
//     product; y and the final state go to device memory.
//
// The grid form (slstm_scan_kernel: float32, or a head the cluster form
// does not take): one cooperative launch of d / U blocks, U state
// dimensions each (a power of two up to 16 dividing dh), with a grid
// barrier per time step:
//
//   * A block's dimensions lie in one head.  It keeps in shared memory, as
//     float32, the four gate columns of that head's r for its dimensions
//     (dh x 4U: 128 KB at dh = 512), read once.
//   * Thread (b, u) of the first B U threads owns the state c, n, m, h of
//     batch row b and dimension u in registers for the whole scan, and
//     prefetches the next step's four wx values.
//   * Per step the block reads h_{t-1} of its head (B x dh) into shared
//     memory from a double-buffered (2, B, d) float32 array in device
//     memory, with loads that skip L1 (__ldcg); 512 threads as (slice p of
//     dh, gate column j) sum h r over their slice for every batch row; the
//     owners add the slices and wx, update the state, write y and h_t into
//     the other buffer; then the grid barrier.  The blocks must all be
//     resident at once (cudaErrorCooperativeLaunchTooLarge otherwise).
//
// Bound: the recurrence's 8 B S d dh FLOPs, at xlstm-1.3b's prefill 0.56
// ms as the cluster form's two bfloat16 products on the tensor cores
// (4.1 ms as float32 on the CUDA cores), above the bytes of wx, y and the
// state moved once (0.24 ms); and the chain of S dependent steps, each an
// exchange of h, which no parallelism shortens.

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

// B <= MAXB batch rows; the dot products keep MAXB sums in registers.
template <typename T, int MAXB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const T* __restrict__ wx, const T* __restrict__ r,
                  float* __restrict__ hbuf, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ y, float* __restrict__ hN,
                  float* __restrict__ cN, float* __restrict__ nN,
                  float* __restrict__ mN, float* __restrict__ states, int B,
                  int S, int nh, int dh, int U) {
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
      if (states != nullptr) {
        float* st = states + (static_cast<int64_t>(ob) * 3 * S + t) * d
                    + u0 + ou;
        st[0] = c;
        st[static_cast<int64_t>(S) * d] = n;
        st[2 * static_cast<int64_t>(S) * d] = m;
      }
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
           void* cN, void* nN, void* mN, void* states, int B, int S, int nh,
           int dh, int U, cudaStream_t st) {
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
  float* st_t = static_cast<float*>(states);
  void* args[] = {&wx_t, &r_t, &hbuf_t, &c0_t, &n0_t, &m0_t, &y_t, &hN_t,
                  &cN_t, &nN_t, &mN_t, &st_t, &B, &S, &nh, &dh, &U};
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
             void* hN, void* cN, void* nN, void* mN, void* states, int B,
             int S, int nh, int dh, int U, cudaStream_t st) {
#define SLSTM_LAUNCH(MAXB)                                                  \
  return launch<T, MAXB>(device, wx, r, hbuf, c0, n0, m0, y, hN, cN, nN,    \
                         mN, states, B, S, nh, dh, U, st)
  if (B <= 1) SLSTM_LAUNCH(1);
  if (B <= 2) SLSTM_LAUNCH(2);
  if (B <= 4) SLSTM_LAUNCH(4);
  if (B <= 8) SLSTM_LAUNCH(8);
  SLSTM_LAUNCH(16);
#undef SLSTM_LAUNCH
}

// -- the cluster form --------------------------------------------------------

constexpr int kCThreads = 256;      // 8 warps
constexpr int kCDims = 32;          // state dimensions a block: 128 columns
constexpr int kKGroups = 4;         // K split over the warps
constexpr int kMaxKSteps = 8;       // k16 steps a warp: dh / 64 <= 8
constexpr int kMaxCluster = 16;     // blocks a cluster: dh <= 512
constexpr int kPieces = 2;          // bfloat16 pieces of h (see below)
constexpr int kPartStride = 36;     // floats a row of partial sums: the
                                    // fragment stores hit 32 banks

// partial sums, two h buffers, two staged slabs, an mbarrier a buffer and
// a source block
size_t cluster_smem_bytes(int nt, int dh) {
  const size_t rows = 8 * static_cast<size_t>(nt);
  return sizeof(float) * kKGroups * 4 * rows * kPartStride
         + sizeof(uint16_t) * kPieces * rows * 2
               * (static_cast<size_t>(dh) + kCDims)
         + 2 * kMaxCluster * sizeof(uint64_t);
}

// h ~ p0 + p1: each piece the bfloat16 nearest the remainder (the
// remainders are exact in float32; three pieces would sum back to h
// exactly, two leave under 2^-16 of |h|)
__device__ __forceinline__ void split_pieces(float x,
                                             uint16_t (&p)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const __nv_bfloat16 b = __float2bfloat16_rn(x);
    p[i] = __bfloat16_as_ushort(b);
    x -= __bfloat162float(b);
  }
}

// where piece p of h[row n][dimension k] lies in an h buffer, in values:
// [k / 16][piece][n-tile][n % 8][k % 16]
template <int NT>
__device__ __forceinline__ int h_at(int k, int p, int n) {
  return (((k >> 4) * kPieces + p) * NT + (n >> 3)) * 128 + (n & 7) * 16
         + (k & 15);
}

// NT n-tiles of 8 batch rows (a cluster takes 8 NT rows); the grid is
// (nh * dh / 32, row chunks), a cluster dh / 32 blocks along x
template <int NT>
__global__ void __launch_bounds__(kCThreads, 1)
slstm_cluster_kernel(const __nv_bfloat16* __restrict__ wx,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, float* __restrict__ y,
                     float* __restrict__ hN, float* __restrict__ cN,
                     float* __restrict__ nN, float* __restrict__ mN,
                     float* __restrict__ states, int B, int S, int nh,
                     int dh) {
  constexpr int kRows = 8 * NT;
  constexpr int kSlab = kCDims * kPieces * kRows;   // a block's h, values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // [kg][gate][row][36]
  uint16_t* hbuf = reinterpret_cast<uint16_t*>(
      part + kKGroups * 4 * kRows * kPartStride);  // 2 x [dh/16][p][NT][8][16]
  const int buf_vals = kPieces * kRows * dh;
  uint16_t* stage = hbuf + 2 * buf_vals;              // 2 x the block's slab
  uint64_t* bars = reinterpret_cast<uint64_t*>(      // [buffer][source]
      stage + 2 * kSlab);

  const int cs = dh / kCDims;
  const int rank = static_cast<int>(hopper::cluster_ctarank());
  const int head = blockIdx.x / cs;
  const int off = rank * kCDims;        // the block's first dimension
  const int row0 = blockIdx.y * kRows;
  const int d = nh * dh;
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 2, tig = lane & 3;
  const int kg = warp & 3, mg = warp >> 2;

  // The warp's share of K: the slices (32 dimensions, one block's slab) of
  // the blocks whose rank is kg mod 4, taken in the order they arrive.
  // Block y's copy to peer y + 1 + i is started i-th by one of two warps,
  // so slice y reaches this block in turn ((rank - y - 1) mod cs) mod half:
  // each warp's slices arrive spread over the exchange, and it multiplies
  // each as it lands.  src[p] is the slice the warp takes p-th.
  const int half = (cs + 1) / 2;
  const int nslices = cs > kg ? (cs - kg + 3) / 4 : 0;
  int src[4];
  {
    int turn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      turn[i] = (rank - kg - 4 * i - 1 + 2 * cs) % cs % half;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) src[p] = kg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int before = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        before += j < nslices
                  && (turn[j] < turn[i] || (turn[j] == turn[i] && j < i));
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (i < nslices && before == p) src[p] = kg + 4 * i;
      }
    }
  }

  // A fragments of r_blockT: m-tile g is gate g of dimensions off + 16 mg
  // + [0, 16); rows q and q + 8; k16 steps 2 p and 2 p + 1 hold slice
  // src[p]; the permuted k of lane tig are 4 tig .. 4 tig + 3 of a step
  uint32_t a[4][kMaxKSteps][4];
  {
    const uint16_t* rh = reinterpret_cast<const uint16_t*>(r)
                         + static_cast<int64_t>(head) * dh * 4 * dh;
    const int64_t row = 4 * static_cast<int64_t>(dh);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int j = 0; j < kMaxKSteps; ++j) {
        a[g][j][0] = a[g][j][1] = a[g][j][2] = a[g][j][3] = 0u;
        if (j / 2 < nslices) {
          const int k = ((2 * src[j / 2] + j % 2) << 4) + 4 * tig;
          const uint16_t* p = rh + k * row + g * dh + off + 16 * mg + q;
          a[g][j][0] = p[0] | (static_cast<uint32_t>(p[row]) << 16);
          a[g][j][1] = p[8] | (static_cast<uint32_t>(p[row + 8]) << 16);
          a[g][j][2] = p[2 * row]
                       | (static_cast<uint32_t>(p[3 * row]) << 16);
          a[g][j][3] = p[2 * row + 8]
                       | (static_cast<uint32_t>(p[3 * row + 8]) << 16);
        }
      }
    }
  }

  // h0 of the head, split, into buffer 0 (rows past B as zeros)
  for (int idx = tid; idx < kRows * dh; idx += kCThreads) {
    const int n = idx / dh, k = idx - n * dh;
    const int row = row0 + n;
    const float v = row < B
        ? h0[static_cast<int64_t>(row) * d + head * dh + k] : 0.f;
    uint16_t pc[kPieces];
    split_pieces(v, pc);
#pragma unroll
    for (int p = 0; p < kPieces; ++p) hbuf[h_at<NT>(k, p, n)] = pc[p];
  }
  hopper::fence_proxy_async_smem();     // before the peers' copies land
  // barrier (b, y) completes a phase when block y's slab has landed in
  // buffer b: h_0 in buffer 1, h_1 in buffer 0, ..
  if (tid < 2 * cs) {
    const int b = tid / cs;
    uint64_t* bar = &bars[b * kMaxCluster + tid % cs];
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
    if (S >= 3 - b) hopper::mbar_expect_tx(bar, kSlab * 2);
  }

  // thread (lane, warp) owns dimension off + lane of rows warp + 8 nt
  const int u = lane;
  bool valid[NT];
  int64_t unit[NT];
  const uint16_t* wrow[NT];             // wx's row (row B - 1 past B)
  float c[NT], nn[NT], m[NT], h[NT], wcur[NT][4];
  uint32_t wnext[NT][4];                // the next step's wx, raw bits
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int row = row0 + warp + 8 * nt;
    valid[nt] = row < B;
    unit[nt] = static_cast<int64_t>(row) * d + head * dh + off + u;
    wrow[nt] = reinterpret_cast<const uint16_t*>(wx)
               + static_cast<int64_t>(valid[nt] ? row : B - 1) * S * d4
               + head * dh + off + u;
    c[nt] = valid[nt] ? c0[unit[nt]] : 0.f;
    nn[nt] = valid[nt] ? n0[unit[nt]] : 0.f;
    m[nt] = valid[nt] ? m0[unit[nt]] : 0.f;
    h[nt] = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      wnext[nt][g] = wrow[nt][g * d];
      wcur[nt][g] = valid[nt] ? __uint_as_float(wnext[nt][g] << 16) : 0.f;
    }
  }
  // every block of the cluster runs, with its buffer 0 written and its
  // barriers armed, before any peer copies into it
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();

  for (int t = 0; t < S; ++t) {
    const uint16_t* hb = hbuf + (t & 1) * buf_vals;
    const bool send = t + 1 < S;
    // the next step's wx, loaded now and widened only where used, so
    // that nothing waits for the load before the product
    const int64_t tn = (send ? t + 1 : t) * d4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int g = 0; g < 4; ++g) wnext[nt][g] = wrow[nt][tn + g * d];
    }

    // the warp's share of K for its 4 m-tiles, slice by slice as each
    // lands, the smallest piece first
    float acc[4][NT][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[g][nt][0] = acc[g][nt][1] = acc[g][nt][2] = acc[g][nt][3] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxKSteps; ++j) {
      if (j / 2 < nslices) {
        const int ks = 2 * src[j / 2] + j % 2;
        if (j % 2 == 0 && t >= 1) {
          // slice src[j / 2] of h_{t-1}; then arm its barrier for h_{t+1},
          // which that block sends only once it has this block's h_t
          uint64_t* bar = &bars[(t & 1) * kMaxCluster + src[j / 2]];
          hopper::mbar_wait(bar, ((t - 1) >> 1) & 1);
          if (mg == 0 && lane == 0 && t + 2 < S) {
            hopper::mbar_expect_tx(bar, kSlab * 2);
          }
        }
        uint2 b[kPieces][NT];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            b[p][nt] = *reinterpret_cast<const uint2*>(
                hb + ((ks * kPieces + p) * NT + nt) * 128 + q * 16 + 4 * tig);
          }
        }
#pragma unroll
        for (int p = kPieces - 1; p >= 0; --p) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              hopper::mma_bf16_16816(acc[g][nt], a[g][j], b[p][nt].x,
                                     b[p][nt].y);
            }
          }
        }
      }
    }
    // the partial sums: rows q, q + 8 of m-tile g, columns 2 tig, 2 tig + 1
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* pp = part + ((kg * 4 + g) * kRows + nt * 8 + 2 * tig)
                               * kPartStride + 16 * mg + q;
        pp[0] = acc[g][nt][0];
        pp[kPartStride] = acc[g][nt][1];
        pp[8] = acc[g][nt][2];
        pp[kPartStride + 8] = acc[g][nt][3];
      }
    }
    __syncthreads();

    uint16_t* slab = stage + (t & 1) * kSlab;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = warp + 8 * nt;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* pp = part + (g * kRows + n) * kPartStride + u;
        float sum = pp[0];
#pragma unroll
        for (int k = 1; k < kKGroups; ++k) {
          sum += pp[k * 4 * kRows * kPartStride];
        }
        gate[g] = wcur[nt][g] + sum;
      }
      const float zi = gate[0], ii = gate[1], ff = gate[2], oo = gate[3];
      // the cell in the hardware's exp2 / lg2 (relative error ~2^-22;
      // tanh as 1 - 2 / (e^2z + 1)): the step's chain is latency
      const float logf = fminf(ff, 0.f) - __logf(1.f + __expf(-fabsf(ff)));
      const float m_new = fmaxf(logf + m[nt], ii);
      const float fw = __expf(logf + m[nt] - m_new);
      const float iw = __expf(ii - m_new);
      c[nt] = fw * c[nt] + iw * (1.f - 2.f / (__expf(2.f * zi) + 1.f));
      nn[nt] = fw * nn[nt] + iw;
      h[nt] = __fdividef(c[nt], (1.f + __expf(-oo)) * fmaxf(nn[nt], 1e-6f));
      m[nt] = m_new;
      if (valid[nt]) {
        y[(static_cast<int64_t>(row0 + n) * S + t) * d + head * dh + off
          + u] = h[nt];
        if (states != nullptr) {
          float* st = states + (static_cast<int64_t>(row0 + n) * 3 * S + t)
                                   * d + head * dh + off + u;
          st[0] = c[nt];
          st[static_cast<int64_t>(S) * d] = nn[nt];
          st[2 * static_cast<int64_t>(S) * d] = m[nt];
        }
      }
      if (send) {
        uint16_t pc[kPieces];
        split_pieces(valid[nt] ? h[nt] : 0.f, pc);
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          slab[h_at<NT>(u, p, n)] = pc[p];
        }
      }
    }

    if (send) {
      hopper::fence_proxy_async_smem();
      __syncthreads();
      // the slab into every block's next buffer (its own last): copy i
      // goes to block rank + 1 + i, started by lane i % half of warp i /
      // half (two warps start them sooner than one or four:
      // tools/slstm_split.py).  The slab is double-buffered: its copies of
      // step t are done before any block sends h_{t+1}, so before this
      // block writes the slab again at t + 2
      if (warp < 2 && lane < half && warp * half + lane < cs) {
        const int nb = (t + 1) & 1;
        const int peer = (rank + 1 + warp * half + lane) % cs;
        hopper::bulk_copy_to_peer(
            hopper::map_rank(hopper::smem_u32(hbuf + nb * buf_vals
                                              + rank * kSlab), peer),
            hopper::smem_u32(slab), kSlab * 2,
            hopper::map_rank(
                hopper::smem_u32(&bars[nb * kMaxCluster + rank]), peer));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wcur[nt][g] = valid[nt] ? __uint_as_float(wnext[nt][g] << 16)
                                  : 0.f;
        }
      }
    }
  }

  // no block leaves while a copy from its shared memory may still run:
  // each arrives once it has every fill it waits for
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (valid[nt]) {
      hN[unit[nt]] = h[nt];
      cN[unit[nt]] = c[nt];
      nN[unit[nt]] = nn[nt];
      mN[unit[nt]] = m[nt];
    }
  }
}

// fills `config` (and `attr`) for the cluster form's launch
template <int NT>
cudaError_t cluster_config(cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr, int B, int nh, int dh,
                           cudaStream_t st) {
  auto kernel = slstm_cluster_kernel<NT>;
  const size_t smem = cluster_smem_bytes(NT, dh);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return e;
  }
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) {
    return e;
  }
  const int cs = dh / kCDims;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(nh * cs, (B + 8 * NT - 1) / (8 * NT));
  config->blockDim = dim3(kCThreads);
  config->dynamicSmemBytes = smem;
  config->stream = st;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// how many of the cluster form's clusters the card can hold at once
template <int NT>
cudaError_t cluster_capacity(int* clusters, int B, int nh, int dh) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = cluster_config<NT>(&config, &attr, B, nh, dh,
                                         nullptr)) {
    return e;
  }
  return cudaOccupancyMaxActiveClusters(clusters, slstm_cluster_kernel<NT>,
                                        &config);
}

template <int NT>
int launch_cluster(const void* wx, const void* r, const void* h0,
                   const void* c0, const void* n0, const void* m0, void* y,
                   void* hN, void* cN, void* nN, void* mN, void* states,
                   int B, int S, int nh, int dh, cudaStream_t st) {
  // refused, not run otherwise, where no GPC can hold one cluster
  int clusters = 0;
  if (cudaError_t e = cluster_capacity<NT>(&clusters, B, nh, dh)) {
    return static_cast<int>(e);
  }
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = cluster_config<NT>(&config, &attr, B, nh, dh, st)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaLaunchKernelEx(
          &config, slstm_cluster_kernel<NT>,
          static_cast<const __nv_bfloat16*>(wx),
          static_cast<const __nv_bfloat16*>(r),
          static_cast<const float*>(h0), static_cast<const float*>(c0),
          static_cast<const float*>(n0), static_cast<const float*>(m0),
          static_cast<float*>(y), static_cast<float*>(hN),
          static_cast<float*>(cN), static_cast<float*>(nN),
          static_cast<float*>(mN), static_cast<float*>(states), B, S, nh,
          dh)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

bool cluster_shape_ok(int64_t B, int64_t nh, int64_t dh) {
  return B >= 1 && nh >= 1 && dh % 64 == 0 && dh >= 64
         && dh / kCDims <= kMaxCluster && (B + 15) / 16 <= 65535
         && nh * (dh / kCDims) <= 0x7fffffff;
}

}  // namespace

extern "C" {

// form: 0 = the grid form, 1 = the cluster form.  dtype: 0 = float32, 1 =
// bfloat16 (wx and r).  states: null, or (B, 3, S, d) float32 for every
// step's (c, n, m).  The grid form takes hbuf (2, B, d) float32 with h0
// in its first half and needs 1 <= B <= 16, U a power of two <= 16
// dividing dh, B U <= 512 and the shared memory within 227 KB; the cluster
// form takes h0 itself as hbuf and needs bfloat16 and dh a multiple of 64
// up to 512, any B (a grid row a 16 rows).  Both need S >= 1; the other
// state tensors and the outputs are contiguous float32 (the wrapper
// checks).
int slstm_scan(int device, const void* wx, const void* r, void* hbuf,
               const void* c0, const void* n0, const void* m0, int64_t B,
               int64_t S, int64_t nh, int64_t dh, int64_t U, int dtype,
               int form, void* y, void* hN, void* cN, void* nN, void* mN,
               void* states, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1) {
    if (dtype != 1 || !cluster_shape_ok(B, nh, dh)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int b = static_cast<int>(B), s = static_cast<int>(S);
    const int h = static_cast<int>(nh), w = static_cast<int>(dh);
    if (B <= 8) {
      return launch_cluster<1>(wx, r, hbuf, c0, n0, m0, y, hN, cN, nN, mN,
                               states, b, s, h, w, st);
    }
    return launch_cluster<2>(wx, r, hbuf, c0, n0, m0, y, hN, cN, nN, mN,
                             states, b, s, h, w, st);
  }
  if (form != 0 || B < 1 || B > 16 || nh < 1 || dh < 1 || U < 1 || U > 16
      || (U & (U - 1)) != 0 || dh % U != 0 || B * U > kThreads
      || smem_bytes(B, dh, U) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int b = static_cast<int>(B), s = static_cast<int>(S);
  const int h = static_cast<int>(nh), w = static_cast<int>(dh);
  const int u = static_cast<int>(U);
  if (dtype == 0) {
    return dispatch<float>(device, wx, r, hbuf, c0, n0, m0, y, hN, cN, nN,
                           mN, states, b, s, h, w, u, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(device, wx, r, hbuf, c0, n0, m0, y, hN,
                                   cN, nN, mN, states, b, s, h, w, u, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many of the cluster form's clusters (dh / 32 blocks each) for B rows
// the card can hold at once, into *clusters; 0 means the form cannot run.
int slstm_cluster_capacity(int device, int64_t B, int64_t nh, int64_t dh,
                           void* clusters, void* stream) {
  (void)stream;
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (!cluster_shape_ok(B, nh, dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* out = static_cast<int*>(clusters);
  const int b = static_cast<int>(B), h = static_cast<int>(nh);
  const int w = static_cast<int>(dh);
  return static_cast<int>(B <= 8 ? cluster_capacity<1>(out, b, h, w)
                                 : cluster_capacity<2>(out, b, h, w));
}

}  // extern "C"
