// Hopper (sm_90a) kernels of the model substrate's prefill: causal or
// non-causal attention with an online softmax and grouped-query heads.
//
//   q (B, Sq, H, dh), k and v (B, Skv, Hkv, dh), row-major, float32 or
//   bfloat16 (dtype flag 0 or 1)  ->  o (B, Sq, H, dh) in q's dtype
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, hk] * scale) v[b, j, hk]
//
// with hk = h / (H / Hkv), scores and sums in float32, masked scores set to
// -1e30 (causal: j > i) and the result divided by max(l, 1e-30), as
// ref.flash_attention_ref computes it.  Sq and Skv may differ (whisper's
// cross attention: the decoder's tokens against the encoder's frames) where
// the attention is not causal; a causal launch needs Sq == Skv.  Query rows
// are bounded by Sq, key tiles and the key mask by Skv.  One launcher with a plain C
// interface (loaded with ctypes by src/repro_torch/kernels/_build.py); it
// takes the device index, raw device pointers, the sizes, the scale, the
// causal and dtype flags, the form (kernels/flash_attention.py's `form`)
// and a cudaStream_t, allocates nothing and returns cudaGetLastError().
//
// Replaces the Pallas `_kernel` of src/repro/kernels/flash_attention.py:25
// (`pallas_call` at :87).  That grid ran its kv axis in order on one core
// and carried the softmax state in VMEM scratch; here one thread block owns
// one query tile of one (batch, head) and walks the kv tiles itself,
// skipping the causal tiles past the diagonal and reading the kv head in
// place from the (B, Skv, Hkv, dh) layout (no repeat, no transposed copy).
// Bound: operations, 4 B H Sq Skv dh (halved when causal) against the
// bytes of q, k, v and o.  Two forms:
//
//   * flash_attention_wgmma_kernel: bfloat16, dh 64 or 128 (the serving
//     paths).  A block owns 128 query rows: a producer warpgroup (one
//     thread issues) loads Q once and streams K and V tiles of 64 keys by
//     TMA (4-D tensor maps over q (Sq rows) and k, v (Skv rows), 64-value
//     boxes under the 128-byte swizzle; rows past either read as zeros) through a 4-stage ring;
//     two consumer warpgroups of 64 rows each compute S = Q.K^T with wgmma
//     into float32 registers, the online softmax there (base 2, ex2 on the
//     SFU, masking only on the diagonal tile and the Skv tail), and O += P.V
//     as two wgmmas with P from registers: P's bfloat16 rounding and the
//     bfloat16 rounding of what it left, so that P keeps about 16 bits (one
//     rounding of P would put each output some 2^-9 of |o| off; the Pallas
//     kernel keeps p in float32).  A step issues tile kt - 1's P.V and tile
//     kt's Q.K^T as one batch, then runs tile kt's softmax; the two
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs under the other's products.  Registers: 168 a thread (ptxas
//     allocates by the launch bound, 384 threads, whatever setmaxnreg gives
//     at run time), which is why a kv tile is 64 keys and not 128.
//   * flash_attention_kernel: any dtype and dh up to 128 (float32, other
//     head widths).  One block per 64-row query tile, float32 on the CUDA
//     cores: 256 threads as 16 row groups x 16 column groups.  Thread (ty,
//     tx) holds scores for rows 4ty..4ty+3 and keys 4tx..4tx+3 of the tile,
//     and output columns tx + 16c.  Q and K are staged d-major
//     (q[d][row]), so the Q.K^T loop reads one float4 of each per d without
//     bank conflicts; V is staged row-major.  The probabilities go through
//     shared memory (over K's tile) to the P.V product.  Tiles past Sq or
//     Skv and columns past dh are staged as zeros, and keys past Skv are
//     masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "hopper.cuh"

namespace {

// Floats of shared memory: q (d-major), k (d-major; later the
// probabilities), v (row-major).
template <int DHP> constexpr int k_floats() {
  return DHP * kKeys > kRows * kPRow ? DHP * kKeys : kRows * kPRow;
}
template <int DHP> constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DHP * kRows + k_floats<DHP>());
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// DHP: dh padded up to one of the instantiated widths (a multiple of 16
// and of the 16-byte vector).
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int H,
                       int Hkv, int dh, float scale, int causal) {
  constexpr int kCols = DHP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [DHP][kRows]
  float* vs = qs + DHP * kRows;        // [kKeys][DHP]
  float* ks = vs + DHP * kKeys;        // [DHP][kKeys], then ps
  float* ps = ks;                      // [kRows][kPRow]

  const int n_tiles = (Sq + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * dh;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * dh;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_stride
                + static_cast<int64_t>(h) * dh;
  const int64_t kv_base = static_cast<int64_t>(b) * Skv * kv_stride
                          + static_cast<int64_t>(hk) * dh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage<T, DHP, true>(qb, q_stride, min(kRows, Sq - q0), dh, qs);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: the tiles up to the one holding the block's last row
  const int n_kv = (Skv + kKeys - 1) / kKeys;
  const int end = causal ? min(n_kv, (q0 + kRows - 1) / kKeys + 1) : n_kv;
  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kKeys;
    const int rows = min(kKeys, Skv - k0);
    __syncthreads();                   // the last tile's ps and vs are read
    stage<T, DHP, true>(k + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                        ks);
    stage<T, DHP, false>(v + kv_base + k0 * kv_stride, kv_stride, rows, dh,
                         vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kRows
                                                         + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kKeys
                                                         + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

    // online softmax, one row per 16-lane group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = col < Skv && (!causal || col <= row);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = col < Skv && (!causal || col <= row);
        s[i][j] = live ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                   // every thread is done with ks
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPRow + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j4 = 0; j4 < kKeys; j4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + i) * kPRow + j4);
        p[i][0] = pr.x;
        p[i][1] = pr.y;
        p[i][2] = pr.z;
        p[i][3] = pr.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j4 + jj) * DHP + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float x = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i][jj], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    if (lse != nullptr && tx == 0) {   // the row's logsumexp, for autograd
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(l[i]);
    }
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(b) * Sq + row) * q_stride
              + static_cast<int64_t>(h) * dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(orow + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t Hkv,
           int64_t dh, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DHP>();
  if (cudaError_t e = cudaFuncSetAttribute(
          flash_attention_kernel<T, DHP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((Sq + kRows - 1) / kRows),
                  static_cast<unsigned>(B * H));
  flash_attention_kernel<T, DHP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse,
      static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(H),
      static_cast<int>(Hkv), static_cast<int>(dh), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16, dh 64 or 128: TMA-fed wgmma -----------------------------------
constexpr int kFM = 128;               // query rows a block: 2 x 64
constexpr int kFN = 64;                // keys a kv tile
constexpr int kFStages = 4;
constexpr int kFThreads = 384;         // 2 consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
constexpr size_t wgmma_smem() {
  return 1024 + static_cast<size_t>(kFM + 2 * kFStages * kFN) * DH * 2
         + (1 + 3 * kFStages) * sizeof(uint64_t);
}

// bfloat16 pairs (the wgmma A fragment's registers) of p and of p minus
// its bfloat16 rounding: hi + lo carries about 16 bits of p
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      p0 - __low2float(h), p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH>
__global__ void __launch_bounds__(kFThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int Sq, int Skv,
                             int H, int Hkv, float scale_log2, int causal) {
  constexpr int kBoxes = DH / 64;      // 64-value boxes across a head
  constexpr int kQBox = kFM * 128;     // bytes of a box of Q
  constexpr int kKBox = kFN * 128;     // bytes of a box of K or V
  constexpr int kKV = kBoxes * kKBox;  // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + kBoxes * kQBox;                   // [stage][box][key]
  uint8_t* vs = ks + kFStages * kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kFStages * kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFStages;
  uint64_t* empty = v_full + kFStages;

  const int n_tiles = (Sq + kFM - 1) / kFM;
  const int q_tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = q_tile * kFM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  // causal: the kv tiles up to the one holding the block's last row
  const int n_kv = (Skv + kFN - 1) / kFN;
  const int end = causal ? min(n_kv, (q0 + kFM - 1) / kFN + 1) : n_kv;
  // warp-uniform to the compiler (a shuffle), so that the roles' branches
  // take setmaxnreg's register counts
  const int wg = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kFStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {                       // producer warpgroup: one thread
    hopper::regs_dec<40>();            // issues; its registers go to the
    if (threadIdx.x == 256) {          // consumers
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_expect_tx(q_full, kBoxes * kQBox);
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
        hopper::tma_load_4d(qs + j * kQBox, &qmap, q_full, 64 * j, h, q0, b);
      }
      for (int kt = 0; kt < end; ++kt) {
        const int s = kt % kFStages;
        if (kt >= kFStages) {
          hopper::mbar_wait(&empty[s], ((kt / kFStages) & 1) ^ 1);
        }
        hopper::mbar_expect_tx(&k_full[s], kKV);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          hopper::tma_load_4d(ks + s * kKV + j * kKBox, &kmap, &k_full[s],
                              64 * j, hk, kt * kFN, b);
        }
        hopper::mbar_expect_tx(&v_full[s], kKV);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          hopper::tma_load_4d(vs + s * kKV + j * kKBox, &vmap, &v_full[s],
                              64 * j, hk, kt * kFN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` owns query rows q0 + 64 half ...; this
  // thread rows r0 and r0 + 8 (the accumulator's layout, hopper.cuh).
  // Step kt issues one batch of products, P.V of tile kt - 1 and Q.K^T of
  // tile kt, then runs tile kt's softmax on the CUDA cores.  The two
  // warpgroups take turns to issue (named barriers 1 and 2: a warpgroup's
  // softmax runs while the other's products do), warpgroup 0 first.
  hopper::regs_inc<232>();
  const int half = wg, t = threadIdx.x % 128;
  const int r0 = q0 + half * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  float acc[DH / 2], sc[kFN / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kFN / 2; ++i) sc[i] = 0.f;
  uint32_t hi[kFN / 16][4], lo[kFN / 16][4];     // P of the last tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (half == 1) hopper::bar_arrive(1, 256);
  hopper::mbar_wait(q_full, 0);

  for (int kt = 0; kt <= end; ++kt) {
    const int s = kt % kFStages, sp = (kt + kFStages - 1) % kFStages;
    if (kt < end) hopper::mbar_wait(&k_full[s], (kt / kFStages) & 1);
    if (kt > 0) hopper::mbar_wait(&v_full[sp], ((kt - 1) / kFStages) & 1);
    hopper::bar_sync(1 + half, 256);               // this warpgroup's turn
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    if (kt > 0) {                      // O += P . V: V N-major, P hi + lo
#pragma unroll
      for (int kc = 0; kc < kFN / 16; ++kc) {
        const uint64_t vd =
            hopper::desc_sw128(vs + sp * kKV + 2048 * kc, kKBox, 1024);
        if constexpr (DH == 128) {
          hopper::wgmma_rs_n128(acc, hi[kc], vd);
          hopper::wgmma_rs_n128(acc, lo[kc], vd);
        } else {
          hopper::wgmma_rs_n64(acc, hi[kc], vd);
          hopper::wgmma_rs_n64(acc, lo[kc], vd);
        }
      }
    }
    if (kt < end) {                    // S = Q . K^T: K-major B
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int box = kk / 4, in_box = 32 * (kk % 4);
        hopper::wgmma_ss_n64<0>(
            sc,
            hopper::desc_sw128(qs + box * kQBox + half * 64 * 128 + in_box,
                               16, 1024),
            hopper::desc_sw128(ks + s * kKV + box * kKBox + in_box, 16,
                               1024),
            kk > 0);
      }
    }
    hopper::wgmma_commit();
    if (half == 0 || kt < end) hopper::bar_arrive(2 - half, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(sc);
    if (kt > 0) hopper::mbar_arrive(&empty[sp]);   // tile kt - 1 is read
    if (kt == end) break;

    // online softmax in base 2, on both of this thread's rows (4 threads
    // share a row): masking only on the diagonal tile and the Skv tail;
    // p = 2^(s scale log2(e) - m), m the running max in those units
    const int k0 = kt * kFN;
    if (k0 + kFN > Skv || (causal && k0 + kFN - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i / 2), col = k0 + 8 * j + cq + i % 2;
          if (col >= Skv || (causal && col > row)) sc[4 * j + i] = kNegInf;
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float part[4];                   // a tree, not a chain of 16
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
        const float x = fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]);
        part[j % 4] = j < 4 ? x : fmaxf(part[j % 4], x);
      }
      float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[hr], mx * scale_log2);
      corr[hr] = hopper::ex2(m[hr] - m_new);
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * j + 2 * hr + c];
          x = hopper::ex2(fmaf(x, scale_log2, -m_new));
        }
        const float x = sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
        part[j % 4] = j < 4 ? x : part[j % 4] + x;
      }
      l[hr] = l[hr] * corr[hr]
              + ((part[0] + part[1]) + (part[2] + part[3]));
      m[hr] = m_new;
    }
    // rescale O only where a row's max moved (rare once a row has seen
    // its largest scores); the warp decides together
    if (__any_sync(~0u, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * j + i] *= corr[i / 2];
      }
    }
    // P as the A fragments of the next step's P.V, bfloat16 hi and lo
#pragma unroll
    for (int kc = 0; kc < kFN / 16; ++kc) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_pair(sc[8 * kc + 2 * q], sc[8 * kc + 2 * q + 1], hi[kc][q],
                   lo[kc][q]);
      }
    }
  }

  // o = acc / l, rounded once; rows past Sq are not written
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lsum = l[hr];
    lsum += __shfl_xor_sync(~0u, lsum, 1);
    lsum += __shfl_xor_sync(~0u, lsum, 2);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    const int row = r0 + 8 * hr;
    if (row >= Sq) continue;
    if (lse != nullptr && t % 4 == 0) {  // the row's logsumexp, natural log
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          (m[hr] + log2f(lsum)) * kLn2;
    }
    __nv_bfloat16* orow =
        o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr] * inv,
                                acc[4 * j + 2 * hr + 1] * inv);
    }
  }
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
                 int64_t Hkv, float scale, int causal, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t e = 2;                // bytes of a bfloat16
  const uint64_t qdims[4] = {DH, static_cast<uint64_t>(H),
                             static_cast<uint64_t>(Sq),
                             static_cast<uint64_t>(B)};
  const uint64_t qstr[3] = {DH * e, H * DH * e, Sq * H * DH * e};
  const uint64_t kdims[4] = {DH, static_cast<uint64_t>(Hkv),
                             static_cast<uint64_t>(Skv),
                             static_cast<uint64_t>(B)};
  const uint64_t kstr[3] = {DH * e, Hkv * DH * e, Skv * Hkv * DH * e};
  const uint32_t qbox[4] = {64, 1, kFM, 1}, kbox[4] = {64, 1, kFN, 1};
  if (int rc = hopper::make_map(&qmap, q, 4, qdims, qstr, qbox, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&kmap, k, 4, kdims, kstr, kbox, true)) {
    return rc;
  }
  if (int rc = hopper::make_map(&vmap, v, 4, kdims, kstr, kbox, true)) {
    return rc;
  }
  constexpr size_t smem = wgmma_smem<DH>();
  if (cudaError_t err = cudaFuncSetAttribute(
          flash_attention_wgmma_kernel<DH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((Sq + kFM - 1) / kFM),
                  static_cast<unsigned>(B * H));
  flash_attention_wgmma_kernel<DH><<<grid, kFThreads, smem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse,
      static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(H),
      static_cast<int>(Hkv), scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t Hkv,
             int64_t dh, float scale, int causal, cudaStream_t st) {
  if (dh <= 32) return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, dh,
                                     scale, causal, st);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, dh,
                                     scale, causal, st);
  if (dh <= 80) return launch<T, 80>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, dh,
                                     scale, causal, st);
  return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, dh, scale,
                        causal, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  form (chosen by
// kernels/flash_attention.py's `form`): 0 = flash_attention_kernel, any
// dtype and dh; 1 = flash_attention_wgmma_kernel, bfloat16 with dh 64 or
// 128.  Needs contiguous tensors on 16-byte boundaries, 0 < dh <= 128
// with dh a multiple of 8, H a multiple of Hkv, B * H <= 65535, Sq and Skv
// < 2^31, and Sq == Skv where causal (the wrapper checks; a causal launch
// with Sq != Skv is refused, not masked on some convention).  lse: null,
// or (B, H, Sq) float32 that takes each row's logsumexp of the scaled
// scores (natural log), which the backward (attn_bwd.cu) reads; serving
// passes null and writes nothing more.
int attn_flash_attention(int device, const void* q, const void* k,
                         const void* v, int64_t B, int64_t Sq, int64_t Skv,
                         int64_t H, int64_t Hkv, int64_t dh, float scale,
                         int causal, int dtype, int form, void* o, void* lse,
                         void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
      || dh < 1 || dh > 128 || dh % 8 != 0 || B * H > 65535
      || Sq > 0x7fffffff || Skv > 0x7fffffff || (causal && Sq != Skv)
      || (dtype != 0 && dtype != 1) || (form != 0 && form != 1)
      || (form == 1 && (dtype != 1 || (dh != 64 && dh != 128)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<float*>(lse);
  if (form == 1) {
    return dh == 64 ? launch_wgmma<64>(q, k, v, o, l, B, Sq, Skv, H, Hkv,
                                       scale, causal, st)
                    : launch_wgmma<128>(q, k, v, o, l, B, Sq, Skv, H, Hkv,
                                        scale, causal, st);
  }
  if (dtype == 0) {
    return dispatch<float>(q, k, v, o, l, B, Sq, Skv, H, Hkv, dh, scale,
                           causal, st);
  }
  return dispatch<__nv_bfloat16>(q, k, v, o, l, B, Sq, Skv, H, Hkv, dh,
                                 scale, causal, st);
}

}  // extern "C"
