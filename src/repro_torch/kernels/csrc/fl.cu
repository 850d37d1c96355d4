// Hopper (sm_90a) kernels of the FL protocol path: the reputation-weighted
// merge (paper Eq. 1) and the per-trainer model distance (paper Eq. 4).
//
// Both read stacked (n, P) tensors of trainer models in float32 or
// bfloat16 (dtype flag 0 or 1) and accumulate in float32, and both take T
// such stacks at once, one task per grid row (the cross-task megastep):
// weighted_agg (T, n, P) with (T, n) scores, model_distance (T, n, P)
// rows against (T, P) globals.
// Launchers with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py).  Each takes the device index, raw
// device pointers, the sizes, the dtype flag and a cudaStream_t, allocates
// nothing and returns cudaGetLastError():
//
//   fl_weighted_agg    out[t, p] = sum_i s[t, i] * w[t, i, p]
//                                  / max(sum_i s[t, i], 1e-12)
//   fl_model_distance  out[t, i] = || l[t, i, :] - g[t, :] ||_2, in the
//                      form the caller names (row or cluster, below)
//   fl_model_distance_capacity  how many cluster-form clusters fit
//
// Both are bound by the bytes they read: two or three float operations per
// element against 3.35 TB/s of HBM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch does
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- Eq. 1: weighted_agg ------------------------------------------------------
//
// The sum order is fixed by n alone, never by T, P, the tile or an
// address: the n rows split into kGroups contiguous groups of ceil(n /
// kGroups) rows (the last ones short or empty); each group's sum runs in
// increasing row i from 0.0f, every product s[i] w[i, p] and every sum
// rounded on its own (no fused multiply-add); the kGroups group sums are
// added in group order from 0.0f.  The denominator: lane j of a warp sums
// s[j], s[j + 32], ... in increasing order, then the shuffle tree; one
// correctly rounded division, then the output dtype.  So row t of a
// task-axis launch gives the bits of a launch on task t alone, and
// weighted_agg_mirror in kernels/weighted_agg.py repeats the arithmetic bit
// for bit.
//
// A block owns kAggTileBytes of a row, kAggTileBytes / sizeof(T) columns,
// of one task (grid x: tiles, grid y: tasks); warp r sums row group r over
// them.  (The width was timed on an H100 at 128 to 1,024 bytes at the FL
// paths' shapes and 1M wide: 512 was the fastest or within 1 % at each.)
// The warp's lane 0 stages the group's rows by 1-D bulk copies of their
// 16-byte covers (a row of the FL path is 9,640 bytes, so every other row
// starts 8 bytes off the 16-byte grid), `stage_rows` rows a round through a ring of `stages` rounds on an
// mbarrier each, so shared memory does not grow with n.  Warp 0 sums the
// scores while the first copies are in flight.  The partials meet in
// shared memory, where a thread a column adds them in group order and
// divides.

constexpr int kGroups = 8;                 // row groups, a warp each
constexpr int kAggThreads = kGroups * 32;
constexpr int kRingRows = 8;               // rows a warp stages at once
constexpr int kAggTileBytes = 512;         // a row's span in a block
constexpr int kAggSlot = kAggTileBytes + 16;  // a ring slot: a tile's cover

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
weighted_agg_kernel(const T* __restrict__ w, const float* __restrict__ s,
                    int64_t n, int64_t P, int64_t w_task, int64_t w_row,
                    int stage_rows, int stages, T* __restrict__ out) {
  constexpr int tile = kAggTileBytes / static_cast<int>(sizeof(T));
  constexpr int kCols = tile / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kGroups][2];
  __shared__ float denom;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t task = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int cnt = static_cast<int>(P - c0 < tile ? P - c0 : tile);
  const T* wt = w + task * w_task + c0;
  const float* st = s + task * n;
  const int64_t group = (n + kGroups - 1) / kGroups;
  const int64_t lo = warp * group < n ? warp * group : n;
  const int64_t hi = lo + group < n ? lo + group : n;
  const int64_t rounds = (hi - lo + stage_rows - 1) / stage_rows;
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + static_cast<int64_t>(kGroups) * tile * 4
                        + static_cast<int64_t>(warp) * stages * stage_rows
                          * kAggSlot;
  uint64_t* bar = bars[warp];
  const auto rows_in = [&](int64_t k) {
    const int64_t left = hi - lo - k * stage_rows;
    return static_cast<int>(left < stage_rows ? left : stage_rows);
  };
  const auto row_cover = [&](int64_t i) {
    return hopper::cover(wt + i * w_row, cnt);
  };
  // lane 0: round k's rows into stage k % stages
  const auto stage = [&](int64_t k) {
    const int b = static_cast<int>(k % stages);
    const int64_t r0 = lo + k * stage_rows;
    const int nr = rows_in(k);
    uint32_t bytes = 0;
    for (int j = 0; j < nr; ++j) bytes += row_cover(r0 + j).bytes;
    hopper::mbar_expect_tx(&bar[b], bytes);
    for (int j = 0; j < nr; ++j) {
      const hopper::Cover c = row_cover(r0 + j);
      hopper::bulk_load(ring + (static_cast<int64_t>(b) * stage_rows + j)
                                   * kAggSlot,
                        c.start, c.bytes, &bar[b]);
    }
  };
  if (lane == 0) {
    for (int b = 0; b < stages; ++b) hopper::mbar_init(&bar[b], 1);
    hopper::fence_barrier_init();
    for (int64_t k = 0; k < stages && k < rounds; ++k) stage(k);
  }
  __syncwarp();
  if (warp == 0) {
    float d = 0.f;
    for (int64_t i = lane; i < n; i += 32) d = __fadd_rn(d, __ldg(st + i));
    d = warp_sum(d);
    if (lane == 0) denom = fmaxf(d, 1e-12f);
  }
  float acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
  for (int64_t k = 0; k < rounds; ++k) {
    const int b = static_cast<int>(k % stages);
    const int64_t r0 = lo + k * stage_rows;
    const int nr = rows_in(k);
    const float sv = lane < nr ? __ldg(st + r0 + lane) : 0.f;
    hopper::mbar_wait(&bar[b], static_cast<uint32_t>((k / stages) & 1));
    for (int j = 0; j < nr; ++j) {
      const float sj = __shfl_sync(0xffffffffu, sv, j);
      const T* rs = reinterpret_cast<const T*>(
                        ring + (static_cast<int64_t>(b) * stage_rows + j)
                                   * kAggSlot)
                    + row_cover(r0 + j).head;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        if (c < cnt) {
          acc[q] = __fadd_rn(acc[q], __fmul_rn(sj, to_float(rs[c])));
        }
      }
    }
    __syncwarp();
    if (lane == 0 && k + stages < rounds) {
      hopper::fence_proxy_async_smem();   // the reads above, then the copy
      stage(k + stages);
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) part[warp * tile + lane + 32 * q] = acc[q];
  __syncthreads();
  for (int c = threadIdx.x; c < cnt; c += kAggThreads) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      total = __fadd_rn(total, part[r * tile + c]);
    }
    out[task * P + c0 + c] = from_float<T>(__fdiv_rn(total, denom));
  }
}

// -- Eq. 4: model_distance ---------------------------------------------------
//
// Both forms sum in an order fixed by the element's index alone, never by
// its address: thread j of a group of `lanes` threads (32 in the row form,
// 256 in a block of the cluster form) adds (l_k - g_k)^2 for k = j,
// j + lanes, j + 2 lanes, ... in increasing k, the difference, product and
// sum each rounded on its own (no fused multiply-add); a halving tree of
// shuffles follows.  So a row gives the same bits at any address and in a
// batched launch or alone, and model_distance_mirror in
// kernels/model_distance.py repeats the arithmetic bit for bit.  The rows
// and g reach shared memory by 1-D bulk copies of their 16-byte covers,
// whatever their alignment: the offset into a cover is applied when
// reading.

constexpr int kRowWarps = 8;          // row form: rows of a block, at most
constexpr int kSumThreads = 256;      // cluster form: summing threads ..
constexpr int kClusterBlock = kSumThreads + 32;   // .. and a producer warp
constexpr int kChunkBytes = 8192;     // cluster form: a stage's chunk ..
constexpr int kStages = 3;            // .. in a ring of this many stages
constexpr int kSlot = kChunkBytes + 16;   // a chunk's cover, at most
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxRows = 4;           // cluster form: rows a cluster, at most
constexpr int kDynSmemMax = 232448 - 1024;   // dynamic shared memory a block

__device__ __forceinline__ float sq_add(float acc, float x, float y) {
  const float d = __fsub_rn(x, y);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// Row form (short rows: the FL path's P = 2,410).  Warp w of a block owns
// row blockIdx.x * warps + w of task blockIdx.y.  Thread 0 stages the
// task's g once and each warp's row, each on an mbarrier of its own; one
// block barrier publishes the barriers' init, then each warp waits for g
// and its row, sums them (lanes = 32) and lane 0 writes.  No other
// barrier, no atomics.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
distance_row_kernel(const T* __restrict__ l, const T* __restrict__ g,
                    int64_t n, int64_t P, int64_t l_task, int64_t l_row,
                    int64_t g_task, uint32_t slot, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kRowWarps + 1];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t task = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * warps;
  const T* gt = g + task * g_task;
  const T* lt = l + task * l_task;
  if (threadIdx.x == 0) {
    for (int b = 0; b <= warps; ++b) hopper::mbar_init(&bars[b], 1);
    hopper::fence_barrier_init();
    const hopper::Cover gc = hopper::cover(gt, P);
    hopper::mbar_expect_tx(&bars[warps], gc.bytes);
    if (gc.bytes) hopper::bulk_load(smem, gc.start, gc.bytes, &bars[warps]);
    for (int w = 0; w < warps && row0 + w < n; ++w) {
      const hopper::Cover rc = hopper::cover(lt + (row0 + w) * l_row, P);
      hopper::mbar_expect_tx(&bars[w], rc.bytes);
      if (rc.bytes) {
        hopper::bulk_load(smem + (w + 1) * slot, rc.start, rc.bytes,
                          &bars[w]);
      }
    }
  }
  __syncthreads();
  const int64_t row = row0 + warp;
  if (row >= n) return;
  const T* gs = reinterpret_cast<const T*>(smem) + hopper::cover(gt, P).head;
  const T* rs = reinterpret_cast<const T*>(smem + (warp + 1) * slot)
                + hopper::cover(lt + row * l_row, P).head;
  hopper::mbar_wait(&bars[warps], 0);
  hopper::mbar_wait(&bars[warp], 0);
  float acc = 0.f;
  // unrolled: the loads run ahead of the one serial chain, the sums
  // (unrolling reorders no sum)
#pragma unroll 8
  for (int64_t k = lane; k < P; k += 32) {
    acc = sq_add(acc, to_float(rs[k]), to_float(gs[k]));
  }
  acc = warp_sum(acc);
  if (lane == 0) out[task * n + row] = __fsqrt_rn(acc);
}

// Cluster form (long rows: the 1M-wide point).  A cluster of `cs` blocks
// owns `rows` consecutive rows of task blockIdx.y (rows blockIdx.x / cs
// times `rows` on); block rank r owns their elements [r span, (r + 1)
// span).  A producer warp streams that range of g once and of each row
// through a ring of kStages chunks (full and empty mbarriers), so g's
// bytes cross L2 once a row group, not once a row; the 256 summing
// threads keep a sum a row (lanes = 256), then a warp tree and a tree
// over the 8 warps.  Each block stores its partials into rank 0's shared
// memory, and rank 0 adds each row's cs partials in rank order and
// writes.  A row's arithmetic does not depend on `rows`.
template <typename T>
__global__ void __launch_bounds__(kClusterBlock)
distance_cluster_kernel(const T* __restrict__ l, const T* __restrict__ g,
                        int64_t n, int64_t P, int64_t l_task, int64_t l_row,
                        int64_t g_task, int cs, int rows, int64_t span,
                        float* __restrict__ out) {
  constexpr int64_t kChunk = kChunkBytes / sizeof(T);
  constexpr int kWarps = kSumThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float warp_part[kMaxRows][kWarps];
  __shared__ float rank_part[kMaxRows][kMaxCluster];
  hopper::cluster_arrive_release();    // this block has started
  const uint32_t rank = hopper::cluster_ctarank();
  const int64_t task = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / cs) * rows;
  const int nr = static_cast<int>(n - row0 < rows ? n - row0 : rows);
  const T* rp = l + task * l_task + row0 * l_row;
  const T* gp = g + task * g_task;
  const int64_t lo = rank * span;
  const int64_t len = P - lo >= span ? span : (P > lo ? P - lo : 0);
  const int64_t stages = (len + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // stage b: g's chunk in slot b (rows + 1), row r's in the r + 1 after it
  const auto slot = [&](int b, int i) {
    return smem + (static_cast<int64_t>(b) * (rows + 1) + i) * kSlot;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  float acc[kMaxRows] = {0.f, 0.f, 0.f, 0.f};
  if (warp == kWarps) {
    if (lane == 0) {
      for (int64_t s = 0; s < stages; ++s) {
        const int b = static_cast<int>(s % kStages);
        if (s >= kStages) {
          hopper::mbar_wait(&empty[b], static_cast<uint32_t>(
                                           (s / kStages - 1) & 1));
        }
        const int64_t at = lo + s * kChunk;
        const int64_t cnt = lo + len - at < kChunk ? lo + len - at : kChunk;
        const hopper::Cover gc = hopper::cover(gp + at, cnt);
        uint32_t bytes = gc.bytes;
        for (int r = 0; r < nr; ++r) {
          bytes += hopper::cover(rp + r * l_row + at, cnt).bytes;
        }
        hopper::mbar_expect_tx(&full[b], bytes);
        hopper::bulk_load(slot(b, 0), gc.start, gc.bytes, &full[b]);
        for (int r = 0; r < nr; ++r) {
          const hopper::Cover rc = hopper::cover(rp + r * l_row + at, cnt);
          hopper::bulk_load(slot(b, r + 1), rc.start, rc.bytes, &full[b]);
        }
      }
    }
    __syncwarp();
  } else {
    // a chunk starts a multiple of 16 bytes after the row's (and g's)
    // first element, so one offset into the cover serves every stage
    const int gh = hopper::cover(gp, 1).head;
    int rh[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      rh[r] = r < nr ? hopper::cover(rp + r * l_row, 1).head : 0;
    }
    for (int64_t s = 0; s < stages; ++s) {
      const int b = static_cast<int>(s % kStages);
      hopper::mbar_wait(&full[b], static_cast<uint32_t>((s / kStages) & 1));
      const T* gs = reinterpret_cast<const T*>(slot(b, 0)) + gh;
      const int64_t left = len - s * kChunk;
      const int cnt = static_cast<int>(left < kChunk ? left : kChunk);
#pragma unroll
      for (int i = 0; i < kChunk / kSumThreads; ++i) {
        const int k = static_cast<int>(threadIdx.x) + i * kSumThreads;
        if (k < cnt) {
          const float gv = to_float(gs[k]);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < nr) {
              const T* rs = reinterpret_cast<const T*>(slot(b, r + 1))
                            + rh[r];
              acc[r] = sq_add(acc[r], to_float(rs[k]), gv);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[b]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      acc[r] = warp_sum(acc[r]);
      if (lane == 0) warp_part[r][warp] = acc[r];
    }
    hopper::bar_sync(1, kSumThreads);
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        acc[r] = lane < kWarps ? warp_part[r][lane] : 0.f;
#pragma unroll
        for (int o = kWarps / 2; o > 0; o >>= 1) {
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
      }
    }
  }
  hopper::cluster_wait_acquire();      // every block has started
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nr) {
        hopper::st_cluster_u32(
            hopper::map_rank(hopper::smem_u32(&rank_part[r][rank]), 0),
            __float_as_uint(acc[r]));
      }
    }
  }
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();
  if (rank == 0 && static_cast<int>(threadIdx.x) < nr) {
    const int r = threadIdx.x;
    float sum = rank_part[r][0];
    for (int q = 1; q < cs; ++q) sum = __fadd_rn(sum, rank_part[r][q]);
    out[task * n + row0 + r] = __fsqrt_rn(sum);
  }
}

int64_t blocks_for(int64_t items, int64_t per_block) {
  return (items + per_block - 1) / per_block;
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
             != cudaSuccess) {
    return 132;
  }
  return sms;
}

// weighted_agg's launch: a block a tile of a task; a warp's ring
// holds its whole group where the group has at most kRingRows rows (one
// round: the FL path's 64 rows), else two stages of kRingRows / 2 rows.
template <typename T>
int launch_agg(const void* w, const float* s, int64_t T_, int64_t n,
               int64_t P, int64_t w_task, int64_t w_row, void* out,
               cudaStream_t st) {
  const int64_t tile = kAggTileBytes / static_cast<int64_t>(sizeof(T));
  const int64_t tiles = blocks_for(P, tile);
  if (n < 0 || tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t group = (n + kGroups - 1) / kGroups;
  const int stages = group <= kRingRows ? 1 : 2;
  const int64_t stage_rows = group <= kRingRows
                                 ? (group > 0 ? group : 1) : kRingRows / 2;
  const int64_t smem = kGroups * tile * 4 + kGroups * stages * stage_rows
                                                * kAggSlot;
  if (cudaError_t e = cudaFuncSetAttribute(
          weighted_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(T_));
  weighted_agg_kernel<T><<<grid, kAggThreads, static_cast<size_t>(smem),
                           st>>>(
      static_cast<const T*>(w), s, n, P, w_task, w_row,
      static_cast<int>(stage_rows), stages, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of the cluster form's ring at `rows` rows
constexpr int cluster_smem(int rows) { return kStages * (rows + 1) * kSlot; }

// fills `config` (and `attr`) for the cluster form's launch
template <typename T>
cudaError_t cluster_config(cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr, int64_t T_,
                           int64_t groups, int cs, int rows,
                           cudaStream_t st) {
  if (cudaError_t e = cudaFuncSetAttribute(
          distance_cluster_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          cluster_smem(kMaxRows))) {
    return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cs);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(groups * cs),
                         static_cast<unsigned>(T_));
  config->blockDim = dim3(kClusterBlock);
  config->dynamicSmemBytes = cluster_smem(rows);
  config->stream = st;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch_distance(const void* l, const void* g, int64_t T_, int64_t n,
                    int64_t P, int64_t l_task, int64_t l_row, int64_t g_task,
                    int form, int64_t cs, int64_t span, float* out,
                    cudaStream_t st) {
  const auto lp = static_cast<const T*>(l);
  const auto gp = static_cast<const T*>(g);
  if (form == 0) {
    // a row's cover and one 16-byte granule of slack per slot
    const int64_t slot = (P * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16
                         + 16;
    // rows a block: enough blocks to reach every SM where the rows allow
    // (the sums do not depend on it), as shared memory allows
    int64_t warps = T_ * n / sm_count();
    warps = warps < 1 ? 1 : (warps > kRowWarps ? kRowWarps : warps);
    if (warps > n) warps = n;
    while (warps > 1 && (warps + 1) * slot > kDynSmemMax) --warps;
    const int64_t smem = (warps + 1) * slot;
    if (smem > kDynSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (cudaError_t e = cudaFuncSetAttribute(
            distance_row_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem))) {
      return static_cast<int>(e);
    }
    const dim3 grid(static_cast<unsigned>(blocks_for(n, warps)),
                    static_cast<unsigned>(T_));
    distance_row_kernel<T><<<grid, static_cast<unsigned>(warps * 32),
                             static_cast<size_t>(smem), st>>>(
        lp, gp, n, P, l_task, l_row, g_task, static_cast<uint32_t>(slot),
        out);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int64_t kChunk = kChunkBytes / sizeof(T);
  if (form != 1 || cs < 1 || cs > kMaxCluster || span < kChunk
      || span % kChunk != 0 || cs * span < P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows a cluster: g crosses L2 once for them all, but a larger ring
  // leaves room for fewer blocks an SM, so no more rows than keep about
  // a block an SM.  The sums do not depend on it.
  int64_t rows = T_ * n * cs / sm_count();
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int64_t groups = blocks_for(n, rows);
  if (groups * cs > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = cluster_config<T>(&config, &attr, T_, groups,
                                        static_cast<int>(cs),
                                        static_cast<int>(rows), st)) {
    return static_cast<int>(e);
  }
  // refused, not run another way, where no GPC can hold one cluster
  int clusters = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveClusters(
          &clusters, distance_cluster_kernel<T>, &config)) {
    return static_cast<int>(e);
  }
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  if (cudaError_t e = cudaLaunchKernelEx(
          &config, distance_cluster_kernel<T>, lp, gp, n, P, l_task, l_row,
          g_task, static_cast<int>(cs), static_cast<int>(rows), span, out)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// how many clusters the card holds at once, at the most rows a cluster
template <typename T>
int distance_capacity(int64_t cs, int* clusters) {
  if (cs < 1 || cs > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = cluster_config<T>(&config, &attr, 1, 1,
                                        static_cast<int>(cs), kMaxRows,
                                        nullptr)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, distance_cluster_kernel<T>, &config));
}

}  // namespace

extern "C" {

// T stacks of n rows of P elements: row i of task t at w + t w_task +
// i w_row (strides in elements, each row contiguous); dtype: 0 = float32,
// 1 = bfloat16 (w and out); s is float32 (T, n), out (T, P) contiguous.
int fl_weighted_agg(int device, const void* w, const void* s, int64_t T,
                    int64_t n, int64_t P, int64_t w_task, int64_t w_row,
                    int dtype, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (T < 1 || T > 65535 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sf = static_cast<const float*>(s);
  if (dtype == 0) {
    return launch_agg<float>(w, sf, T, n, P, w_task, w_row, out, st);
  }
  if (dtype == 1) {
    return launch_agg<__nv_bfloat16>(w, sf, T, n, P, w_task, w_row, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// T tasks of n rows of P elements: row i of task t at l + t l_task +
// i l_row, its global at g + t g_task (strides in elements, each row
// contiguous); dtype: 0 = float32, 1 = bfloat16 (l and g); form: 0 = row,
// 1 = cluster (cs blocks a row, `span` elements a block, a multiple of the
// chunk); out is float32 (T, n).
int fl_model_distance(int device, const void* l, const void* g, int64_t T,
                      int64_t n, int64_t P, int64_t l_task, int64_t l_row,
                      int64_t g_task, int dtype, int form, int64_t cs,
                      int64_t span, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (T < 1 || T > 65535 || n < 1 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto of = static_cast<float*>(out);
  if (dtype == 0) {
    return launch_distance<float>(l, g, T, n, P, l_task, l_row, g_task, form,
                                  cs, span, of, st);
  }
  if (dtype == 1) {
    return launch_distance<__nv_bfloat16>(l, g, T, n, P, l_task, l_row,
                                          g_task, form, cs, span, of, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// how many cluster-form clusters of cs blocks the card holds at once
int fl_model_distance_capacity(int device, int dtype, int64_t cs, void* out,
                               void* stream) {
  (void)stream;
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  int* clusters = static_cast<int*>(out);
  if (dtype == 0) return distance_capacity<float>(cs, clusters);
  if (dtype == 1) return distance_capacity<__nv_bfloat16>(cs, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
