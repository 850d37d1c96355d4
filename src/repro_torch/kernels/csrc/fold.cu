// Hopper (sm_90a) kernels for the ledger's xor-mix folds.
//
// Every digest of the rollup node path is the same fold: each u32 word is
// mixed as mix(w) = (w ^ (w >> 16)) * 0x85EBCA6B (mod 2^32), the mixed
// words of a span are xor-reduced, and the result is xor-ed with the seed
// 0x9E3779B9.  Zero words mix to zero, so a ragged tail needs no padding:
// a thread that has no word folds in zero.
//
// Four launchers with a plain C interface (loaded with ctypes by
// src/repro_torch/kernels/_build.py).  Each takes the device index, raw
// device pointers and a cudaStream_t, allocates nothing and returns
// cudaGetLastError():
//
//   fold_rollup_digest   whole buffer -> one word (one cluster, or a
//                        cluster a partial word and a fold of the partials)
//   fold_chunk_digests   one word per `chunk`-word chunk
//   fold_dirty_chunks    one word per selected chunk id
//   fold_batch_seal      one word per [starts[i], starts[i+1]) segment
//
// All four are bound by the bytes they read: a few integer operations per
// 4-byte word against 3.35 TB/s of HBM.  The span fold below reads 16-byte
// (uint4) vectors where the address allows it, neighbouring threads on
// neighbouring vectors, with scalar loads for the unaligned head and the
// tail.  Xor is commutative and associative, so every reduction order --
// warp shuffles, shared memory, distributed shared memory -- gives the
// same bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr uint32_t kMixMult = 0x85EBCA6Bu;
constexpr uint32_t kMixSeed = 0x9E3779B9u;
constexpr int kBlock = 256;          // threads per block (8 warps)
constexpr int kDigestBlock = 1024;   // rollup_digest: threads per block ..
constexpr int kDigestCluster = 16;   // .. and blocks per cluster

__device__ __forceinline__ uint32_t mix(uint32_t w) {
  return (w ^ (w >> 16)) * kMixMult;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Xor of `v` over a block of kThreads; the result is valid in thread 0.
template <int kThreads = kBlock>
__device__ __forceinline__ uint32_t block_xor(uint32_t v) {
  __shared__ uint32_t partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_xor(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0u;
  if (warp == 0) v = warp_xor(v);
  return v;
}

__device__ __forceinline__ uint32_t mix4(const uint4& q) {
  return mix(q.x) ^ mix(q.y) ^ mix(q.z) ^ mix(q.w);
}

// Thread `t` of `step` threads (step >= 4) folds its share of w[lo, hi).
__device__ __forceinline__ uint32_t fold_span(const uint32_t* __restrict__ w,
                                              int64_t lo, int64_t hi,
                                              int64_t t, int64_t step) {
  uint32_t acc = 0;
  // words before the first 16-byte boundary (at most 3)
  const int64_t head = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(w + lo) & 15u)) & 15u) >> 2);
  const int64_t a = lo + head < hi ? lo + head : hi;
  if (lo + t < a) acc ^= mix(w[lo + t]);
  const int64_t nv = (hi - a) >> 2;
  const uint4* __restrict__ v = reinterpret_cast<const uint4*>(w + a);
  for (int64_t i = t; i < nv; i += step) {
    const uint4 q = __ldg(v + i);
    acc ^= mix(q.x) ^ mix(q.y) ^ mix(q.z) ^ mix(q.w);
  }
  const int64_t b = a + 4 * nv;      // at most 3 words left
  if (b + t < hi) acc ^= mix(w[b + t]);
  return acc;
}

// Thread `t` of `step` threads folds its share of w[0, n) as fold_span
// does, with four 16-byte loads in flight a thread.  Word j belongs to one
// thread: j itself before the first 16-byte boundary (at most 3 words),
// (j - head) / 4 mod step in the vector body, j - body end in the tail
// (kernels/rollup_digest.py, rollup_digest_mirror, spells it out).
__device__ __forceinline__ uint32_t fold_span4(const uint32_t* __restrict__ w,
                                               int64_t n, int64_t t,
                                               int64_t step) {
  uint32_t acc = 0;
  const int64_t head = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(w) & 15u)) & 15u) >> 2);
  const int64_t a = head < n ? head : n;
  if (t < a) acc ^= mix(w[t]);
  const int64_t nv = (n - a) >> 2;
  const uint4* __restrict__ v = reinterpret_cast<const uint4*>(w + a);
  int64_t i = t;
  for (; i + 3 * step < nv; i += 4 * step) {
    const uint4 q0 = __ldg(v + i), q1 = __ldg(v + i + step);
    const uint4 q2 = __ldg(v + i + 2 * step), q3 = __ldg(v + i + 3 * step);
    acc ^= mix4(q0) ^ mix4(q1) ^ mix4(q2) ^ mix4(q3);
  }
  for (; i < nv; i += step) acc ^= mix4(__ldg(v + i));
  const int64_t b = a + 4 * nv;      // at most 3 words left
  if (b + t < n) acc ^= mix(w[b + t]);
  return acc;
}

// Whole buffer: clusters of kDigestCluster blocks of kDigestBlock threads
// fold it in one grid-stride pass; a warp then block xor; each block
// stores its word into rank 0's shared memory, and rank 0 xors the
// cluster's words.  With one cluster it writes the digest itself, seed
// included (`whole`); with several, cluster c writes its partial word to
// out[c] and fold_parts_kernel finishes.  No atomics, no fill.
__global__ void __launch_bounds__(kDigestBlock)
rollup_digest_kernel(const uint32_t* __restrict__ w, int64_t n, int whole,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t rank_word[kDigestCluster];
  hopper::cluster_arrive_release();    // this block has started
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDigestBlock
                    + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kDigestBlock;
  const uint32_t acc = block_xor<kDigestBlock>(fold_span4(w, n, t, step));
  const uint32_t rank = hopper::cluster_ctarank();
  hopper::cluster_wait_acquire();      // every block has started
  if (threadIdx.x == 0) {
    hopper::st_cluster_u32(
        hopper::map_rank(hopper::smem_u32(&rank_word[rank]), 0), acc);
  }
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t x = 0;
    for (int r = 0; r < kDigestCluster; ++r) x ^= rank_word[r];
    if (whole) {
      out[0] = kMixSeed ^ x;
    } else {
      out[blockIdx.x / kDigestCluster] = x;
    }
  }
}

// One warp: the seed xor the clusters' partial words.
__global__ void __launch_bounds__(32)
fold_parts_kernel(const uint32_t* __restrict__ parts, int64_t k,
                  uint32_t* __restrict__ out) {
  uint32_t x = 0;
  for (int64_t i = threadIdx.x; i < k; i += 32) x ^= parts[i];
  x = warp_xor(x);
  if (threadIdx.x == 0) out[0] = kMixSeed ^ x;
}

// One block per chunk; the last chunk may be ragged.
__global__ void __launch_bounds__(kBlock)
chunk_digests_kernel(const uint32_t* __restrict__ w, int64_t n,
                     int64_t chunk, uint32_t* __restrict__ out) {
  const int64_t c = blockIdx.x;
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const uint32_t acc = block_xor(fold_span(w, lo, hi, threadIdx.x, kBlock));
  if (threadIdx.x == 0) out[c] = kMixSeed ^ acc;
}

// One block per selected chunk: each block reads its own chunk id, so the
// gather of the chunk rows happens in the loads.  An id outside
// [0, n_chunks) folds as an empty chunk instead of reading out of bounds.
__global__ void __launch_bounds__(kBlock)
dirty_chunks_kernel(const uint32_t* __restrict__ w, int64_t n, int64_t chunk,
                    const int64_t* __restrict__ ids,
                    uint32_t* __restrict__ out) {
  const int64_t c = ids[blockIdx.x];
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  uint32_t acc = 0;
  if (c >= 0 && c < n_chunks) {
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    acc = fold_span(w, lo, hi, threadIdx.x, kBlock);
  }
  acc = block_xor(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = kMixSeed ^ acc;
}

// One warp per segment: segments on the node path are one rollup batch
// (20 txs x 4 words), far too short for a block.  Segment i ends at
// starts[i + 1], the last one at n.
__global__ void __launch_bounds__(kBlock)
batch_seal_kernel(const uint32_t* __restrict__ w, int64_t n,
                  const int64_t* __restrict__ starts, int64_t nb,
                  uint32_t* __restrict__ out) {
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * (kBlock / 32)
                      + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= nb) return;             // whole warps leave together
  int64_t lo = starts[seg];
  int64_t hi = seg + 1 < nb ? starts[seg + 1] : n;
  lo = lo < 0 ? 0 : lo;
  hi = hi > n ? n : hi;
  const uint32_t acc = lo < hi ? warp_xor(fold_span(w, lo, hi, lane, 32))
                               : 0u;
  if (lane == 0) out[seg] = kMixSeed ^ acc;
}

int64_t blocks_for(int64_t items, int64_t per_block) {
  return (items + per_block - 1) / per_block;
}

// fills `config` (and `attr`) for rollup_digest_kernel over `clusters`
cudaError_t digest_config(cudaLaunchConfig_t* config,
                          cudaLaunchAttribute* attr, int64_t clusters,
                          cudaStream_t st) {
  if (cudaError_t e = cudaFuncSetAttribute(
          rollup_digest_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) {
    return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kDigestCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(clusters * kDigestCluster));
  config->blockDim = dim3(kDigestBlock);
  config->stream = st;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// `clusters` (kernels/rollup_digest.py plan): 1 writes the digest to
// out[0] in one launch; k > 1 writes k partial words to `parts` (k int32
// of scratch), then folds them with the seed into out[0].
int fold_rollup_digest(int device, const void* words, int64_t n,
                       int64_t clusters, void* parts, void* out,
                       void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (clusters < 1 || clusters > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = digest_config(&config, &attr, clusters, st)) {
    return static_cast<int>(e);
  }
  // refused, not run another way, where no GPC can hold one cluster
  int fit = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveClusters(
          &fit, rollup_digest_kernel, &config)) {
    return static_cast<int>(e);
  }
  if (fit < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  const auto w = static_cast<const uint32_t*>(words);
  const int whole = clusters == 1;
  auto* dst = static_cast<uint32_t*>(whole ? out : parts);
  if (cudaError_t e = cudaLaunchKernelEx(&config, rollup_digest_kernel, w, n,
                                         whole, dst)) {
    return static_cast<int>(e);
  }
  if (!whole) {
    fold_parts_kernel<<<1, 32, 0, st>>>(dst, clusters,
                                        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int fold_chunk_digests(int device, const void* words, int64_t n,
                       int64_t chunk, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const int64_t n_chunks = blocks_for(n, chunk);
  chunk_digests_kernel<<<static_cast<unsigned>(n_chunks), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, chunk,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int fold_dirty_chunks(int device, const void* words, int64_t n,
                      int64_t chunk, const void* ids, int64_t n_ids, void* out,
                      void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  dirty_chunks_kernel<<<static_cast<unsigned>(n_ids), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, chunk,
      static_cast<const int64_t*>(ids), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int fold_batch_seal(int device, const void* words, int64_t n,
                    const void* starts, int64_t nb, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const int64_t grid = blocks_for(nb, kBlock / 32);
  batch_seal_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n,
      static_cast<const int64_t*>(starts), nb, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
