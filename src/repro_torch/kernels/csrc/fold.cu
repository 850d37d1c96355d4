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
//   fold_chunk_digests   one word per `chunk`-word chunk, every chunk
//   fold_dirty_chunks    one word per selected chunk id
//                        (both fold a chunk with a warp, or with a block
//                        for long chunks: fold_chunk)
//   fold_batch_seal      one word per [starts[i], starts[i+1]) segment:
//                        equal spans of words a block, whatever the
//                        segments, in one launch
//
// (shard_seal, the same segment fold over K lanes, is csrc/shard.cu.)
// fold_error_string names any launcher's error code.
//
// All four are bound by the bytes they read: a few integer operations per
// 4-byte word against 3.35 TB/s of HBM.  What keeps a read at that rate is
// enough bytes in flight on every SM: the span folds below read 16-byte
// (uint4) vectors, four in flight a thread, neighbouring threads on
// neighbouring vectors, with scalar loads for the unaligned head and the
// tail; batch_seal stages its span with one 1-D bulk copy (TMA) of the
// span's 16-byte cover.  Xor is commutative and associative, so every
// reduction order -- warp shuffles, shared-memory atomics, distributed
// shared memory, a prefix over blocks -- gives the same bits.
//
// batch_seal's spans and carries.  Block b folds words [b S, (b+1) S) of
// the buffer (S, the span, from kernels/batch_seal.py plan), so every
// launch has ceil(n / S) blocks whatever the segment lengths: a segment of
// one word, of 80 or of the whole buffer.  While the bulk copy runs, the
// block finds the starts that fall in its span (a search of `starts` with
// all its threads, a probe a thread: one round for 50,000 segments) and
// stages them in shared memory.  Each thread then walks a contiguous run
// of the span: a segment that starts and ends in its run it writes
// itself, seed included; a piece of a longer segment it xors into the
// shared-memory slot of the first run edge after the segment's start (an
// atomicXor), and the thread at that edge writes the segment once the
// block has walked.  The block leaves two carries: `first`, the piece of
// the segment begun before the span, and the piece of a segment that
// starts in the span and runs past it (its id, its value and the span its
// last word lies in).  The last block to finish (a __threadfence, then a
// ticket from a counter that the same block resets to 0, so no fill
// launch is ever needed) takes a prefix xor P of `first` over the spans
// and writes each running segment as seed ^ its piece ^ P[end span] ^
// P[its span].  The counter is one word of the library per device, so the
// calls of one device must run one at a time: the port launches every
// kernel on torch's current stream, and batch_seal must not run on two
// streams at once.  kernels/batch_seal.py batch_seal_mirror repeats the
// spans, pieces and carries on the CPU.

#include <climits>
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

// Thread `t` of `step` threads (step >= 4) folds its share of w[0, n):
// 16-byte loads, four in flight a thread.  Word j belongs to one thread:
// j itself before the first 16-byte boundary (at most 3 words),
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

// The digest of chunk c of w[0, n) (the last chunk may be ragged), folded
// by a group of kWarps warps of which this thread is thread t: a warp (1)
// with four 16-byte loads in flight a lane and a shuffle xor -- no shared
// memory, no __syncthreads -- or a block (kBlock / 32 warps) with a block
// xor for long chunks.  Valid in thread t == 0.  A c outside [0, n_chunks)
// folds as an empty chunk (the seed) instead of reading out of bounds.
template <int kWarps>
__device__ __forceinline__ uint32_t fold_chunk(const uint32_t* __restrict__ w,
                                               int64_t n, int64_t chunk,
                                               int64_t c, int t) {
  constexpr int kThreads = 32 * kWarps;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  uint32_t acc = 0;
  if (c >= 0 && c < n_chunks) {
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    acc = fold_span4(w + lo, hi - lo, t, kThreads);
  }
  if constexpr (kWarps == 1) {
    acc = warp_xor(acc);
  } else {
    acc = block_xor<kThreads>(acc);
  }
  return kMixSeed ^ acc;
}

// Every chunk, in order: group i (a warp, or a block of kWarps warps) of
// the grid folds chunk i, with no id tensor; kBlock / 32 / kWarps chunks a
// block.
template <int kWarps>
__global__ void __launch_bounds__(kBlock)
chunk_digests_kernel(const uint32_t* __restrict__ w, int64_t n,
                     int64_t chunk, uint32_t* __restrict__ out) {
  constexpr int kThreads = 32 * kWarps;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (kBlock / kThreads)
                    + threadIdx.x / kThreads;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  if (kWarps == 1 && c >= n_chunks) return;   // whole warps leave together
  const int t = threadIdx.x % kThreads;
  const uint32_t digest = fold_chunk<kWarps>(w, n, chunk, c, t);
  if (t == 0) out[c] = digest;
}

// The chunks named by ids[0, d): group i folds chunk ids[i], so the
// gather of the chunk rows happens in the loads.
template <int kWarps>
__global__ void __launch_bounds__(kBlock)
dirty_fold_kernel(const uint32_t* __restrict__ w, int64_t n, int64_t chunk,
                  const int64_t* __restrict__ ids, int64_t d,
                  uint32_t* __restrict__ out) {
  constexpr int kThreads = 32 * kWarps;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kBlock / kThreads)
                    + threadIdx.x / kThreads;
  if (kWarps == 1 && i >= d) return;   // whole warps leave together
  const int t = threadIdx.x % kThreads;
  const uint32_t digest = fold_chunk<kWarps>(w, n, chunk, ids[i], t);
  if (t == 0) out[i] = digest;
}

// -- batch_seal: equal spans of words, carries across them -------------------

constexpr int kSealThreads = 256;
constexpr int kSealMinSpan = 4 * kSealThreads;  // one uint4 a thread
constexpr int kSealMaxSpan = 8 * kSealMinSpan;  // 8,192 words, 32 KB

// What block b leaves for the last block (see the top of the file).
struct SealCarry {
  int64_t seg;        // the segment of `last`, -1 if no segment runs past
  int64_t end_block;  // the span that holds that segment's last word
  uint32_t first;     // piece of the segment begun before the span (or 0);
                      // the last block overwrites it with the prefix xor
  uint32_t last;      // piece of segment `seg` in this span
};

__device__ __forceinline__ int64_t ldg_i64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int64_t ldcg_i64(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

// batch_seal's ticket: blocks that have left their carries in this launch
__device__ unsigned int g_seal_ticket = 0;

// Dynamic shared memory of a span of `span` words and `staged` starts:
// the staged cover (at most span + 4 words), a slot a run edge
// (kSealThreads + 1) and the staged starts (span-relative int16).
__host__ __device__ constexpr int seal_smem(int span, int staged) {
  return 4 * (span + 4) + 4 * (kSealThreads + 1) + 2 * staged;
}

// Narrows lb[k], the number of starts[0, nb) below key[k] (key[0] <=
// key[1]), for two keys at once, to [lb[k], lb[k] + len[k]] until
// starts[lb[0], lb[1] + len[1]] fits in `cap` staged starts, using every
// thread of the block: a round splits each range left into kSealThreads
// probes, one a thread, and counts those below the key.  No round where
// nb fits; one for the node path's 2,510 and 50,040 batches.
__device__ __forceinline__ void seal_bounds(const int64_t* __restrict__ starts,
                                            int64_t nb, const int64_t key[2],
                                            int cap, int64_t lb[2],
                                            int64_t len[2]) {
  lb[0] = lb[1] = 0;
  len[0] = len[1] = nb;
  while ((len[0] > 0 || len[1] > 0) && lb[1] + len[1] - lb[0] >= cap) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t stride = (len[k] + kSealThreads - 1) / kSealThreads;
      const int64_t end = lb[k] + len[k];
      const int64_t at = lb[k] + (threadIdx.x + 1) * stride - 1;
      const bool below = len[k] > 0 && at < end
                         && ldg_i64(starts + at) < key[k];
      const int64_t count = __syncthreads_count(below);
      if (len[k] > 0) {
        lb[k] += count * stride;
        len[k] = stride - 1 < end - lb[k] ? stride - 1 : end - lb[k];
      }
    }
  }
}

// Block b of `blocks` folds words [b span, (b+1) span) of w[0, n) into the
// segments that begin at starts[0, nb) (strictly increasing, starts[0] >=
// 0, starts[nb-1] < n; words before starts[0] belong to no segment).
// Other starts never make it read or write out of bounds, but their
// digests are not defined.  `carry` holds `blocks` records; `ticket`
// counts the blocks that left theirs (the last one resets it to 0).
// `smem` is the launch's dynamic shared memory (seal_smem bytes).
// batch_seal_span_kernel runs it once a launch.
__device__ __forceinline__ void seal_span(
    const uint32_t* __restrict__ w, int64_t n,
    const int64_t* __restrict__ starts, int64_t nb, int span, int window,
    int staged_cap, SealCarry* __restrict__ carry, uint32_t* __restrict__ out,
    unsigned int* ticket, int64_t b, int64_t blocks, unsigned char* smem) {
  __shared__ uint64_t bar;
  __shared__ uint32_t warp_words[kSealThreads / 32];
  __shared__ int below[2];
  __shared__ int64_t last_seg;
  __shared__ int is_last;
  const int64_t lo = b * span;
  const int64_t hi = lo + span < n ? lo + span : n;
  const int len = static_cast<int>(hi - lo);
  const int tail = static_cast<int>(n - lo);   // n < 2^31 (the launcher)
  const hopper::Cover cov = hopper::cover(w + lo, len);
  auto* stage = reinterpret_cast<uint4*>(smem);
  auto* slot = reinterpret_cast<uint32_t*>(smem + 4 * (span + 4));
  auto* staged = reinterpret_cast<int16_t*>(slot + kSealThreads + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar, 1);
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bar, cov.bytes);
    hopper::bulk_load(stage, cov.start, cov.bytes, &bar);
    below[0] = below[1] = 0;
    last_seg = -1;
  }
  for (int k = threadIdx.x; k <= kSealThreads; k += kSealThreads) {
    slot[k] = 0;
  }
  __syncthreads();
  // While the copy runs: the starts of this span.  A coarse search leaves
  // k0 = lb(lo) and k1 = lb(hi) in
  // starts[a, z]; one round of loads stages them (relative to lo, clamped
  // to [-1, span + 1]: every test below is against a word of the span or
  // its end) and counts those below lo and below hi.
  const int64_t key[2] = {lo, hi};
  int64_t lb[2], open[2];
  seal_bounds(starts, nb, key, staged_cap, lb, open);
  const int64_t a = lb[0];
  int64_t z = lb[1] + open[1] < nb ? lb[1] + open[1] : nb - 1;
  z = z - a < staged_cap ? z : a + staged_cap - 1;
  int n_lo = 0, n_hi = 0;
  for (int64_t j = threadIdx.x; a + j <= z; j += kSealThreads) {
    const int64_t v = ldg_i64(starts + a + j) - lo;
    const int rel = v < 0 ? -1 : (v > span ? span + 1 : static_cast<int>(v));
    staged[j] = static_cast<int16_t>(rel);
    n_lo += rel < 0;
    n_hi += rel < len;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_lo += __shfl_xor_sync(0xffffffffu, n_lo, o);
    n_hi += __shfl_xor_sync(0xffffffffu, n_hi, o);
  }
  if (lane == 0) {
    atomicAdd(&below[0], n_lo);
    atomicAdd(&below[1], n_hi);
  }
  __syncthreads();
  // the window: starts[k0, k0 + m), at staged[c0, c0 + m)
  const int c0 = below[0];
  const int64_t k0 = a + c0;
  const int span_starts = below[1] - c0 > 0 ? below[1] - c0 : 0;
  const int m = span_starts < window ? span_starts : window;
  const int16_t* win = staged + c0;
  // where the span's last segment ends, relative to lo (at most span + 1):
  // the next start, or n; thread 0 reads its true value while the block
  // walks the span
  const bool next_in = k0 + m < nb && a + c0 + m <= z;
  int end_last = next_in ? win[m] : (tail > span ? span + 1 : tail);
  end_last = end_last < len ? len : end_last;
  int64_t end_true = n;
  if (threadIdx.x == 0 && next_in) end_true = ldg_i64(starts + k0 + m);
  // segment q of the span: q = 0 began before it, q = j + 1 is k0 + j
  auto seg_start = [&](int q) {
    return q == 0 ? -1 : static_cast<int>(win[q - 1]);
  };
  auto seg_end = [&](int q) {
    return q < m ? static_cast<int>(win[q]) : end_last;
  };
  auto seek = [&](int p) {           // the segment of word p
    int l = 0, h = m;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (win[mid] <= p) l = mid + 1; else h = mid;
    }
    return l;
  };
  hopper::mbar_wait(&bar, 0);

  // Thread t walks the stage vectors [t V, (t+1) V) in order, V = span /
  // 1,024 (the last thread also the cover's extra vector): span words
  // [edge(t), edge(t + 1)), its run.  A segment that starts and ends in the
  // run is written by the thread, seed included; every other piece is
  // xor-ed into the slot of the first run edge after the segment's start
  // (slot 0: the segment begun before the span).
  const int per = span / kSealMinSpan;
  const int run = 4 * per;
  const int vecs = static_cast<int>(cov.bytes / 16);
  auto edge = [&](int k) {
    const int p = k * run - cov.head;
    return k >= kSealThreads ? len : (p < 0 ? 0 : (p > len ? len : p));
  };
  auto key_of = [&](int s) {         // the slot of a segment starting at s
    const int k = (s + cov.head) / run;
    return s < 0 ? 0 : (k < kSealThreads - 1 ? k : kSealThreads - 1) + 1;
  };
  const int run_lo = edge(threadIdx.x), run_hi = edge(threadIdx.x + 1);
  int q = seek(run_lo);
  int next = q < m ? win[q] : INT_MAX;
  uint32_t acc = 0;
  bool got = false;                  // a word of segment q folded
  auto whole = [&]() {
    return seg_start(q) >= run_lo && seg_end(q) <= run_hi;
  };
  auto flush = [&]() {
    if (got && whole()) {
      out[k0 + q - 1] = kMixSeed ^ acc;
    } else if (acc) {
      atomicXor(slot + key_of(seg_start(q)), acc);
    }
    acc = 0;
    got = false;
  };
  auto word = [&](uint32_t v, int p) {
    if (p < 0 || p >= len) return;   // cover words outside the span
    while (p >= next) {
      flush();
      ++q;
      next = q < m ? win[q] : INT_MAX;
    }
    acc ^= mix(v);
    got = true;
  };
  const int v_hi = threadIdx.x == kSealThreads - 1 ? vecs
                   : ((threadIdx.x + 1) * per < vecs
                      ? (threadIdx.x + 1) * per : vecs);
  for (int i = threadIdx.x * per; i < v_hi; ++i) {
    const uint4 x = stage[i];
    const int p = 4 * i - cov.head;
    if (p >= 0 && p + 3 < len && p + 3 < next) {
      acc ^= mix4(x);                // four words of one segment
      got = true;
    } else {
      word(x.x, p);
      word(x.y, p + 1);
      word(x.z, p + 2);
      word(x.w, p + 3);
    }
  }
  // last piece: a warp whose lanes all end on one slot xors it first
  const int mine = got && !whole() ? key_of(seg_start(q)) : -1;
  const int first_key = __shfl_sync(0xffffffffu, mine, 0);
  if (__all_sync(0xffffffffu, mine == first_key && mine >= 0)) {
    acc = warp_xor(acc);
    if (lane == 0 && acc) atomicXor(slot + first_key, acc);
  } else {
    flush();
  }
  __syncthreads();

  // Slot k (k >= 1) belongs to the last segment that starts in run k - 1,
  // if it runs past the run: written here when it ends in the span, its
  // piece left for the last block when it runs past the span.
  {
    const int k = threadIdx.x + 1;
    const int r_lo = edge(k - 1), r_hi = edge(k);
    int l = 0, h = m;                // window starts below r_hi
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (win[mid] < r_hi) l = mid + 1; else h = mid;
    }
    if (r_lo < r_hi && l > 0 && win[l - 1] >= r_lo && seg_end(l) > r_hi) {
      if (seg_end(l) <= len) {
        out[k0 + l - 1] = kMixSeed ^ slot[k];
      } else {
        last_seg = k0 + l - 1;
        warp_words[0] = slot[k];     // read by thread 0 after the barrier
      }
    }
  }
  if (blocks == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    SealCarry c;
    c.first = k0 > 0 ? slot[0] : 0u;
    c.seg = last_seg;
    c.last = last_seg >= 0 ? warp_words[0] : 0u;
    const int64_t e = (end_true - 1) / span;
    c.end_block = last_seg >= 0 ? (e < blocks ? e : blocks - 1) : b;
    carry[b] = c;
    __threadfence();                  // the carry before the ticket
    is_last = atomicAdd(ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last block: every carry is written.  P[i] = xor of first[0..i],
  // kSealThreads x 8 records a round, kept in the stage's shared memory
  // where it fits (else in place of first[]); then each running segment.
  // The records of the first kAhead x kSealThreads running segments are
  // read with the first round's, in one trip to L2.
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;         // ready for the next launch
  constexpr int kAhead = 4;
  int64_t seg_at[kAhead], end_at[kAhead];
  uint32_t last_at[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int64_t i = threadIdx.x + j * kSealThreads;
    seg_at[j] = i < blocks ? ldcg_i64(&carry[i].seg) : -1;
    end_at[j] = i < blocks ? ldcg_i64(&carry[i].end_block) : 0;
    last_at[j] = i < blocks ? __ldcg(&carry[i].last) : 0u;
  }
  auto* prefix = reinterpret_cast<uint32_t*>(smem);
  const bool in_smem = blocks <= span + 4;
  uint32_t before = 0;               // xor of first[] over earlier rounds
  for (int64_t base = 0; base < blocks; base += 8 * kSealThreads) {
    const int64_t i0 = base + 8 * threadIdx.x;
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = i0 + e < blocks ? __ldcg(&carry[i0 + e].first) : 0u;
      if (e) v[e] ^= v[e - 1];
    }
    uint32_t incl = v[7];            // inclusive xor scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl ^= u;
    }
    __syncthreads();                 // warp_words free (also its word 0)
    if (lane == 31) warp_words[warp] = incl;
    __syncthreads();
    uint32_t excl = before ^ incl ^ v[7];
    uint32_t round = 0;
    for (int k = 0; k < kSealThreads / 32; ++k) {
      if (k < warp) excl ^= warp_words[k];
      round ^= warp_words[k];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (i0 + e >= blocks) break;
      if (in_smem) {
        prefix[i0 + e] = excl ^ v[e];
      } else {
        carry[i0 + e].first = excl ^ v[e];
      }
    }
    before ^= round;
  }
  __syncthreads();
  auto p_at = [&](int64_t i) {
    return in_smem ? prefix[i] : __ldcg(&carry[i].first);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (seg_at[j] < 0) continue;
    out[seg_at[j]] = kMixSeed ^ last_at[j]
                     ^ p_at(threadIdx.x + j * kSealThreads) ^ p_at(end_at[j]);
  }
  for (int64_t i = threadIdx.x + kAhead * kSealThreads; i < blocks;
       i += kSealThreads) {
    const int64_t seg = ldcg_i64(&carry[i].seg);
    const int64_t e = ldcg_i64(&carry[i].end_block);
    const uint32_t piece = __ldcg(&carry[i].last);
    if (seg >= 0) out[seg] = kMixSeed ^ piece ^ p_at(i) ^ p_at(e);
  }
}

__global__ void __launch_bounds__(kSealThreads)
batch_seal_span_kernel(const uint32_t* __restrict__ w, int64_t n,
                       const int64_t* __restrict__ starts, int64_t nb,
                       int span, int window, int staged_cap,
                       SealCarry* __restrict__ carry,
                       uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  seal_span(w, n, starts, nb, span, window, staged_cap, carry, out,
            &g_seal_ticket, blockIdx.x, gridDim.x, smem);
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

// `warps` (kernels/rollup_digest.py chunk_warps): 1 folds a chunk with a
// warp, 8 with a block of kBlock threads.
int fold_chunk_digests(int device, const void* words, int64_t n,
                       int64_t chunk, int64_t warps, void* out,
                       void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (n < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const int64_t n_chunks = blocks_for(n, chunk);
  if (warps == 1) {
    const auto grid = static_cast<unsigned>(blocks_for(n_chunks, kBlock / 32));
    chunk_digests_kernel<1><<<grid, kBlock, 0, st>>>(w, n, chunk, o);
  } else if (warps == kBlock / 32) {
    chunk_digests_kernel<kBlock / 32>
        <<<static_cast<unsigned>(n_chunks), kBlock, 0, st>>>(w, n, chunk, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `warps` as fold_chunk_digests'.
int fold_dirty_chunks(int device, const void* words, int64_t n,
                      int64_t chunk, const void* ids, int64_t n_ids,
                      int64_t warps, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const uint32_t*>(words);
  const auto i = static_cast<const int64_t*>(ids);
  auto* o = static_cast<uint32_t*>(out);
  if (warps == 1) {
    const auto grid = static_cast<unsigned>(blocks_for(n_ids, kBlock / 32));
    dirty_fold_kernel<1><<<grid, kBlock, 0, st>>>(w, n, chunk, i, n_ids, o);
  } else if (warps == kBlock / 32) {
    dirty_fold_kernel<kBlock / 32><<<static_cast<unsigned>(n_ids), kBlock, 0,
                                     st>>>(w, n, chunk, i, n_ids, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `span` from kernels/batch_seal.py plan; `carry` holds ceil(n / span)
// SealCarry records of scratch (never read before written).
int fold_batch_seal(int device, const void* words, int64_t n,
                    const void* starts, int64_t nb, int64_t span, void* carry,
                    void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (n < 1 || n > INT_MAX || nb < 1 || span < kSealMinSpan
      || span > kSealMaxSpan || span % kSealMinSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int window = static_cast<int>(nb < span ? nb : span);
  const int staged = window + 2 * kSealThreads + 1;
  const int smem = seal_smem(static_cast<int>(span), staged);
  if (cudaError_t e = cudaFuncSetAttribute(
          batch_seal_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem)) {
    return static_cast<int>(e);
  }
  batch_seal_span_kernel<<<static_cast<unsigned>(blocks_for(n, span)),
                           kSealThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n,
      static_cast<const int64_t*>(starts), nb, static_cast<int>(span),
      window, staged, static_cast<SealCarry*>(carry),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
