// Hopper (sm_90a) kernel for shard_seal: K shard lanes' segmented xor-mix
// seal digests in one launch (kernels/shard_lanes.py).
//
// Lane k of a (K, W) word grid is words[k ldw, k ldw + n_words[k]), cut
// at starts[k lds, k lds + n_seg[k]) (strictly increasing, in [0, n)):
// segment j is [starts[j], starts[j+1]) (the last ends at n; words before
// starts[0] belong to no segment) and its digest is 0x9E3779B9 xor the
// xor of mix(w) = (w ^ (w >> 16)) * 0x85EBCA6B over its words.  The
// output row k holds them in its first n_seg[k] columns and the seed in
// the others.  Bound: the bytes read, 4 a word and 8 a start, against
// 3.35 TB/s of HBM; a few integer operations a word.
//
// Design.  Lane k is one thread-block cluster of C blocks (grid (C, K),
// C a power of two up to 16 from kernels/shard_lanes.py plan_clusters:
// about a block for every two SMs).  The lane's 16-byte cover (its row may
// start off the 16-byte grid by a different amount in every row; ldw is
// arbitrary) is cut into C equal ranges of vectors; block r of the
// cluster owns range r and does, in one pass over it:
//
//   * One producer thread streams the range through a ring of kRing
//     stages of kStageVecs vectors (16 KB) by 1-D bulk copies, on a full
//     and an empty mbarrier a slot.  Before them it copies, by one more
//     bulk copy, the starts that a lane of evenly spread segments would
//     put in the range, kSlack each side (the guess).
//   * The block stages those starts in shared memory as int32 positions
//     relative to the range and counts those below each end.  Where the
//     guess does not bracket the range (a start below it, one at or past
//     its end), a search takes its place: a round of probes narrows both
//     ends to fewer than kThreads candidates and one round of loads
//     stages them.  A range with more starts than the window (kWindow) is
//     searched to its exact ends and staged a window at a time: at a
//     stage whose end the window does not reach, the walkers settle the
//     segments that ended and load the next window (a stage holds fewer
//     starts than a window).  Where the window holds the whole range,
//     each warp chunk's first segment is found once (chunk_q).
//   * kGroups groups of 256 walkers take the stages in turn (one group
//     alone while windows slide), thread t a run of kRunVecs vectors: a
//     segment that starts and ends in the run is written by the thread,
//     seed included.  A warp joins its 32 runs (its chunk) by a scan of
//     shuffles: each segment that starts and ends in the chunk is written
//     there; the chunk's first piece (of a segment begun before it) and
//     last (of one running past it) are xor-ed into the segment's word of
//     an accumulator beside the window (a shared-memory atomicXor).
//   * After the last stage, every segment that began and ended in the
//     range and was not written by a warp is written from its
//     accumulator.  Left over are the piece of the segment begun before
//     the range (`first`) and the piece of the segment still open at its
//     end, with its id and the block that holds its last word.
//
// The join stays on chip: each block stores those three (and the end
// block) into rank 0's shared memory (distributed shared memory), one
// cluster barrier, and rank 0 writes each open segment as seed ^ its
// piece ^ the `first` of every block up to the one it ends in.  No
// carry records in device memory, no fence, no ticket, nothing to zero:
// one launch a call, and calls on any streams never share state.
// kernels/shard_lanes.py shard_seal_mirror repeats the ranges, chunks and
// join on the CPU; tools/shard_split.py times the kernel stopped short.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr uint32_t kMixMult = 0x85EBCA6Bu;
constexpr uint32_t kMixSeed = 0x9E3779B9u;
constexpr int kGroup = 256;                    // walkers of a stage (8 warps)
constexpr int kGroups = 2;                     // stages walked at once ..
constexpr int kWalkers = kGroups * kGroup;     // .. by all the walkers
constexpr int kThreads = kWalkers + 32;        // and the producer warp
constexpr int kStageVecs = 1024;               // 16-byte vectors a stage
constexpr int kRunVecs = kStageVecs / kGroup;  // a walker's run a stage
constexpr int kRunWords = 4 * kRunVecs;
constexpr int kChunkWords = 32 * kRunWords;    // a warp's runs: its chunk
constexpr int kChunkVecs = kChunkWords / 4;
constexpr int kRing = 4;                       // stages in flight
constexpr int kWindow = 5120;                  // starts staged at once, more
                                               // than a stage's words
constexpr int kRaw = kWindow / 2 - 2;          // starts of one guess (int64)
constexpr int64_t kSlack = 64;                 // starts each side of a guess
constexpr int kMaxChunks = 1024;               // chunks a range with a table
constexpr int kMaxCluster = 16;

static_assert(kWindow > 4 * kStageVecs, "a window must cover a stage");
static_assert(kRing % kGroups == 0, "a ring slot serves one group");

// dynamic shared memory: the ring, the staged starts, the accumulators,
// the chunks' first segments
constexpr int kRingBytes = kRing * kStageVecs * 16;
constexpr int kSmem = kRingBytes + 4 * kWindow + 4 * (kWindow + 1)
                     + 4 * (kMaxChunks + 1);

__device__ __forceinline__ uint32_t mix(uint32_t w) {
  return (w ^ (w >> 16)) * kMixMult;
}

__device__ __forceinline__ uint32_t mix4(const uint4& q) {
  return mix(q.x) ^ mix(q.y) ^ mix(q.z) ^ mix(q.w);
}

__device__ __forceinline__ int64_t ldg_i64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// Narrows lb[i], the number of starts[0, nb) below key[i] (key[0] <=
// key[1]), to [lb[i], lb[i] + len[i]] until both len are at most `limit`:
// a round splits each range into kThreads probes, one a thread, loads the
// probes of both keys at once and counts those below each key.  No round
// where nb <= limit; one up to about kThreads (limit + 1) starts.  Every
// thread of the block takes part.
__device__ __forceinline__ void narrow(const int64_t* __restrict__ starts,
                                       const int64_t key[2], int64_t limit,
                                       int64_t lb[2], int64_t len[2]) {
  while (len[0] > limit || len[1] > limit) {
    int64_t stride[2], end[2];
    bool below[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      stride[i] = (len[i] + kThreads - 1) / kThreads;
      end[i] = lb[i] + len[i];
      const int64_t at = lb[i] + (threadIdx.x + 1) * stride[i] - 1;
      below[i] = len[i] > limit && at < end[i]
                 && ldg_i64(starts + at) < key[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (len[i] <= limit) continue;   // uniform: every thread skips
      lb[i] += __syncthreads_count(below[i]) * stride[i];
      len[i] = stride[i] - 1 < end[i] - lb[i] ? stride[i] - 1
                                             : end[i] - lb[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
shard_seal_cluster_kernel(const uint32_t* __restrict__ w, int64_t ldw,
                          const int64_t* __restrict__ starts, int64_t lds,
                          const int64_t* __restrict__ n_seg,
                          const int64_t* __restrict__ n_words, int64_t B,
                          uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kRing], empty[kRing], guessed;
  // rank 0's: what each block of the cluster leaves for the join
  __shared__ uint32_t join_first[kMaxCluster], join_last[kMaxCluster];
  __shared__ int32_t join_seg[kMaxCluster], join_end[kMaxCluster];
  __shared__ int below[2];
  __shared__ uint32_t first_piece, open_piece;
  __shared__ int64_t open_seg, next_start;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = static_cast<int>(gridDim.x);
  const int r = static_cast<int>(blockIdx.x);   // the rank in the cluster
  const int64_t k = blockIdx.y;
  const int64_t n = n_words[k], nb = n_seg[k];
  uint32_t* row = out + k * B;
  for (int64_t j = nb + static_cast<int64_t>(r) * kThreads + tid; j < B;
       j += static_cast<int64_t>(C) * kThreads) {
    row[j] = kMixSeed;                 // the lane's padded columns
  }
  if (nb < 1) return;                  // the whole cluster: no join
  hopper::cluster_arrive_release();    // this block has started

  // The range: vectors [v_lo, v_hi) of the lane's cover, words [r_lo,
  // r_hi) of the lane; word p of the range (p = lane word - r_lo) lies in
  // the range's vector (p + head) / 4.
  const uint32_t* lw = w + k * ldw;
  const int64_t* ls = starts + k * lds;
  const int h0 = static_cast<int>((reinterpret_cast<uintptr_t>(lw) & 15u)
                                  >> 2);
  const int64_t V = (h0 + n + 3) / 4;
  const int64_t RV = (V + C - 1) / C;
  const int64_t v_lo = r * RV < V ? r * RV : V;
  const int64_t v_hi = v_lo + RV < V ? v_lo + RV : V;
  const int64_t r_lo = v_lo == 0 ? 0 : (4 * v_lo - h0 < n ? 4 * v_lo - h0
                                                          : n);
  const int64_t r_hi = 4 * v_hi - h0 < n ? 4 * v_hi - h0 : n;
  const int len = static_cast<int>(r_hi - r_lo);
  const int head = v_lo == 0 ? h0 : 0;
  const int vc = static_cast<int>(v_hi - v_lo);
  const int stages = (vc + kStageVecs - 1) / kStageVecs;
  const uint4* src = reinterpret_cast<const uint4*>(lw - h0) + v_lo;
  auto* ring = reinterpret_cast<uint4*>(smem);
  auto* staged = reinterpret_cast<int32_t*>(smem + kRingBytes);
  auto* acc = reinterpret_cast<uint32_t*>(staged + kWindow);
  auto* chunk_q = reinterpret_cast<int32_t*>(acc + kWindow + 1);
  // The guess: starts spread evenly over the lane put the range's in
  // [g_lo, g_hi]; one bulk copy stages that bracket (int64, in the
  // accumulators' room) ahead of the words.
  const int64_t g_lo = nb * r_lo / n - kSlack > 0 ? nb * r_lo / n - kSlack
                                                  : 0;
  const int64_t g_up = (nb * r_hi + n - 1) / n + kSlack;
  const int64_t g_hi = g_up < nb - 1 ? g_up : nb - 1;
  const bool guess = g_hi - g_lo < kRaw;
  const hopper::Cover sc = hopper::cover(ls + g_lo, guess ? g_hi - g_lo + 1
                                                          : 0);
  const int64_t* raw = reinterpret_cast<const int64_t*>(acc) + sc.head;
  const bool producer = warp == kWalkers / 32;
  auto issue = [&](int s) {            // stage s into its ring slot
    const int b = s % kRing;
    const int left = vc - s * kStageVecs;
    const uint32_t bytes = 16u * (left < kStageVecs ? left : kStageVecs);
    hopper::mbar_expect_tx(&full[b], bytes);
    hopper::bulk_load(ring + b * kStageVecs, src + s * kStageVecs, bytes,
                      &full[b]);
  };
  if (producer && lane == 0) {
    for (int b = 0; b < kRing; ++b) {
      hopper::mbar_init(&full[b], 1);
      hopper::mbar_init(&empty[b], kGroup / 32);
    }
    hopper::mbar_init(&guessed, 1);
    hopper::fence_barrier_init();
    if (guess) {
      hopper::mbar_expect_tx(&guessed, sc.bytes);
      hopper::bulk_load(acc, sc.start, sc.bytes, &guessed);
    }
    for (int s = 0; s < kRing && s < stages; ++s) issue(s);
  }
  if (tid == 0) {
    below[0] = below[1] = 0;
    first_piece = open_piece = 0u;
    open_seg = -1;
    next_start = LLONG_MAX;
  }
  __syncthreads();

  // While the words fly: the starts of the range, once.  staged[j] is
  // start a + j relative to r_lo (clamped to [-1, len + 1]); below[] counts
  // those below r_lo and r_hi, next_start is the least at or past r_hi.
  auto stage_starts = [&](int64_t a, int64_t z, auto load) {
    int n_lo = 0, n_hi = 0;
    int64_t past = LLONG_MAX;
    for (int64_t j = tid; a + j <= z; j += kThreads) {
      const int64_t at = load(j);
      const int64_t v = at - r_lo;
      const int rel = v < 0 ? -1 : (v > len ? len + 1 : static_cast<int>(v));
      staged[j] = rel;
      n_lo += rel < 0;
      n_hi += rel < len;
      if (at >= r_hi && at < past) past = at;
    }
    n_lo = __reduce_add_sync(0xffffffffu, n_lo);
    n_hi = __reduce_add_sync(0xffffffffu, n_hi);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t u = __shfl_xor_sync(0xffffffffu, past, o);
      past = u < past ? u : past;
    }
    if (lane == 0 && (n_lo || n_hi)) {
      atomicAdd(&below[0], n_lo);
      atomicAdd(&below[1], n_hi);
    }
    if (lane == 0 && past != LLONG_MAX) {
      atomicMin(reinterpret_cast<unsigned long long*>(&next_start),
                static_cast<unsigned long long>(past));
    }
  };
  int64_t a = g_lo, z = g_hi;
  int64_t lb[2] = {0, 0}, open[2] = {nb, nb};
  bool exact = false, found = false;
  if (guess) {
    hopper::mbar_wait(&guessed, 0);
    stage_starts(a, z, [&](int64_t j) { return raw[j]; });
    // the bracket holds the range's starts where a start below r_lo
    // precedes it and one at or past r_hi ends it (or the lane does)
    found = (g_lo == 0 || raw[0] < r_lo)
            && (g_hi == nb - 1 || raw[g_hi - g_lo] >= r_hi);
    __syncthreads();
  }
  if (!found) {
    // Else a search: a round of probes narrows both ends to fewer than
    // kThreads candidates, one round of loads stages them; a range with
    // more starts than the window is searched to its exact ends and its
    // starts staged a window at a time.
    if (tid == 0) {
      below[0] = below[1] = 0;
      next_start = LLONG_MAX;
    }
    __syncthreads();
    const int64_t key[2] = {r_lo, r_hi};
    narrow(ls, key, kThreads - 1, lb, open);
    exact = lb[1] + open[1] - lb[0] >= kWindow;
    if (exact) narrow(ls, key, 0, lb, open);
    a = lb[0];
    z = lb[1] + open[1] < nb ? lb[1] + open[1] : nb - 1;
    z = z - a < kWindow ? z : a + kWindow - 1;
    stage_starts(a, z, [&](int64_t j) { return ldg_i64(ls + a + j); });
    __syncthreads();
  }
  const int64_t k_lo = exact ? lb[0] : a + below[0];
  const int64_t k_hi = exact ? lb[1] : a + below[1];
  // the lane's first start at or past r_hi, or n: where the range's last
  // segment ends (staged with the range's starts unless `exact`)
  const int64_t end_abs = k_hi == nb ? n
                          : (exact ? ldg_i64(ls + k_hi) : next_start);

  if (producer) {
    if (lane == 0) {
      for (int s = kRing; s < stages; ++s) {
        hopper::mbar_wait(&empty[s % kRing],
                          static_cast<uint32_t>((s / kRing - 1) & 1));
        issue(s);
      }
    }
    __syncwarp();
  } else {
    // The window: starts[base, base + count) at win[0, count), positions
    // relative to r_lo; acc[q] the pieces of window segment q (q = 0 the
    // segment begun before the window, q >= 1 the one starting at
    // win[q - 1]), lane segment base + q - 1.
    int64_t base = k_lo;
    const int32_t* win = staged + (k_lo - a);
    int count = static_cast<int>(k_hi - k_lo < kWindow - (k_lo - a)
                                 ? k_hi - k_lo : kWindow - (k_lo - a));
    bool reaches = base + count == k_hi;
    const int end_last = end_abs - r_lo > len ? len + 1
                                              : static_cast<int>(end_abs - r_lo);
    int start0 = -1;                   // where segment 0 starts, once a
                                       // slide leaves one begun in the range
    auto seg_start = [&](int q) { return q == 0 ? start0 : win[q - 1]; };
    auto seg_end = [&](int q) {
      return q < count ? win[q] : (reaches ? end_last : INT_MAX);
    };
    // a segment [s, e) that starts and ends in one warp's chunk (written
    // by the warp)
    auto whole = [&](int s, int e) {
      return s >= 0 && e <= len
             && (static_cast<uint32_t>(s) + head) / kChunkWords
                    == (static_cast<uint32_t>(e) - 1u + head) / kChunkWords;
    };
    auto below_in = [&](int p) {       // window starts below p
      int l = 0, h = count;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (win[mid] < p) l = mid + 1; else h = mid;
      }
      return l;
    };
    // Where the window holds every start of the range, each chunk's first
    // segment (chunk_q[c], window starts below the chunk) is found once,
    // and a run's by a search of its chunk's starts only.
    const int n_chunks = (vc + kChunkVecs - 1) / kChunkVecs;
    const bool table = reaches && n_chunks < kMaxChunks;
    // Stage s is walked by group s % kGroups of kGroup walkers, or by
    // group 0 alone where windows slide (one at a time, in order).
    const int gt = tid % kGroup, gwarp = gt >> 5, group = tid / kGroup;
    const int groups = reaches ? kGroups : 1;
    for (int j = tid; j <= count; j += kWalkers) acc[j] = 0u;
    if (table) {
      for (int c = tid; c <= n_chunks; c += kWalkers) {
        const int lo = c * kChunkWords - head;
        chunk_q[c] = below_in(lo > 0 ? lo : 0);
      }
    }
    hopper::bar_sync(1, kWalkers);
    // window segment q once all of its words in the range are in acc[q]:
    // the begun-before piece kept for the join, a segment ending in the
    // range written (unless a walker did), the open one kept for the join
    auto settle = [&](int q) {
      const uint32_t piece = acc[q];
      if (q == 0 && base == k_lo) {
        if (k_lo > 0) first_piece = piece;
        return;
      }
      const int e = seg_end(q);
      if (whole(seg_start(q), e)) return;
      if (e <= len) {
        row[base + q - 1] = kMixSeed ^ piece;
      } else {
        open_seg = base + q - 1;
        open_piece = piece;
      }
    };
    for (int s = group; s < stages && group < groups; s += groups) {
      const int b = s % kRing;
      const int v0 = s * kStageVecs + gt * kRunVecs;
      const int v1 = v0 + kRunVecs < vc ? v0 + kRunVecs : vc;
      if (!reaches) {                  // uniform over the walkers
        const int s_hi = 4 * ((s + 1) * kStageVecs < vc ? (s + 1) * kStageVecs
                                                        : vc) - head;
        if (below_in(s_hi < len ? s_hi : len) == count) {
          // the window ends in this stage: settle what ended before it,
          // carry the segment open at its first word, load the next one
          const int s_lo = 4 * s * kStageVecs - head;
          const int js = below_in(s_lo > 0 ? s_lo : 0);
          hopper::bar_sync(2, kGroup);     // the earlier stages' pieces
          for (int q = gt; q < js; q += kGroup) settle(q);
          const uint32_t carry = acc[js];
          const int carry_start = seg_start(js);
          hopper::bar_sync(2, kGroup);
          start0 = carry_start;
          base += js;
          const int64_t left = k_hi - base;
          count = static_cast<int>(left < kWindow ? left : kWindow);
          for (int j = gt; j < count; j += kGroup) {
            staged[j] = static_cast<int32_t>(ldg_i64(ls + base + j) - r_lo);
          }
          for (int j = gt; j <= count; j += kGroup) {
            acc[j] = j ? 0u : carry;
          }
          win = staged;
          reaches = base + count == k_hi;
          hopper::bar_sync(2, kGroup);
        }
      }
      // The run: a segment that starts and ends in it is written here.
      // run_x is the xor of the run's words so far, mark its value at the
      // last start; h ends as the piece of the segment begun before the run
      // (q_first), x as the piece after its last start (the whole run
      // where none).
      const int run_lo = 4 * v0 - head > 0 ? 4 * v0 - head : 0;
      int q = count;                   // a chunk past the range's words
      const int c = s * (kStageVecs / kChunkVecs) + gwarp;
      if (table && c < n_chunks) {
        int l = chunk_q[c], h = chunk_q[c + 1];
        while (l < h) {
          const int mid = (l + h) >> 1;
          if (win[mid] < run_lo) l = mid + 1; else h = mid;
        }
        q = l;
      } else if (!table) {
        q = below_in(run_lo);
      }
      const int q_first = q;
      int next = q < count ? win[q] : INT_MAX;
      uint32_t run_x = 0, mark = 0, h = 0;
      bool crossed = false;            // a start lies in the run
      hopper::mbar_wait(&full[b], static_cast<uint32_t>((s / kRing) & 1));
      const uint4* stage = ring + b * kStageVecs;
      for (int i = v0; i < v1; ++i) {
        const uint4 v = stage[i - s * kStageVecs];
        const int p = 4 * i - head;
        if (p >= 0 && p + 3 < len && p + 3 < next) {
          run_x ^= mix4(v);            // four words of one segment
          continue;
        }
        // the vector's mixed words (0 outside the range), then each start
        // that falls in it, in order
        const uint32_t four[4] = {v.x, v.y, v.z, v.w};
        uint32_t m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = p + j >= 0 && p + j < len ? mix(four[j]) : 0u;
        }
        int from = 0;
        while (next < p + 4) {         // segment q ends, q + 1 starts
          const int at = next - p;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= from && j < at) run_x ^= m[j];
          }
          if (crossed) {
            row[base + q - 1] = kMixSeed ^ run_x ^ mark;
          } else {
            h = run_x;
            crossed = true;
          }
          mark = run_x;
          ++q;
          next = q < count ? win[q] : INT_MAX;
          from = at;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= from) run_x ^= m[j];
        }
      }
      const uint32_t x = run_x ^ mark;
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[b]);
      // The chunk: an inclusive xor scan of x over the lanes joins each
      // segment that crosses runs.  Lane l with a start writes the segment
      // it ends (h ^ the x of the lanes since the last start before it)
      // where that began in the chunk; the chunk's first and last pieces
      // go to the accumulator unless the last segment ends in the chunk.
      const uint32_t with_start = __ballot_sync(0xffffffffu, crossed);
      if (!with_start) {               // one segment over the whole chunk
        const uint32_t total = __reduce_xor_sync(0xffffffffu, x);
        if (lane == 0 && total) atomicXor(acc + q, total);
        continue;
      }
      uint32_t incl = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl ^= u;
      }
      const uint32_t excl = incl ^ x;
      const uint32_t earlier = with_start & ((1u << lane) - 1u);
      const uint32_t excl_l0 = __shfl_sync(
          0xffffffffu, excl, earlier ? 31 - __clz(earlier) : 0);
      const uint32_t total = __shfl_sync(0xffffffffu, incl, 31);
      if (crossed) {
        const uint32_t piece = h ^ excl ^ (earlier ? excl_l0 : 0u);
        if (earlier) {
          row[base + q_first - 1] = kMixSeed ^ piece;
        } else if (piece) {
          atomicXor(acc + q_first, piece);
        }
      }
      const int last = with_start ? 31 - __clz(with_start) : 0;
      if (lane == last) {
        const uint32_t piece = total ^ (with_start ? excl : 0u);
        if (with_start && whole(seg_start(q), seg_end(q))) {
          row[base + q - 1] = kMixSeed ^ piece;
        } else if (piece) {
          atomicXor(acc + q, piece);
        }
      }
    }
    hopper::bar_sync(1, kWalkers);       // every piece is in acc
    // by the walkers that followed the window (group 0 alone if it slid)
    if (group < groups) {
      for (int q = tid; q <= count; q += groups * kGroup) settle(q);
    }
  }
  __syncthreads();

  // The join in rank 0's shared memory.
  hopper::cluster_wait_acquire();      // every block has started
  if (tid == 0) {
    auto at = [&](const void* p) {
      return hopper::map_rank(hopper::smem_u32(p), 0);
    };
    int32_t end_block = -1;
    if (open_seg >= 0) {
      end_block = static_cast<int32_t>(((end_abs - 1 + h0) / 4) / RV);
    }
    hopper::st_cluster_u32(at(&join_first[r]), first_piece);
    hopper::st_cluster_u32(at(&join_last[r]), open_piece);
    hopper::st_cluster_u32(at(&join_seg[r]),
                           static_cast<uint32_t>(open_seg));
    hopper::st_cluster_u32(at(&join_end[r]),
                           static_cast<uint32_t>(end_block));
  }
  hopper::cluster_arrive_release();
  hopper::cluster_wait_acquire();
  if (r == 0 && tid < C && join_seg[tid] >= 0) {
    uint32_t x = join_last[tid];
    for (int q = tid + 1; q <= join_end[tid] && q < C; ++q) {
      x ^= join_first[q];
    }
    row[join_seg[tid]] = kMixSeed ^ x;
  }
}

// fills `config` (and `attr`) for a launch over `lanes` clusters of
// `clusters` blocks, setting the kernel's attributes first if `set`
cudaError_t shard_config(cudaLaunchConfig_t* config,
                         cudaLaunchAttribute* attr, int64_t lanes,
                         int64_t clusters, cudaStream_t st, bool set) {
  if (set) {
    if (cudaError_t e = cudaFuncSetAttribute(
            shard_seal_cluster_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) {
      return e;
    }
    if (cudaError_t e = cudaFuncSetAttribute(
            shard_seal_cluster_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) {
      return e;
    }
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(clusters);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(clusters),
                         static_cast<unsigned>(lanes));
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = kSmem;
  config->stream = st;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

bool valid_clusters(int64_t c) {
  return c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0;
}

// 1 + the clusters of each size that fit, by device, once the kernel's
// attributes are set there (0: not yet), so that a launch pays for the
// query once
constexpr int kMaxDevices = 64;
int g_fit[kMaxDevices][kMaxCluster + 1];

}  // namespace

extern "C" {

// shard_seal over K lanes of a (K, W) int32 word grid (row stride ldw
// words, unit column stride) and a (K, B) int64 start grid (row stride
// lds, unit column stride), n_seg and n_words (K,) int64 on the device;
// `clusters` blocks a lane (kernels/shard_lanes.py plan_clusters); out
// (K, B) contiguous.  Refused, not run another way, where no cluster of
// that size fits the card.
int fold_shard_seal(int device, const void* words, int64_t ldw,
                    const void* starts, int64_t lds, const void* n_seg,
                    const void* n_words, int64_t lanes, int64_t B, int64_t W,
                    int64_t clusters, void* out, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (lanes < 1 || lanes > 65535 || B < 1 || W < 0 || W > INT_MAX - 64
      || !valid_clusters(clusters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const bool known = device >= 0 && device < kMaxDevices
                     && g_fit[device][clusters] > 0;
  if (cudaError_t e = shard_config(&config, &attr, lanes, clusters,
                                   static_cast<cudaStream_t>(stream),
                                   !known)) {
    return static_cast<int>(e);
  }
  int fit = known ? g_fit[device][clusters] - 1 : 0;
  if (!known) {
    if (cudaError_t e = cudaOccupancyMaxActiveClusters(
            &fit, shard_seal_cluster_kernel, &config)) {
      return static_cast<int>(e);
    }
    if (device >= 0 && device < kMaxDevices) {
      g_fit[device][clusters] = fit + 1;
    }
  }
  if (fit < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  if (cudaError_t e = cudaLaunchKernelEx(
          &config, shard_seal_cluster_kernel,
          static_cast<const uint32_t*>(words), ldw,
          static_cast<const int64_t*>(starts), lds,
          static_cast<const int64_t*>(n_seg),
          static_cast<const int64_t*>(n_words), B,
          static_cast<uint32_t*>(out))) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// how many clusters of `clusters` blocks the card holds at once (int out)
int fold_shard_seal_capacity(int device, int64_t clusters, void* out,
                             void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (!valid_clusters(clusters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (cudaError_t e = shard_config(&config, &attr, 1, clusters,
                                   static_cast<cudaStream_t>(stream),
                                   true)) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      static_cast<int*>(out), shard_seal_cluster_kernel, &config));
}

}  // extern "C"
