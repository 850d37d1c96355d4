// Hopper (sm_90a) kernel of the fused window loop: B consecutive
// gas-limited FIFO blocks packed in one launch (block_pack).
//
// Replaces the Pallas _pack_kernel of src/repro/kernels/block_pack.py:179
// (pallas_call at :219).  Computes what block_pack_np computes:
//
//   hi_t[b]  = min(ub(tmax[0:N], times[b]), n_vis[b])      (time bound)
//   hi       = max(hi_t[b], ptr)
//   base     = ptr ? gcum[ptr-1] : 0
//   stop     = ub(gcum[ptr:hi], base + gas_limit) from ptr  (gas cap)
//   stops[b] = stop; ptr = stop
//
// where ub is an upper bound (the first index whose value is greater).
// float64 and int64 compares are native here, so the TPU version's
// (hi, lo) u32 pair encoding and its pow2 sentinel padding are gone.
//
// What bounds it: not bytes (16 N + 24 B of them, microseconds at HBM
// rate) but the chain of dependent loads.  Block b's gas search cannot
// start before block b-1's stop is known, so the run is about
// B x (1 + ceil(log32 N)) dependent device-memory loads long.  Two phases
// in ONE launch of ONE thread block keep that chain as short as it goes:
//
//   A (parallel): every thread takes blocks by stride and computes hi_t[b]
//     with its own binary search over tmax; it does not depend on the
//     carried pointer.  hi_t lands in shared memory when B fits, else in
//     the output buffer, which phase B overwrites in place.
//   B (sequential, one warp): walk b = 0..B-1.  Each gas search is a
//     32-way warp search: 32 lanes probe 32 evenly spaced points of the
//     live range and a ballot keeps the one sub-range holding the bound,
//     so a block takes ceil(log32(hi - ptr)) dependent steps, not
//     ceil(log2).  Every lane computes the same pointer, so nothing needs
//     broadcasting; lane 0 writes the stop.
//
// Plain C interface (loaded with ctypes by src/repro_torch/kernels/
// _build.py): device index, raw pointers, sizes, the limit, the start
// pointer and a cudaStream_t; allocates nothing; returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
// hi_t in shared memory up to this many blocks (int64: 192 KiB of the
// 227 KiB a block may take); beyond it the output buffer holds it
constexpr int64_t kSmemBlocks = 24576;

// First index in [0, n) with a[i] > v (n if none): a plain binary search,
// one thread.
__device__ __forceinline__ int64_t upper_bound_f64(const double* a,
                                                   int64_t n, double v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First index in [lo, hi) with a[i] > v (hi if none), by the whole warp.
// Invariant: every index below lo holds a value <= v and every index at
// or above hi one > v (or is past the range).  Each step, lane i probes
// q_i = lo + (i + 1) * step - 1 (clipped to hi - 1); the first lane whose
// probe exceeds v bounds the answer to (q_{i-1}, q_i].
__device__ __forceinline__ int64_t warp_upper_bound_i64(const int64_t* a,
                                                        int64_t lo,
                                                        int64_t hi,
                                                        int64_t v,
                                                        int lane) {
  while (lo < hi) {
    const int64_t len = hi - lo;
    if (len <= 32) {
      const bool gt = lane < len && a[lo + lane] > v;
      const unsigned ballot = __ballot_sync(0xffffffffu, gt);
      return ballot ? lo + (__ffs(ballot) - 1) : hi;
    }
    const int64_t step = (len + 31) / 32;
    int64_t q = lo + (static_cast<int64_t>(lane) + 1) * step - 1;
    if (q > hi - 1) q = hi - 1;
    const unsigned ballot = __ballot_sync(0xffffffffu, a[q] > v);
    if (!ballot) return hi;
    const int k = __ffs(ballot) - 1;
    const int64_t qk = __shfl_sync(0xffffffffu, q, k);
    const int64_t qprev = __shfl_sync(0xffffffffu, q, k > 0 ? k - 1 : 0);
    hi = qk;                       // a[qk] > v: the bound is at most qk
    if (k > 0) lo = qprev + 1;     // a[q_{k-1}] <= v
    if (lo == hi) return hi;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads)
block_pack_kernel(const double* __restrict__ tmax,
                  const int64_t* __restrict__ gcum, int64_t N,
                  const double* __restrict__ times,
                  const int64_t* __restrict__ n_vis, int64_t B,
                  int64_t gas_limit, int64_t ptr0,
                  int64_t* __restrict__ stops) {
  extern __shared__ int64_t smem_hi[];
  int64_t* hi_buf = B <= kSmemBlocks ? smem_hi : stops;
  // phase A: the time bound of every block, in parallel
  for (int64_t b = threadIdx.x; b < B; b += kThreads) {
    int64_t h = upper_bound_f64(tmax, N, times[b]);
    const int64_t nv = n_vis[b];
    hi_buf[b] = h < nv ? h : nv;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // phase B: the gas walk, in order, one warp
  const int lane = threadIdx.x;
  int64_t ptr = ptr0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t ht = hi_buf[b];
    const int64_t hi = ht > ptr ? ht : ptr;
    const int64_t base = ptr > 0 ? gcum[ptr - 1] : 0;
    ptr = warp_upper_bound_i64(gcum, ptr, hi, base + gas_limit, lane);
    __syncwarp();                  // every lane read hi_buf[b] first
    if (lane == 0) stops[b] = ptr;
  }
}

}  // namespace

extern "C" {

int pack_block_pack(int device, const void* tmax, const void* gcum,
                    int64_t N, const void* times, const void* n_vis,
                    int64_t B, int64_t gas_limit, int64_t ptr0, void* stops,
                    void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const size_t smem = B <= kSmemBlocks
                          ? static_cast<size_t>(B) * sizeof(int64_t) : 0;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            block_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kSmemBlocks * sizeof(int64_t)))) {
      return static_cast<int>(e);
    }
  }
  block_pack_kernel<<<1, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tmax), static_cast<const int64_t*>(gcum), N,
      static_cast<const double*>(times), static_cast<const int64_t*>(n_vis),
      B, gas_limit, ptr0, static_cast<int64_t*>(stops));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
