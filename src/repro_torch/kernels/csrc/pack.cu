// Hopper (sm_90a) kernels of the fused window loop: B consecutive
// gas-limited FIFO blocks packed in one call (block_pack).
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
// rate) but the chain the carried pointer makes: block b's stop cannot be
// known before block b-1's.  The gas search, though, depends on the
// pointer alone, not on the block, so it comes out of the chain as a
// table over every pointer value i in [0, N]:
//
//   g[i] = ub(gcum, (i > 0 ? gcum[i-1] : 0) + gas_limit)
//
// (every entry before i is at most the base, so g[i] >= i), and then
//
//   stops[b] = ptr = min(max(g[ptr], ptr), max(hi_t[b], ptr)),
//
// the expression block_pack_torch evaluates.  Two kernels on the caller's
// stream:
//
//   pack_table_kernel (a grid, one thread an entry): g[i] for i in
//     [0, N] by a binary search over gcum[i:N], and hi_t[b] for every
//     block by one over tmax; no entry depends on another.  hi_t lands in
//     the stops buffer, which the walk overwrites in place.  The table is
//     int32 where N < 2^31 - 1, else int64 (the wrapper allocates it).
//   pack_walk_kernel (one block): stages the table into shared memory
//     where it fits (int32, N + 1 up to about 56,000 entries), and hi_t a
//     chunk at a time; one thread walks the blocks in order, each block
//     one dependent shared-memory load (one L2 load where the table stays
//     in device memory) and two min / max, and stores each stop.
//
// Plain C interface (loaded with ctypes by src/repro_torch/kernels/
// _build.py): device index, raw pointers, sizes, the limit, the start
// pointer, the table's width and a cudaStream_t; allocates nothing;
// returns the first CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableThreads = 256;
constexpr int kWalkThreads = 1024;
constexpr int64_t kWalkChunk = 2048;   // blocks whose hi_t a pass stages
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

// First index in [lo, n) with a[i] > v (n if none), every index below lo
// known to hold a value <= v: a plain binary search, one thread.
template <typename T>
__device__ __forceinline__ int64_t upper_bound(const T* a, int64_t lo,
                                               int64_t n, T v) {
  int64_t hi = n;
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

// entries [0, N] of the jump table, then the B time bounds
template <typename I>
__global__ void __launch_bounds__(kTableThreads)
pack_table_kernel(const double* __restrict__ tmax,
                  const int64_t* __restrict__ gcum, int64_t N,
                  const double* __restrict__ times,
                  const int64_t* __restrict__ n_vis, int64_t B,
                  int64_t gas_limit, I* __restrict__ table,
                  int64_t* __restrict__ hi_t) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTableThreads
                    + threadIdx.x;
  if (i <= N) {
    const int64_t v = (i > 0 ? gcum[i - 1] : 0) + gas_limit;
    table[i] = static_cast<I>(upper_bound(gcum, i, N, v));
  } else if (i - N - 1 < B) {
    const int64_t b = i - N - 1;
    const int64_t h = upper_bound(tmax, int64_t{0}, N, times[b]);
    const int64_t nv = n_vis[b];
    hi_t[b] = h < nv ? h : nv;
  }
}

template <typename I>
__global__ void __launch_bounds__(kWalkThreads, 1)
pack_walk_kernel(const I* __restrict__ table, int64_t N, int64_t B,
                 int64_t ptr0, int staged, int64_t* __restrict__ stops) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  I* chunk = reinterpret_cast<I*>(smem_raw);   // hi_t of kWalkChunk blocks
  I* tab = chunk + kWalkChunk;                 // the table, when staged
  if (staged) {
    for (int64_t i = threadIdx.x; i <= N; i += kWalkThreads) tab[i] = table[i];
  }
  const I* g = staged ? tab : table;
  I ptr = static_cast<I>(ptr0);
  for (int64_t b0 = 0; b0 < B; b0 += kWalkChunk) {
    const int nb = static_cast<int>(B - b0 < kWalkChunk ? B - b0
                                                        : kWalkChunk);
    __syncthreads();               // the table staged; the last chunk walked
    for (int i = threadIdx.x; i < nb; i += kWalkThreads) {
      chunk[i] = static_cast<I>(stops[b0 + i]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // shared memory is only read here, so the hi_t loads run ahead; the
      // chain is the load of g[ptr] and the min / max after it
#pragma unroll 4
      for (int b = 0; b < nb; ++b) {
        const I ht = chunk[b];
        const I hi = ht > ptr ? ht : ptr;
        const I j = g[ptr];
        const I up = j > ptr ? j : ptr;
        ptr = up < hi ? up : hi;
        stops[b0 + b] = static_cast<int64_t>(ptr);
      }
    }
  }
}

template <typename I>
int launch(const void* tmax, const void* gcum, int64_t N, const void* times,
           const void* n_vis, int64_t B, int64_t gas_limit, int64_t ptr0,
           void* table, void* stops, cudaStream_t st) {
  const int64_t items = N + 1 + B;
  const int64_t blocks = (items + kTableThreads - 1) / kTableThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  I* tab = static_cast<I*>(table);
  int64_t* out = static_cast<int64_t*>(stops);
  pack_table_kernel<I><<<static_cast<unsigned>(blocks), kTableThreads, 0,
                         st>>>(
      static_cast<const double*>(tmax), static_cast<const int64_t*>(gcum), N,
      static_cast<const double*>(times), static_cast<const int64_t*>(n_vis),
      B, gas_limit, tab, out);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const size_t base = kWalkChunk * sizeof(I);
  const size_t full = base + static_cast<size_t>(N + 1) * sizeof(I);
  const int staged = full <= kSmemLimit ? 1 : 0;
  const size_t smem = staged ? full : base;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            pack_walk_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem))) {
      return static_cast<int>(e);
    }
  }
  pack_walk_kernel<I><<<1, kWalkThreads, smem, st>>>(tab, N, B, ptr0, staged,
                                                     out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: N + 1 entries of int32 (wide = 0; needs N < 2^31 - 1) or int64
// (wide = 1), scratch the wrapper allocates.
int pack_block_pack(int device, const void* tmax, const void* gcum,
                    int64_t N, const void* times, const void* n_vis,
                    int64_t B, int64_t gas_limit, int64_t ptr0, int wide,
                    void* table, void* stops, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  if (N < 0 || B < 1 || ptr0 < 0 || ptr0 > N || gas_limit < 0
      || (!wide && N >= 0x7fffffff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (wide) {
    return launch<int64_t>(tmax, gcum, N, times, n_vis, B, gas_limit, ptr0,
                           table, stops, st);
  }
  return launch<int32_t>(tmax, gcum, N, times, n_vis, B, gas_limit, ptr0,
                         table, stops, st);
}

}  // extern "C"
