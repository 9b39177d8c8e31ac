// K12 partition_split: the stable permutation that groups a batch's rows by
// partition id, padding last, and the row count of each partition.
//
// Replaces spark_rapids_tpu/shuffle/partitioning.py:_fused_split_fn 41
// (B14): argsort(where(live, pids, n), stable=True) and its bincount. For
// rows i < cap with bin(i) = clamp(pids[i], 0, n) when i < *n_rows, else n:
//   perm[cap]   rows ordered by bin, row order kept within a bin, so
//               partition p occupies [offset(p), offset(p) + counts[p]) and
//               the padding rows come last;
//   counts[n]   rows per partition (int32), left on the device.
//
// Bound on the card: bytes (4 bytes of id a row read, 8 bytes of
// permutation written). Design: a stable counting sort in three launches:
//   1. per-block histograms of a 4096-row tile (integer atomics: counts
//      commute), stored bin-major, block-minor;
//   2. one exclusive scan of that histogram (scan_common.cuh's totals scan),
//      which makes each entry the first output slot of its (bin, block);
//   3. a stable scatter: the block walks its tile in row order, 256 rows a
//      round and one warp at a time; a row's rank among the earlier rows of
//      its bin in the warp comes from __match_any_sync and a __popc of the
//      lower lanes, and the block's running per-bin slots carry the earlier
//      warps and rounds.
// Up to kSharedParts bins the histogram and the running slots of a block
// live in shared memory. Above that (the reference has no limit) they live
// in device memory: the histogram is zeroed first and counted with global
// atomics into the block's own column of the scratch, its (n + 1) x blocks
// entries are scanned by a grid scan (per-chunk totals, one totals scan,
// per-chunk scans) instead of one block, and the scatter advances the
// block's own column of the scanned offsets in place (no two blocks touch
// one entry; __syncthreads orders the warps of a block).
// Every slot is written once, so the permutation is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

#define ROUNDS 16
#define TILE (ROUNDS * scan::kThreads)

namespace {

constexpr int kSharedParts = 4096;

__device__ __forceinline__ int bin_of(const int* pids, const int* n_rows,
                                      int n, long long i) {
  if (i >= (long long)*n_rows) return n;
  const int p = pids[i];
  return p < 0 ? 0 : (p > n ? n : p);
}

// kShared: the block's counters in shared memory (n <= kSharedParts);
// otherwise hist must be zeroed and is counted in place.
template <bool kShared>
__global__ void histogram_kernel(const int* pids, const int* n_rows,
                                 long long cap, int n, int n_blocks,
                                 int* hist) {
  __shared__ int h[kShared ? kSharedParts + 1 : 1];
  if (kShared) {
    for (int b = threadIdx.x; b <= n; b += blockDim.x) h[b] = 0;
    __syncthreads();
  }
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + (long long)r * scan::kThreads + threadIdx.x;
    if (i >= cap) continue;
    const int bin = bin_of(pids, n_rows, n, i);
    if (kShared)
      atomicAdd(&h[bin], 1);
    else
      atomicAdd(&hist[(long long)bin * n_blocks + blockIdx.x], 1);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b <= n; b += blockDim.x)
      hist[(long long)b * n_blocks + blockIdx.x] = h[b];
  }
}

template <bool kShared>
__global__ void scatter_kernel(const int* pids, const int* n_rows,
                               long long cap, int n, int n_blocks,
                               int* offsets, long long* perm, int* counts) {
  __shared__ int sh_slot[kShared ? kSharedParts + 1 : 1];
  // the block's running slot of a bin
  int* slot = kShared ? sh_slot : offsets + blockIdx.x;
  const long long stride = kShared ? 1 : n_blocks;
  if (kShared)
    for (int b = threadIdx.x; b <= n; b += blockDim.x)
      sh_slot[b] = offsets[(long long)b * n_blocks + blockIdx.x];
  // block 0 reads column 0 before it advances it in the scatter below
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      counts[p] = offsets[(long long)(p + 1) * n_blocks] -
                  offsets[(long long)p * n_blocks];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned lower = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + (long long)r * scan::kThreads + threadIdx.x;
    const int bin = i < cap ? bin_of(pids, n_rows, n, i) : -1;
    for (int w = 0; w < scan::kThreads / 32; ++w) {
      if (warp == w) {
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0)
          perm[slot[bin * stride] + __popc(peers & lower)] = i;
        __syncwarp();
        if (bin >= 0 && lane == __ffs(peers) - 1)
          slot[bin * stride] += __popc(peers);
      }
      __syncthreads();
    }
  }
}

// The grid scan of the device-memory path: chunks of kChunk entries, each
// thread kItems consecutive ones.
constexpr int kItems = 16;
constexpr int kChunk = kItems * scan::kThreads;

__global__ void chunk_totals_kernel(const int* x, long long m, int* totals) {
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x * kItems;
  int sum = 0;
  for (int k = 0; k < kItems; ++k)
    if (base + k < m) sum += x[base + k];
  sum = scan::block_sum<int>(sum);
  if (threadIdx.x == 0) totals[blockIdx.x] = sum;
}

// Exclusive scan of x[0 .. m) in place; offsets: each chunk's exclusive
// start (the scanned totals).
__global__ void chunk_scan_kernel(int* x, long long m, const int* offsets) {
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x * kItems;
  int v[kItems];
  int sum = 0;
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < m ? x[base + k] : 0;
    sum += v[k];
  }
  int run = scan::block_inclusive_scan<int>(sum, nullptr) - sum +
            offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    if (base + k < m) x[base + k] = run;
    run += v[k];
  }
}

}  // namespace

extern "C" {

// Bytes of scratch partition_split needs for cap rows and n partitions.
long long partition_split_scratch_bytes(long long cap, int n) {
  const long long blocks = (cap + TILE - 1) / TILE;
  const long long entries = (long long)(n + 1) * blocks;
  // the histogram, its total, and the grid scan's chunk totals
  return (entries + 1 + (entries + kChunk - 1) / kChunk) *
         (long long)sizeof(int);
}

// pids: int32[cap]; n_rows: int32[1] on the device; perm: int64[cap];
// counts: int32[n]. Returns 0 or the CUDA error of a launch.
int partition_split(const void* pids, const void* n_rows, long long cap,
                    int n, void* perm, void* counts, void* scratch,
                    void* stream) {
  const long long blocks = (cap + TILE - 1) / TILE;
  if (cap < 1 || n < 1 || (long long)(n + 1) * blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* hist = (int*)scratch;
  const int nb = (int)blocks;
  const int entries = (n + 1) * nb;
  const bool shared = n <= kSharedParts;
  cudaError_t e;
  if (shared) {
    histogram_kernel<true><<<nb, scan::kThreads, 0, s>>>(
        (const int*)pids, (const int*)n_rows, cap, n, nb, hist);
  } else {
    e = cudaMemsetAsync(hist, 0, (size_t)entries * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    histogram_kernel<false><<<nb, scan::kThreads, 0, s>>>(
        (const int*)pids, (const int*)n_rows, cap, n, nb, hist);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (shared) {
    scan::scan_totals_kernel<int><<<1, scan::kTotalsThreads, 0, s>>>(
        hist, entries, hist + entries);
  } else {
    const int chunks = (entries + kChunk - 1) / kChunk;
    int* totals = hist + entries + 1;
    chunk_totals_kernel<<<chunks, scan::kThreads, 0, s>>>(hist, entries,
                                                          totals);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    scan::scan_totals_kernel<int><<<1, scan::kTotalsThreads, 0, s>>>(
        totals, chunks, hist + entries);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    chunk_scan_kernel<<<chunks, scan::kThreads, 0, s>>>(hist, entries,
                                                        totals);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (shared)
    scatter_kernel<true><<<nb, scan::kThreads, 0, s>>>(
        (const int*)pids, (const int*)n_rows, cap, n, nb, hist,
        (long long*)perm, (int*)counts);
  else
    scatter_kernel<false><<<nb, scan::kThreads, 0, s>>>(
        (const int*)pids, (const int*)n_rows, cap, n, nb, hist,
        (long long*)perm, (int*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
