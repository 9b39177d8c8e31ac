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
// permutation written). Design: a stable counting sort in three launches,
// n <= 4096 bins held in shared memory:
//   1. per-block histograms of a 4096-row tile (shared integer atomics:
//      counts commute), stored bin-major, block-minor;
//   2. one exclusive scan of that histogram (scan_common.cuh's totals scan),
//      which makes each entry the first output slot of its (bin, block);
//   3. a stable scatter: the block walks its tile in row order, 256 rows a
//      round and one warp at a time; a row's rank among the earlier rows of
//      its bin in the warp comes from __match_any_sync and a __popc of the
//      lower lanes, and the block's running per-bin slots in shared memory
//      carry the earlier warps and rounds.
// Every slot is written once, so the permutation is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

#define MAX_PARTS 4096
#define ROUNDS 16
#define TILE (ROUNDS * scan::kThreads)

namespace {

__device__ __forceinline__ int bin_of(const int* pids, const int* n_rows,
                                      int n, long long i) {
  if (i >= (long long)*n_rows) return n;
  const int p = pids[i];
  return p < 0 ? 0 : (p > n ? n : p);
}

__global__ void histogram_kernel(const int* pids, const int* n_rows,
                                 long long cap, int n, int n_blocks,
                                 int* hist) {
  __shared__ int h[MAX_PARTS + 1];
  for (int b = threadIdx.x; b <= n; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + (long long)r * scan::kThreads + threadIdx.x;
    if (i < cap) atomicAdd(&h[bin_of(pids, n_rows, n, i)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= n; b += blockDim.x)
    hist[(long long)b * n_blocks + blockIdx.x] = h[b];
}

__global__ void scatter_kernel(const int* pids, const int* n_rows,
                               long long cap, int n, int n_blocks,
                               const int* offsets, long long* perm,
                               int* counts) {
  __shared__ int slot[MAX_PARTS + 1];
  for (int b = threadIdx.x; b <= n; b += blockDim.x)
    slot[b] = offsets[(long long)b * n_blocks + blockIdx.x];
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
        if (bin >= 0) perm[slot[bin] + __popc(peers & lower)] = i;
        __syncwarp();
        if (bin >= 0 && lane == __ffs(peers) - 1) slot[bin] += __popc(peers);
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Bytes of scratch partition_split needs for cap rows and n partitions.
long long partition_split_scratch_bytes(long long cap, int n) {
  const long long blocks = (cap + TILE - 1) / TILE;
  return ((long long)(n + 1) * blocks + 1) * (long long)sizeof(int);
}

int partition_split_max_parts() { return MAX_PARTS; }

// pids: int32[cap]; n_rows: int32[1] on the device; perm: int64[cap];
// counts: int32[n]. Returns 0 or the CUDA error of a launch.
int partition_split(const void* pids, const void* n_rows, long long cap,
                    int n, void* perm, void* counts, void* scratch,
                    void* stream) {
  const long long blocks = (cap + TILE - 1) / TILE;
  if (cap < 1 || n < 1 || n > MAX_PARTS ||
      (long long)(n + 1) * blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* hist = (int*)scratch;
  const int nb = (int)blocks;
  histogram_kernel<<<nb, scan::kThreads, 0, s>>>(
      (const int*)pids, (const int*)n_rows, cap, n, nb, hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int entries = (n + 1) * nb;
  scan::scan_totals_kernel<int><<<1, scan::kTotalsThreads, 0, s>>>(
      hist, entries, hist + entries);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nb, scan::kThreads, 0, s>>>(
      (const int*)pids, (const int*)n_rows, cap, n, nb, hist,
      (long long*)perm, (int*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
