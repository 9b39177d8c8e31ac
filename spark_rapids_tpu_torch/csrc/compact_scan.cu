// K5 compact_scan: the stable kept-first permutation of a keep mask, and
// the kept count, for filter compaction.
//
// Replaces spark_rapids_tpu/ops/kernels.py:compaction_indices (B7), which
// compact_columns gathers every column through. For keep[0..n) it writes
//   perm[n]    kept rows first in row order, then the dropped rows in row
//              order: perm[pos[i]] = i with pos[i] = (kept before i) for a
//              kept row and n_keep + (dropped before i) for a dropped one;
//   n_keep[1]  the number of kept rows, left on the device.
//
// Bound on the card: bytes (1 byte a row read twice by the two per-row
// passes, 8 bytes a row written). Design: the grid scan of scan_common.cuh,
// three launches and no atomics; every perm slot is written exactly once,
// so the permutation is the same from run to run. The row is the unit of
// work, so a batch of any capacity fills the card.
#include "scan_common.cuh"

namespace {

__global__ void count_kernel(const uint8_t* keep, long long n,
                             int* block_counts) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const bool k = i < n && keep[i] != 0;
  const int c = __syncthreads_count(k);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void scatter_kernel(const uint8_t* keep, long long n,
                               const int* offsets, const int* n_keep,
                               long long* perm) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const int k = (i < n && keep[i] != 0) ? 1 : 0;
  const long long incl =
      (long long)offsets[blockIdx.x] + scan::block_inclusive_scan<int>(k, nullptr);
  if (i >= n) return;
  const long long pos = k ? incl - 1 : (long long)*n_keep + (i + 1 - incl) - 1;
  perm[pos] = i;
}

}  // namespace

extern "C" {

// Bytes of scratch compact_scan needs for n rows.
long long compact_scan_scratch_bytes(long long n) {
  return (long long)scan::num_blocks(n) * (long long)sizeof(int);
}

// keep: uint8[n] (torch.bool). perm: int64[n]. n_keep: int32[1].
// Returns 0 or the CUDA error of a launch.
int compact_scan(const void* keep, long long n, void* perm, void* n_keep,
                 void* scratch, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = scan::num_blocks(n);
  count_kernel<<<nb, scan::kThreads, 0, s>>>((const uint8_t*)keep, n,
                                            (int*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan::scan_totals_kernel<int><<<1, scan::kTotalsThreads, 0, s>>>(
      (int*)scratch, nb, (int*)n_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nb, scan::kThreads, 0, s>>>((const uint8_t*)keep, n,
                                              (const int*)scratch,
                                              (const int*)n_keep,
                                              (long long*)perm);
  return (int)cudaGetLastError();
}

}  // extern "C"
