// K14 build_matched: which rows of a sorted build side some stream row
// matched, for the unmatched build rows of a full outer join.
//
// Replaces spark_rapids_tpu/ops/joins.py:join_match's build_matched
// (147-153, B11). K6 gives every stream row the range [lo, lo + count) of
// the equal rows in the sorted build side. Every stream row with count > 0
// adds +1 at delta[lo] and -1 at delta[lo + count] of an int32[bcap + 1]
// array; the inclusive prefix sum of delta is positive exactly over the
// covered build rows, so
//   matched[j] = (delta[0] + ... + delta[j] > 0) && j < *n_build
// for j < bcap, in the build's sorted order. NULL-key build rows are never
// covered (K2's null-rank bit keeps them apart from every non-NULL probe),
// so they come out unmatched, as the reference's note says.
//
// Bound on the card: bytes (lo and count of every stream row read, 8 bytes
// of marks a matched stream row written, delta read once by each of the
// scan's two passes, one byte a build row written). Design: one thread per
// stream row with two integer atomicAdds (integer addition is
// order-free, so the result is the same from run to run), then the grid
// scan of scan_common.cuh (three launches, no atomics), whose second pass
// writes the flags.
#include "scan_common.cuh"

namespace {

__global__ void marks_kernel(const int* lo, const int* count, long long n,
                             int* delta) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = count[i];
  if (c <= 0) return;
  atomicAdd(delta + lo[i], 1);
  atomicAdd(delta + lo[i] + c, -1);
}

__global__ void sums_kernel(const int* delta, long long bcap,
                            int* block_totals) {
  const long long j = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const int d = j < bcap ? delta[j] : 0;
  const int t = scan::block_sum<int>(d);
  if (threadIdx.x == 0) block_totals[blockIdx.x] = t;
}

__global__ void flags_kernel(const int* delta, long long bcap,
                             const int* offsets, const int* n_build,
                             uint8_t* matched) {
  const long long j = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const int d = j < bcap ? delta[j] : 0;
  const int incl =
      offsets[blockIdx.x] + scan::block_inclusive_scan<int>(d, nullptr);
  if (j < bcap) matched[j] = (incl > 0 && j < (long long)*n_build) ? 1 : 0;
}

}  // namespace

extern "C" {

// Bytes of scratch build_matched needs for a build capacity of bcap: the
// delta array, the block totals and the grand total.
long long build_matched_scratch_bytes(long long bcap) {
  return (bcap + 1 + (long long)scan::num_blocks(bcap) + 1) *
         (long long)sizeof(int);
}

// lo, count: int32[n] (K6's outputs over the stream rows); n_build: int32[1]
// on the device; matched: uint8[bcap] (torch.bool). Returns 0 or the CUDA
// error of a launch.
int build_matched(const void* lo, const void* count, long long n,
                  const void* n_build, long long bcap, void* matched,
                  void* scratch, void* stream) {
  if (n < 1 || bcap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = scan::num_blocks(bcap);
  int* delta = (int*)scratch;
  int* totals = delta + bcap + 1;
  int* grand = totals + nb;
  cudaError_t e = cudaMemsetAsync(delta, 0, (bcap + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  marks_kernel<<<scan::num_blocks(n), scan::kThreads, 0, s>>>(
      (const int*)lo, (const int*)count, n, delta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sums_kernel<<<nb, scan::kThreads, 0, s>>>(delta, bcap, totals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan::scan_totals_kernel<int><<<1, scan::kTotalsThreads, 0, s>>>(
      totals, nb, grand);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flags_kernel<<<nb, scan::kThreads, 0, s>>>(delta, bcap, totals,
                                            (const int*)n_build,
                                            (uint8_t*)matched);
  return (int)cudaGetLastError();
}

}  // extern "C"
