// K7 join_expand: the (stream row, build row) pair of every output slot of
// an inner equi-join.
//
// Replaces spark_rapids_tpu/ops/joins.py:_expand_indices and the index half
// of join_gather (B12). From K6's per-stream-row match ranges (lo, count)
// and the build side's sort permutation it computes cum = the inclusive
// prefix sum of count, total = cum[n - 1], and for every output slot
// i < out_cap:
//   stream_idx[i] = the first j with cum[j] > i,
//   build_idx[i]  = order[lo[j] + i - (cum[j] - count[j])]   (i < total),
// and 0 for both at the slots i >= total (the caller masks those).
//
// Bound on the card: bytes (count and lo read, cum written and read, the
// order entries of the pairs read, 16 bytes an output slot written). Design:
// the grid scan of scan_common.cuh in int64 (three launches, no atomics),
// then one thread per output slot with a binary search into cum, so the
// work per thread is the same whatever the skew of the keys (a hot key with
// millions of matches spreads over millions of threads).
#include "scan_common.cuh"

namespace {

__global__ void sums_kernel(const int* count, long long n,
                            long long* block_totals) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long c = i < n ? (long long)count[i] : 0;
  const long long t = scan::block_sum<long long>(c);
  if (threadIdx.x == 0) block_totals[blockIdx.x] = t;
}

__global__ void cum_kernel(const int* count, long long n,
                           const long long* offsets, long long* cum) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long c = i < n ? (long long)count[i] : 0;
  const long long incl =
      offsets[blockIdx.x] + scan::block_inclusive_scan<long long>(c, nullptr);
  if (i < n) cum[i] = incl;
}

__global__ void expand_kernel(const long long* cum, const int* count,
                              const int* lo, long long n,
                              const long long* order, long long out_cap,
                              const long long* total, long long* stream_idx,
                              long long* build_idx) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  if (i >= out_cap) return;
  if (i >= *total) {
    stream_idx[i] = 0;
    build_idx[i] = 0;
    return;
  }
  long long a = 0;
  long long b = n;
  while (a < b) {  // first j with cum[j] > i
    const long long mid = (a + b) >> 1;
    if (cum[mid] <= i) a = mid + 1;
    else b = mid;
  }
  const long long start = cum[a] - (long long)count[a];
  stream_idx[i] = a;
  build_idx[i] = order[(long long)lo[a] + (i - start)];
}

}  // namespace

extern "C" {

// Bytes of scratch join_expand needs for n stream rows: the block totals
// and cum.
long long join_expand_scratch_bytes(long long n) {
  return ((long long)scan::num_blocks(n) + n) * (long long)sizeof(long long);
}

// count, lo: int32[n]; order: int64 build permutation; stream_idx,
// build_idx: int64[out_cap]; total: int64[1] (written). Returns 0 or the
// CUDA error of a launch.
int join_expand(const void* count, const void* lo, long long n,
                const void* order, long long out_cap, void* stream_idx,
                void* build_idx, void* total, void* scratch, void* stream) {
  if (n < 1 || out_cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = scan::num_blocks(n);
  long long* totals = (long long*)scratch;
  long long* cum = totals + nb;
  sums_kernel<<<nb, scan::kThreads, 0, s>>>((const int*)count, n, totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan::scan_totals_kernel<long long><<<1, scan::kTotalsThreads, 0, s>>>(
      totals, nb, (long long*)total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cum_kernel<<<nb, scan::kThreads, 0, s>>>((const int*)count, n, totals, cum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<scan::num_blocks(out_cap), scan::kThreads, 0, s>>>(
      cum, (const int*)count, (const int*)lo, n, (const long long*)order,
      out_cap, (const long long*)total, (long long*)stream_idx,
      (long long*)build_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
