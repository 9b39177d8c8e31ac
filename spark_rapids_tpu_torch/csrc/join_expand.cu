// K7 join_expand: the (stream row, build row) pair of every output slot of
// an inner or a left outer equi-join.
//
// Replaces spark_rapids_tpu/ops/joins.py:_expand_indices and the index half
// of join_gather (B12), its inner branch and its left branch (201-216).
// From K6's per-stream-row match ranges (lo, count) and the build side's
// sort permutation it takes each stream row's slot count e[j]: count[j]
// (inner), or in outer mode max(count[j], 1) for a live row (j <
// *n_stream) and 0 for a dead one, so every live row emits at least one
// slot, a row with a NULL key too. It computes cum = the inclusive prefix
// sum of e, total = cum[n - 1], and for every output slot i < out_cap:
//   stream_idx[i] = the first j with cum[j] > i,
//   build_idx[i]  = order[lo[j] + i - (cum[j] - e[j])]   (i < total),
//                   or -1 where count[j] == 0 (outer mode: the slot's build
//                   columns are NULL),
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

// Row j's slot count: count[j], or in outer mode max(count[j], 1) for a
// live row and 0 for a dead one.
__device__ __forceinline__ long long slots(const int* count, long long j,
                                           long long n, int outer,
                                           const int* n_stream) {
  if (j >= n) return 0;
  const long long c = (long long)count[j];
  if (!outer) return c;
  if (j >= (long long)*n_stream) return 0;
  return c > 0 ? c : 1;
}

__global__ void sums_kernel(const int* count, long long n, int outer,
                            const int* n_stream, long long* block_totals) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long c = slots(count, i, n, outer, n_stream);
  const long long t = scan::block_sum<long long>(c);
  if (threadIdx.x == 0) block_totals[blockIdx.x] = t;
}

__global__ void cum_kernel(const int* count, long long n, int outer,
                           const int* n_stream, const long long* offsets,
                           long long* cum) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long c = slots(count, i, n, outer, n_stream);
  const long long incl =
      offsets[blockIdx.x] + scan::block_inclusive_scan<long long>(c, nullptr);
  if (i < n) cum[i] = incl;
}

__global__ void expand_kernel(const long long* cum, const int* count,
                              const int* lo, long long n, int outer,
                              const int* n_stream, const long long* order,
                              long long out_cap, const long long* total,
                              long long* stream_idx, long long* build_idx) {
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
  stream_idx[i] = a;
  if (count[a] == 0) {  // outer mode: a live row with no match
    build_idx[i] = -1;
    return;
  }
  const long long start = cum[a] - slots(count, a, n, outer, n_stream);
  build_idx[i] = order[(long long)lo[a] + (i - start)];
}

}  // namespace

extern "C" {

// Bytes of scratch join_expand needs for n stream rows: the block totals
// and cum.
long long join_expand_scratch_bytes(long long n) {
  return ((long long)scan::num_blocks(n) + n) * (long long)sizeof(long long);
}

// count, lo: int32[n]; outer: 0 (inner) or 1 (left outer, n_stream: the
// live stream rows, int32[1] on the device; unread when outer is 0);
// order: int64 build permutation; stream_idx, build_idx: int64[out_cap];
// total: int64[1] (written). Returns 0 or the CUDA error of a launch.
int join_expand(const void* count, const void* lo, long long n, int outer,
                const void* n_stream, const void* order, long long out_cap,
                void* stream_idx, void* build_idx, void* total, void* scratch,
                void* stream) {
  if (n < 1 || out_cap < 1 || (outer && n_stream == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* ns = (const int*)n_stream;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = scan::num_blocks(n);
  long long* totals = (long long*)scratch;
  long long* cum = totals + nb;
  sums_kernel<<<nb, scan::kThreads, 0, s>>>((const int*)count, n, outer, ns,
                                            totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan::scan_totals_kernel<long long><<<1, scan::kTotalsThreads, 0, s>>>(
      totals, nb, (long long*)total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cum_kernel<<<nb, scan::kThreads, 0, s>>>((const int*)count, n, outer, ns,
                                           totals, cum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<scan::num_blocks(out_cap), scan::kThreads, 0, s>>>(
      cum, (const int*)count, (const int*)lo, n, outer, ns,
      (const long long*)order, out_cap, (const long long*)total,
      (long long*)stream_idx, (long long*)build_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
