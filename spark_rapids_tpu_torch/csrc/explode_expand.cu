// K25 explode_expand: the (source row, element position) of every output
// row of explode / posexplode, and in array mode the element itself.
//
// Replaces spark_rapids_tpu/ops/arrays.py:explode_indices (146) and the
// element gather of explode_array (165), B17; in index mode it is the row
// map of split_explode (200). A row's slot count is e[j] = counts[j] where
// live[j] and valid[j], else 0 (a NULL or empty array gives no row). With
// cum the inclusive prefix sum of e and total = cum[n - 1], for every
// output row i < out_cap:
//   src[i] = the first j with cum[j] > i,   pos[i] = i - (cum[j] - e[j])
// (i < total), and 0 for both at i >= total. Array mode also writes
//   out_valid[i] = elem_valid[src, pos],   out[i] = data[src, pos] where
// out_valid[i], else 0 (any primitive dtype: the element is copied by its
// byte width 1, 2, 4 or 8).
//
// Two entry points: explode_scan sums the counts (the grid scan of
// scan_common.cuh in int64, three launches, no atomics) and writes total;
// the caller reads total once to size the output (the generate exec's one
// size read a batch), then explode_expand runs one thread per output row
// with a binary search into cum, so a long array spreads over as many
// threads as it has elements.
//
// Bound on the card: bytes (counts, validity and the live mask read, the
// elements of the live arrays and their validity read, src, pos, the
// element and its validity written over the output capacity).
#include "scan_common.cuh"

namespace {

__device__ __forceinline__ long long slots(const int* counts,
                                           const bool* valid,
                                           const bool* live, long long j,
                                           long long n) {
  if (j >= n) return 0;
  return (live[j] && valid[j]) ? (long long)counts[j] : 0;
}

__global__ void sums_kernel(const int* counts, const bool* valid,
                            const bool* live, long long n,
                            long long* block_totals) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long t =
      scan::block_sum<long long>(slots(counts, valid, live, i, n));
  if (threadIdx.x == 0) block_totals[blockIdx.x] = t;
}

__global__ void cum_kernel(const int* counts, const bool* valid,
                           const bool* live, long long n,
                           const long long* offsets, long long* cum) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  const long long incl =
      offsets[blockIdx.x] + scan::block_inclusive_scan<long long>(
                                slots(counts, valid, live, i, n), nullptr);
  if (i < n) cum[i] = incl;
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* data, long long at,
                                          void* out, long long i, bool ok) {
  ((T*)out)[i] = ok ? ((const T*)data)[at] : T(0);
}

__global__ void expand_kernel(const long long* cum, const int* counts,
                              const bool* valid, const bool* live,
                              long long n, long long out_cap,
                              const long long* total, const void* data,
                              long long width, int elem_bytes,
                              const bool* elem_valid, int* src, int* pos,
                              void* out, bool* out_valid) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  if (i >= out_cap) return;
  long long j = 0;
  long long p = 0;
  bool ok = false;
  if (i < *total) {
    long long a = 0;
    long long b = n;
    while (a < b) {  // first j with cum[j] > i
      const long long mid = (a + b) >> 1;
      if (cum[mid] <= i) a = mid + 1;
      else b = mid;
    }
    j = a;
    p = i - (cum[j] - slots(counts, valid, live, j, n));
    ok = true;
  }
  src[i] = (int)j;
  pos[i] = (int)p;
  if (data == nullptr) return;
  const long long at = j * width + p;
  ok = ok && elem_valid[at];
  out_valid[i] = ok;
  switch (elem_bytes) {
    case 1: copy_elem<unsigned char>(data, at, out, i, ok); break;
    case 2: copy_elem<unsigned short>(data, at, out, i, ok); break;
    case 4: copy_elem<unsigned int>(data, at, out, i, ok); break;
    default: copy_elem<unsigned long long>(data, at, out, i, ok); break;
  }
}

}  // namespace

extern "C" {

// Bytes of scratch for n rows: the block totals, then cum.
long long explode_scratch_bytes(long long n) {
  return ((long long)scan::num_blocks(n) + n) * (long long)sizeof(long long);
}

// counts: int32[n]; valid, live: bool[n]; total: int64[1] (written).
int explode_scan(const void* counts, const void* valid, const void* live,
                 long long n, void* total, void* scratch, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = scan::num_blocks(n);
  long long* totals = (long long*)scratch;
  long long* cum = totals + nb;
  sums_kernel<<<nb, scan::kThreads, 0, s>>>(
      (const int*)counts, (const bool*)valid, (const bool*)live, n, totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan::scan_totals_kernel<long long><<<1, scan::kTotalsThreads, 0, s>>>(
      totals, nb, (long long*)total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cum_kernel<<<nb, scan::kThreads, 0, s>>>(
      (const int*)counts, (const bool*)valid, (const bool*)live, n, totals,
      cum);
  return (int)cudaGetLastError();
}

// After explode_scan on the same scratch. src, pos: int32[out_cap]. Array
// mode: data [n, width] of elem_bytes-byte elements and elem_valid
// bool[n, width]; out [out_cap] elements and out_valid bool[out_cap]
// written. Index mode: data, elem_valid, out and out_valid null.
int explode_expand(const void* counts, const void* valid, const void* live,
                   long long n, long long out_cap, const void* total,
                   const void* scratch, const void* data, long long width,
                   int elem_bytes, const void* elem_valid, void* src,
                   void* pos, void* out, void* out_valid, void* stream) {
  if (n < 1 || out_cap < 1) return (int)cudaErrorInvalidValue;
  if (data != nullptr &&
      (elem_valid == nullptr || out == nullptr || out_valid == nullptr ||
       width < 1 || (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 &&
                     elem_bytes != 8)))
    return (int)cudaErrorInvalidValue;
  const long long* cum =
      (const long long*)scratch + scan::num_blocks(n);
  expand_kernel<<<scan::num_blocks(out_cap), scan::kThreads, 0,
                  (cudaStream_t)stream>>>(
      cum, (const int*)counts, (const bool*)valid, (const bool*)live, n,
      out_cap, (const long long*)total, data, width, elem_bytes,
      (const bool*)elem_valid, (int*)src, (int*)pos, out, (bool*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
