// K6 join_probe: the range of equal build keys for every probe row of an
// equi-join.
//
// Replaces the search half of spark_rapids_tpu/ops/joins.py:join_match
// (_search_bounds, _lex_cmp, _normalize_words; B11). Both sides' keys come
// in as K2's 63-bit lanes (sort_key_lanes.cu), encoded with the same key
// descriptors, so lane equality is SQL key equality (NaN equals NaN, -0.0
// equals +0.0, strings widened to one width) and the lanes' lexicographic
// order is the build side's sort order. For every probe row i it writes
//   lo[i]     the first build row j in [0, *n_build) with build[j] >= probe[i]
//             (the lower bound over the sorted build lanes);
//   count[i]  upper bound - lo[i] when row i is live (i < *n_probe) and
//             none of its keys is NULL, else 0;
//   total[2]  the sum of count, and the number of live probe rows whose
//             count is 0 (int64): an outer join's output rows are their
//             sum, read from the device in one copy.
//
// Bound on the card: bytes (the probe lanes and validities read once, 8
// bytes a row written, plus the build-lane sectors the searches visit).
// Design: one thread per probe row, two binary searches over lane-major
// build lanes (the upper one starts from the lower bound), the probe's lanes
// in registers. The two totals share one block sum (packed into one
// int64) and take one integer atomic each per block: integer addition,
// so the totals are the same whatever the order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

#define MAX_PROBE_KEYS 8
#define MAX_LANES 16

namespace {

constexpr int kPackBits = 9;  // 2^9 > scan::kThreads
static_assert((1 << kPackBits) > scan::kThreads, "pack width");

struct ValidTable {
  int n;
  const uint8_t* v[MAX_PROBE_KEYS];
};

// -1, 0 or 1: build row j against the probe lanes p.
__device__ __forceinline__ int lex_cmp(const long long* build, long long bcap,
                                       long long j, const long long* p,
                                       int nl) {
  for (int l = 0; l < nl; ++l) {
    const long long a = build[(long long)l * bcap + j];
    if (a != p[l]) return a < p[l] ? -1 : 1;
  }
  return 0;
}

__global__ void probe_kernel(const long long* build, long long bcap,
                             const int* n_build, const long long* probe,
                             long long pcap, int nl, ValidTable vt,
                             const int* n_probe, int* lo_out, int* count_out,
                             unsigned long long* total) {
  const long long i = (long long)blockIdx.x * scan::kThreads + threadIdx.x;
  long long c = 0;
  long long unmatched = 0;
  if (i < pcap) {
    long long p[MAX_LANES];
    for (int l = 0; l < nl; ++l) p[l] = probe[(long long)l * pcap + i];
    long long lo = 0;
    long long hi = *n_build;
    while (lo < hi) {  // first j with build[j] >= p
      const long long mid = (lo + hi) >> 1;
      if (lex_cmp(build, bcap, mid, p, nl) < 0) lo = mid + 1;
      else hi = mid;
    }
    const long long first = lo;
    hi = *n_build;
    while (lo < hi) {  // first j with build[j] > p
      const long long mid = (lo + hi) >> 1;
      if (lex_cmp(build, bcap, mid, p, nl) <= 0) lo = mid + 1;
      else hi = mid;
    }
    bool ok = i < (long long)*n_probe;
    for (int k = 0; k < vt.n; ++k) ok = ok && vt.v[k][i] != 0;
    c = ok ? lo - first : 0;
    unmatched = (i < (long long)*n_probe && c == 0) ? 1 : 0;
    lo_out[i] = (int)first;
    count_out[i] = (int)c;
  }
  // one block sum carries both totals: the unmatched rows of a block
  // (at most kThreads) fit in the low kPackBits bits
  const long long block =
      scan::block_sum<long long>((c << kPackBits) + unmatched);
  const long long block_total = block >> kPackBits;
  const long long block_unmatched = block & ((1ll << kPackBits) - 1);
  if (threadIdx.x == 0 && block_total != 0)
    atomicAdd(total, (unsigned long long)block_total);
  if (threadIdx.x == 0 && block_unmatched != 0)
    atomicAdd(total + 1, (unsigned long long)block_unmatched);
}

}  // namespace

extern "C" {

// build: int64[nl * bcap] sorted lanes, lane-major; probe: int64[nl * pcap].
// valid: nkeys uint8[pcap] validity arrays of the probe keys. lo, count:
// int32[pcap]; total: int64[2]. Returns 0 or the CUDA error.
int join_probe(const void* build, long long bcap, const void* n_build,
               const void* probe, long long pcap, int nl,
               const void* const* valid, int nkeys, const void* n_probe,
               void* lo, void* count, void* total, void* stream) {
  if (nl < 1 || nl > MAX_LANES || nkeys < 0 || nkeys > MAX_PROBE_KEYS ||
      pcap < 1)
    return (int)cudaErrorInvalidValue;
  ValidTable vt;
  vt.n = nkeys;
  for (int k = 0; k < nkeys; ++k) vt.v[k] = (const uint8_t*)valid[k];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(total, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  probe_kernel<<<scan::num_blocks(pcap), scan::kThreads, 0, s>>>(
      (const long long*)build, bcap, (const int*)n_build,
      (const long long*)probe, pcap, nl, vt, (const int*)n_probe, (int*)lo,
      (int*)count, (unsigned long long*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
