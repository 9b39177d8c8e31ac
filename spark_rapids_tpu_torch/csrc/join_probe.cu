// K6 join_probe: the range of equal build keys for every probe row of an
// equi-join, or (lower-bound mode) the lower bound alone.
//
// Replaces the search half of spark_rapids_tpu/ops/joins.py:join_match
// (_search_bounds, _lex_cmp, _normalize_words; B11), and in lower-bound
// mode the range partition ids of spark_rapids_tpu/shuffle/partitioning.py
// (partition_ids 256-273: the number of bounds strictly below a row) and
// of parallel/mesh.py's distributed sort. Both sides' keys come in as K2's
// 63-bit lanes (sort_key_lanes.cu), encoded with the same key descriptors,
// so lane equality is SQL key equality (NaN equals NaN, -0.0 equals +0.0,
// strings widened to one width) and the lanes' lexicographic order is the
// build side's sort order. For every probe row i it writes
//   lo[i]     the first build row j in [0, n_build) with build[j] >= probe[i]
//             (the lower bound over the sorted build lanes), for every row
//             of the capacity, padding and NULL rows included;
//   count[i]  upper bound - lo[i] when row i is live (i < n_probe) and
//             none of its keys is NULL, else 0;
//   total[2]  the sum of count, and the number of live probe rows whose
//             count is 0 (int64): an outer join's output rows are their
//             sum, read from the device in one copy.
// The lower-bound mode writes lo only: no count, no totals, no memset.
//
// Bound on the card: bytes (the probe lanes and validities read once, 8
// bytes a row written, plus the build-lane sectors the searches visit);
// the searches are chains of dependent loads, so latency is what the
// design works on:
//   - the probe's lanes stay in registers: one specialisation for 1, 2, 3
//     and 4 lanes and one for up to MAX_LANES, unrolled over MAX_LANES and
//     predicated on the live lane count (no lane indexed at run time, no
//     stack frame);
//   - the build side may come row-major (ops/joins.py:sort_build writes
//     it so): a row's lanes then share one 32-byte sector, and a step of
//     a search in device memory reads one sector (a 16-byte load per two
//     lanes) where lane-major lanes read one a lane (a one-key int64 join
//     has two lanes);
//   - each block stages a sample of the sorted build rows in shared memory
//     (every s-th row, 32 KB: 4096 rows at one lane, fewer at more, s
//     worked out from n_build) once, then runs over probe rows grid-stride
//     on a grid sized to the SMs. A probe searches the sample first, which
//     leaves a stretch of s rows in device memory; with s == 1 (small
//     builds: the broadcast joins, the range bounds) the whole search is
//     in shared memory;
//   - one search: the lower bound's search keeps the tightest row known to
//     be greater than the probe, and the upper bound gallops from lo (steps
//     1, 2, 4, ...) below it, then bisects the last step. It is skipped for
//     a row past n_probe, with a NULL key, or whose build[lo] differs (the
//     search knows whether the row it converged on is equal);
//   - 32-bit row indices (capacities below 2^31);
//   - counts by value (no host -> device copy) or by device pointer.
// The totals take one block sum and one integer atomic each per block, so
// they are the same whatever order the blocks run in.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"
#include "scan_common.cuh"

#define MAX_PROBE_KEYS 8
#define MAX_LANES 16

namespace {

constexpr int kThreads = 512;
constexpr int kSampleBytes = 32 * 1024;
constexpr int kSampleLaneRows = kSampleBytes / 8;  // 4096 rows at one lane

struct ValidTable {
  int n;
  const uint8_t* v[MAX_PROBE_KEYS];
};

// The sample's rows in shared memory, lanes side by side.
struct SampleRows {
  const long long* rows;
  int lanes;
  __device__ long long lane(int j, int l) const { return rows[j * lanes + l]; }
  template <int NL>
  __device__ void load(int j, long long (&a)[NL]) const {
#pragma unroll
    for (int l = 0; l < NL; ++l) a[l] = rows[j * NL + l];
  }
};

// The build in device memory: lane l of row j at b[l * lane_stride +
// j * row_stride], lane-major (bcap, 1) or row-major (1, lanes). Row-major
// rows of an even lane count, 16-byte aligned (`pairs`), load two lanes
// with one 16-byte load.
struct BuildRows {
  const long long* __restrict__ b;
  long long lane_stride;
  int row_stride;
  bool pairs;
  __device__ long long lane(int j, int l) const {
    return __ldg(b + l * lane_stride + (long long)j * row_stride);
  }
  template <int NL>
  __device__ void load(int j, long long (&a)[NL]) const {
    if constexpr (NL % 2 == 0) {
      if (pairs) {
        const longlong2* r =
            reinterpret_cast<const longlong2*>(b + (long long)j * NL);
#pragma unroll
        for (int h = 0; h < NL / 2; ++h) {
          const longlong2 v = __ldg(r + h);
          a[2 * h] = v.x;
          a[2 * h + 1] = v.y;
        }
        return;
      }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) a[l] = lane(j, l);
  }
};

// -1, 0 or 1: row j of `rows` against the probe. Up to 4 lanes every
// lane's read is issued before the first compare, so a step of a search
// waits for one memory latency, not one a lane (and a row-major row is one
// sector); the general form reads lane by lane and stops at the first
// that differs.
template <int NL, typename Rows>
__device__ __forceinline__ int cmp_row(const Rows& rows, int j,
                                       const long long (&p)[NL], int lanes) {
  if constexpr (NL <= 4) {
    long long a[NL];
    rows.template load<NL>(j, a);
#pragma unroll
    for (int l = 0; l < NL; ++l)
      if (a[l] != p[l]) return a[l] < p[l] ? -1 : 1;
    return 0;
  } else {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (l < lanes) {
        const long long a = rows.lane(j, l);
        if (a != p[l]) return a < p[l] ? -1 : 1;
      }
    }
    return 0;
  }
}

template <int NL, bool LOWER>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const long long* __restrict__ build, long long lane_stride,
             int row_stride, const int* n_build_ptr, int n_build_value,
             const long long* __restrict__ probe, int pcap, int nl,
             ValidTable vt, const int* n_probe_ptr, int n_probe_value,
             int* __restrict__ lo_out, int* __restrict__ count_out,
             unsigned long long* total) {
  extern __shared__ __align__(16) long long sample[];  // [rows][lanes]
  const int lanes = NL == MAX_LANES ? nl : NL;
  const int nb = n_build_ptr != nullptr ? *n_build_ptr : n_build_value;
  const int np = n_probe_ptr != nullptr ? *n_probe_ptr : n_probe_value;
  const int rows_max = kSampleLaneRows / lanes;
  const int s = nb <= rows_max ? 1 : (nb + rows_max - 1) / rows_max;
  const int m = (nb + s - 1) / s;  // sample rows: build rows 0, s, 2s, ...
  const BuildRows brows{build, lane_stride, row_stride,
                        row_stride == lanes && lanes % 2 == 0 &&
                            reinterpret_cast<uintptr_t>(build) % 16 == 0};
  for (int t = threadIdx.x; t < m * lanes; t += kThreads) {
    const int k = t / lanes;
    sample[t] = brows.lane(k * s, t - k * lanes);
  }
  __syncthreads();
  const SampleRows srows{sample, lanes};

  long long pairs = 0;
  long long unmatched = 0;
  const unsigned step = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < (unsigned)pcap;
       i += step) {
    long long p[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l)
      p[l] = l < lanes ? __ldg(probe + l * (long long)pcap + i) : 0;
    // the lower bound among the sample rows; `eq`: the row at the upper
    // end of the range equals the probe; `gt`: the first row known to be
    // greater (n_build stands for +infinity)
    int a = 0, b = m, gt = nb;
    bool eq = false;
    while (a < b) {
      const int mid = a + ((b - a) >> 1);
      const int c = cmp_row<NL>(srows, mid, p, lanes);
      if (c < 0) {
        a = mid + 1;
      } else {
        b = mid;
        eq = c == 0;
        if (c > 0) gt = mid * s;
      }
    }
    int lo = a;
    if (s > 1 && a > 0) {
      // build[(a - 1) s] < probe <= build[a s] (or a s is past n_build):
      // the lower bound is in ((a - 1) s, min(a s, n_build)]
      int h = a < m ? a * s : nb;
      lo = (a - 1) * s + 1;
      while (lo < h) {
        const int mid = lo + ((h - lo) >> 1);
        const int c = cmp_row<NL>(brows, mid, p, lanes);
        if (c < 0) {
          lo = mid + 1;
        } else {
          h = mid;
          eq = c == 0;
          if (c > 0) gt = mid;
        }
      }
    }
    lo_out[i] = lo;
    if (LOWER) continue;
    const bool live = i < (unsigned)np;
    bool ok = live;
#pragma unroll
    for (int k = 0; k < MAX_PROBE_KEYS; ++k)
      if (k < vt.n) ok = ok && vt.v[k][i] != 0;
    int c = 0;
    if (ok && eq) {
      // build[lo] == probe: gallop to the first greater row, which lies in
      // (lo, gt]; `base` is always an equal row
      int base = lo, hi = gt;
      for (unsigned d = 1; d < (unsigned)(hi - base); d <<= 1) {
        const int j = base + (int)d;
        const int cj = s == 1 ? cmp_row<NL>(srows, j, p, lanes)
                              : cmp_row<NL>(brows, j, p, lanes);
        if (cj != 0) {
          hi = j;
          break;
        }
        base = j;
      }
      int u = base + 1;
      while (u < hi) {
        const int mid = u + ((hi - u) >> 1);
        const int cm = s == 1
                           ? cmp_row<NL>(srows, mid, p, lanes)
                           : cmp_row<NL>(brows, mid, p, lanes);
        if (cm == 0) u = mid + 1;
        else hi = mid;
      }
      c = hi - lo;
    }
    count_out[i] = c;
    pairs += c;
    unmatched += (live && c == 0) ? 1 : 0;
  }
  if (LOWER) return;
  // one block sum of each total, then one integer atomic each
  pairs = scan::block_sum<long long, kThreads>(pairs);
  __syncthreads();  // the sums share their shared memory
  unmatched = scan::block_sum<long long, kThreads>(unmatched);
  if (threadIdx.x == 0 && pairs != 0)
    atomicAdd(total, (unsigned long long)pairs);
  if (threadIdx.x == 0 && unmatched != 0)
    atomicAdd(total + 1, (unsigned long long)unmatched);
}

struct Args {
  const long long* build;
  long long lane_stride;
  int row_stride;
  const int* n_build_ptr;
  int n_build_value;
  const long long* probe;
  int pcap;
  int nl;
  ValidTable vt;
  const int* n_probe_ptr;
  int n_probe_value;
  int* lo;
  int* count;
  unsigned long long* total;
};

template <int NL, bool LOWER>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = kSampleBytes;
  static int per_sm = 0;  // resident blocks per SM
  if (per_sm == 0) {
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, probe_kernel<NL, LOWER>, kThreads, smem);
    if (e != cudaSuccess) return e;
    per_sm = n > 0 ? n : 1;
  }
  long long blocks = (long long)per_sm * launch::sm_count();
  const long long need = ((long long)a.pcap + kThreads - 1) / kThreads;
  if (need < blocks) blocks = need;
  probe_kernel<NL, LOWER><<<(unsigned)blocks, kThreads, smem, stream>>>(
      a.build, a.lane_stride, a.row_stride, a.n_build_ptr, a.n_build_value,
      a.probe, a.pcap, a.nl, a.vt, a.n_probe_ptr, a.n_probe_value, a.lo,
      a.count, a.total);
  return cudaGetLastError();
}

template <bool LOWER>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (a.nl) {
    case 1: return launch<1, LOWER>(a, stream);
    case 2: return launch<2, LOWER>(a, stream);
    case 3: return launch<3, LOWER>(a, stream);
    case 4: return launch<4, LOWER>(a, stream);
    default: return launch<MAX_LANES, LOWER>(a, stream);
  }
}

}  // namespace

extern "C" {

// build: int64 sorted lanes, lane l of row j at build[l * lane_stride +
// j * row_stride], lane-major (lane_stride bcap, row_stride 1) or
// row-major (1, nl); probe: int64[nl * pcap], lane-major. n_build,
// n_probe: an int32[1] on the device, or NULL to take n_build_value /
// n_probe_value. valid: nkeys uint8[pcap] validity arrays of the probe
// keys. lo: int32[pcap]; count: int32[pcap] and total: int64[2], unused
// (may be NULL) when lower_only. Capacities below 2^31. Returns 0 or the
// CUDA error.
int join_probe(const void* build, long long bcap, long long lane_stride,
               int row_stride, const void* n_build, long long n_build_value,
               const void* probe, long long pcap, int nl,
               const void* const* valid, int nkeys, const void* n_probe,
               long long n_probe_value, void* lo, void* count, void* total,
               int lower_only, void* stream) {
  const long long kMax = 0x7fffffffll;
  if (nl < 1 || nl > MAX_LANES || nkeys < 0 || nkeys > MAX_PROBE_KEYS ||
      pcap < 1 || pcap > kMax || bcap < 1 || bcap > kMax ||
      !((lane_stride == bcap && row_stride == 1) ||
        (lane_stride == 1 && row_stride == nl)) ||
      n_build_value < 0 || n_build_value > bcap || n_probe_value < 0 ||
      n_probe_value > kMax || lo == nullptr ||
      (!lower_only && (count == nullptr || total == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.build = (const long long*)build;
  a.lane_stride = lane_stride;
  a.row_stride = row_stride;
  a.n_build_ptr = (const int*)n_build;
  a.n_build_value = (int)n_build_value;
  a.probe = (const long long*)probe;
  a.pcap = (int)pcap;
  a.nl = nl;
  a.vt.n = nkeys;
  for (int k = 0; k < MAX_PROBE_KEYS; ++k)
    a.vt.v[k] = k < nkeys ? (const uint8_t*)valid[k] : nullptr;
  a.n_probe_ptr = (const int*)n_probe;
  a.n_probe_value = (int)n_probe_value;
  a.lo = (int*)lo;
  a.count = (int*)count;
  a.total = (unsigned long long*)total;
  cudaStream_t s = (cudaStream_t)stream;
  if (lower_only) return (int)dispatch<true>(a, s);
  cudaError_t e = cudaMemsetAsync(total, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<false>(a, s);
}

}  // extern "C"
