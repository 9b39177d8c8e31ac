// K8 dense_stats: the statistics that decide the dense-range group-by, in
// one pass over the rows.
//
// Replaces spark_rapids_tpu/ops/aggregates.py:dense_key_stats (B2). For the
// live rows (i < n, i < *nrows when given, live[i] when given) it computes
//   rmin[1]           the least non-NULL key as int64 (0 when there is none);
//   decision[2 + nf]  f64 [span, n_usable, absmax of each float column],
//                     span = (double)kmax - (double)kmin (0 when no key is
//                     usable), absmax over the live, valid, non-NaN values
//                     (0 when there is none).
// Both come out with the same bits as the JAX function: integer min, max
// and count are exact, and the f64 max of |x| does not depend on order.
//
// Bound on the card: bytes. Each input byte is read once (key 1-8 bytes,
// key validity, live mask, and data plus validity of each float column);
// the arithmetic is a compare or two per value. Design: K1's fixed
// two-level tree. Launch 1 runs a fixed grid of blocks, each thread
// striding over the rows with coalesced loads into private min, max, count
// and absmax; a shared-memory tree per block writes one partial per block.
// Launch 2 (one block) folds the partials. No atomics.
#include "agg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 1024;
constexpr long long kRowsPerPart = 8192;
constexpr int kMaxFloat = 2;  // per launch, so the maxima stay in registers

struct FloatCol {
  const void* data;
  const uint8_t* valid;
  int is_f64;
  int pad;
};

// Passed to the kernels by value: no descriptor needs a device copy.
struct FloatCols {
  FloatCol c[kMaxFloat];
};

int num_parts(long long n) {
  long long p = (n + kRowsPerPart - 1) / kRowsPerPart;
  if (p < 1) p = 1;
  if (p > kMaxParts) p = kMaxParts;
  return (int)p;
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// One partial is 3 + nf words: min, max, usable count, absmax bits...
template <typename K>
__global__ void __launch_bounds__(kThreads)
stats_partial(const K* key, const uint8_t* kvalid, const uint8_t* live,
              const int* nrows, long long n, FloatCols fc, int nf,
              long long* parts) {
  __shared__ long long smin[kThreads];
  __shared__ long long smax[kThreads];
  __shared__ long long scnt[kThreads];
  __shared__ double sabs[kMaxFloat][kThreads];
  long long mn = LLONG_MAX, mx = LLONG_MIN, cnt = 0;
  double am[kMaxFloat];
#pragma unroll
  for (int f = 0; f < kMaxFloat; ++f) am[f] = 0.0;
  long long lim = n;
  if (nrows != nullptr && (long long)*nrows < lim) lim = (long long)*nrows;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < lim;
       i += stride) {
    if (live != nullptr && live[i] == 0) continue;
    if (kvalid[i] != 0) {
      const long long k = (long long)key[i];
      mn = lmin(mn, k);
      mx = lmax(mx, k);
      cnt += 1;
    }
#pragma unroll
    for (int f = 0; f < kMaxFloat; ++f) {
      if (f < nf && fc.c[f].valid[i] != 0) {
        const double a = fc.c[f].is_f64
                             ? fabs(((const double*)fc.c[f].data)[i])
                             : (double)fabsf(((const float*)fc.c[f].data)[i]);
        if (!isnan(a) && a > am[f]) am[f] = a;
      }
    }
  }
  smin[threadIdx.x] = mn;
  smax[threadIdx.x] = mx;
  scnt[threadIdx.x] = cnt;
#pragma unroll
  for (int f = 0; f < kMaxFloat; ++f) sabs[f][threadIdx.x] = am[f];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    const int t = threadIdx.x;
    if (t < s) {
      smin[t] = lmin(smin[t], smin[t + s]);
      smax[t] = lmax(smax[t], smax[t + s]);
      scnt[t] += scnt[t + s];
#pragma unroll
      for (int f = 0; f < kMaxFloat; ++f)
        sabs[f][t] = fmax(sabs[f][t], sabs[f][t + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    long long* p = parts + (long long)blockIdx.x * (3 + nf);
    p[0] = smin[0];
    p[1] = smax[0];
    p[2] = scnt[0];
#pragma unroll
    for (int f = 0; f < kMaxFloat; ++f)
      if (f < nf) p[3 + f] = __double_as_longlong(sabs[f][0]);
  }
}

__global__ void stats_final(const long long* parts, int nparts, int nf,
                            long long* rmin, double* decision) {
  __shared__ long long smin[kThreads];
  __shared__ long long smax[kThreads];
  __shared__ long long scnt[kThreads];
  __shared__ double sabs[kMaxFloat][kThreads];
  long long mn = LLONG_MAX, mx = LLONG_MIN, cnt = 0;
  double am[kMaxFloat];
#pragma unroll
  for (int f = 0; f < kMaxFloat; ++f) am[f] = 0.0;
  for (int p = threadIdx.x; p < nparts; p += kThreads) {
    const long long* q = parts + (long long)p * (3 + nf);
    mn = lmin(mn, q[0]);
    mx = lmax(mx, q[1]);
    cnt += q[2];
#pragma unroll
    for (int f = 0; f < kMaxFloat; ++f)
      if (f < nf) am[f] = fmax(am[f], __longlong_as_double(q[3 + f]));
  }
  smin[threadIdx.x] = mn;
  smax[threadIdx.x] = mx;
  scnt[threadIdx.x] = cnt;
#pragma unroll
  for (int f = 0; f < kMaxFloat; ++f) sabs[f][threadIdx.x] = am[f];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    const int t = threadIdx.x;
    if (t < s) {
      smin[t] = lmin(smin[t], smin[t + s]);
      smax[t] = lmax(smax[t], smax[t + s]);
      scnt[t] += scnt[t + s];
#pragma unroll
      for (int f = 0; f < kMaxFloat; ++f)
        sabs[f][t] = fmax(sabs[f][t], sabs[f][t + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool any = scnt[0] > 0;
    rmin[0] = any ? smin[0] : 0;
    decision[0] = any ? (double)smax[0] - (double)smin[0] : 0.0;
    decision[1] = (double)scnt[0];
#pragma unroll
    for (int f = 0; f < kMaxFloat; ++f)
      if (f < nf) decision[2 + f] = sabs[f][0];
  }
}

template <typename K>
int launch(const void* key, const void* kvalid, const void* live,
           const void* nrows, long long n, const FloatCols& fc, int nf,
           void* scratch, void* rmin, void* decision, cudaStream_t s) {
  const int nparts = num_parts(n);
  stats_partial<K><<<nparts, kThreads, 0, s>>>(
      (const K*)key, (const uint8_t*)kvalid, (const uint8_t*)live,
      (const int*)nrows, n, fc, nf, (long long*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_final<<<1, kThreads, 0, s>>>((const long long*)scratch, nparts, nf,
                                     (long long*)rmin, (double*)decision);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_stats_max_float_cols() { return kMaxFloat; }

// Bytes of scratch dense_stats needs for n rows and nf float columns.
long long dense_stats_scratch_bytes(long long n, int nf) {
  return (long long)num_parts(n) * (3 + nf) * (long long)sizeof(long long);
}

// key_dcode: D_I8 (also bool), D_I16, D_I32 or D_I64. float_data,
// float_valid, float_is_f64: nf (<= 2) float aggregate columns; the
// wrapper makes one call per two columns. live and nrows (int32[1] on the
// device) may be null. Returns 0 or the CUDA error.
int dense_stats(int key_dcode, const void* key, const void* kvalid,
                const void* live, const void* nrows, long long n,
                const void* const* float_data, const void* const* float_valid,
                const int* float_is_f64, int nf, void* scratch, void* rmin,
                void* decision, void* stream) {
  if (nf < 0 || nf > kMaxFloat) return (int)cudaErrorInvalidValue;
  FloatCols fc;
  for (int f = 0; f < kMaxFloat; ++f) {
    fc.c[f].data = f < nf ? float_data[f] : nullptr;
    fc.c[f].valid = f < nf ? (const uint8_t*)float_valid[f] : nullptr;
    fc.c[f].is_f64 = f < nf ? float_is_f64[f] : 0;
    fc.c[f].pad = 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (key_dcode) {
    case D_I8: return launch<int8_t>(key, kvalid, live, nrows, n, fc, nf, scratch, rmin, decision, s);
    case D_I16: return launch<int16_t>(key, kvalid, live, nrows, n, fc, nf, scratch, rmin, decision, s);
    case D_I32: return launch<int32_t>(key, kvalid, live, nrows, n, fc, nf, scratch, rmin, decision, s);
    case D_I64: return launch<long long>(key, kvalid, live, nrows, n, fc, nf, scratch, rmin, decision, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
