// Value access shared by segmented_scan.cu (K22) and frame_aggregate.cu
// (K24): typed loads and stores, and the order keys MIN and MAX compare.
//
// MIN and MAX work on an int64 order key: the value itself for an integer,
// for a float its bits mapped so that signed comparison is the total order
// -inf < ... < -0.0 < 0.0 < ... < inf < NaN (Spark's: NaN is the largest
// value; every NaN is one key, written back as the canonical NaN). Equal
// keys are equal bits, so the extreme is the same whatever order the
// combines run in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace win {

// The aggregate codes of ops/aggregates.py _OPS.
enum Op { COUNT_STAR = 0, COUNT = 1, SUM = 2, AVG = 3, MIN = 4, MAX = 5 };

// Storage codes of ops/aggregates.py _DCODES.
enum DCode { D_I8 = 0, D_I16 = 1, D_I32 = 2, D_I64 = 3, D_F32 = 4, D_F64 = 5 };

constexpr long long kCanonicalNaN = 0x7FF8000000000000LL;
constexpr long long kLow63 = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kMinKey = (long long)0x8000000000000000ULL;

__host__ __device__ __forceinline__ bool is_float(int dcode) {
  return dcode >= D_F32;
}

__device__ __forceinline__ long long load_int(const void* p, int dcode,
                                              long long i) {
  switch (dcode) {
    case D_I8: return (long long)((const int8_t*)p)[i];
    case D_I16: return (long long)((const int16_t*)p)[i];
    case D_I32: return (long long)((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ double load_float(const void* p, int dcode,
                                             long long i) {
  return dcode == D_F32 ? (double)((const float*)p)[i]
                        : ((const double*)p)[i];
}

__device__ __forceinline__ long long order_key(const void* p, int dcode,
                                               long long i) {
  if (!is_float(dcode)) return load_int(p, dcode, i);
  const double d = load_float(p, dcode, i);
  if (isnan(d)) return kCanonicalNaN;
  const long long b = __double_as_longlong(d);
  return b >= 0 ? b : b ^ kLow63;
}

// Writes the value of order key k as dcode's type at out[i].
__device__ __forceinline__ void store_key(void* out, int dcode, long long i,
                                          long long k) {
  if (is_float(dcode)) {
    const double d = __longlong_as_double(k >= 0 ? k : k ^ kLow63);
    if (dcode == D_F32) ((float*)out)[i] = (float)d;
    else ((double*)out)[i] = d;
    return;
  }
  switch (dcode) {
    case D_I8: ((int8_t*)out)[i] = (int8_t)k; break;
    case D_I16: ((int16_t*)out)[i] = (int16_t)k; break;
    case D_I32: ((int32_t*)out)[i] = (int32_t)k; break;
    default: ((long long*)out)[i] = k;
  }
}

// Zero of dcode's type at out[i].
__device__ __forceinline__ void store_zero(void* out, int dcode,
                                           long long i) {
  switch (dcode) {
    case D_I8: ((int8_t*)out)[i] = 0; break;
    case D_I16: ((int16_t*)out)[i] = 0; break;
    case D_I32: ((int32_t*)out)[i] = 0; break;
    case D_F32: ((float*)out)[i] = 0.0f; break;
    case D_F64: ((double*)out)[i] = 0.0; break;
    default: ((long long*)out)[i] = 0;
  }
}

// The better of two order keys, a from the earlier rows (kept on a tie).
__device__ __forceinline__ long long best(int op, long long a, long long b) {
  return op == MIN ? (b < a ? b : a) : (b > a ? b : a);
}

__device__ __forceinline__ long long key_identity(int op) {
  return op == MIN ? kMaxKey : kMinKey;
}

// Two's-complement (wrapping) int64 addition, as Spark's long sum.
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

}  // namespace win
