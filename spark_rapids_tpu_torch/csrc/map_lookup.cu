// K27 map_lookup: map[key] / element_at(map, key) on the MAP layout.
//
// Replaces spark_rapids_tpu/ops/maps.py:GetMapValue.eval (140), B17. A MAP
// column is an int64[n, 3W] matrix of interleaved [key bits, value bits,
// value valid] lanes and the entry counts. For every row r: the first lane
// j < lengths[r] whose key equals the lookup key (a scalar, or row r of a
// key column), compared as the reference compares it: in float64 when the
// map's key type or the lookup key's type is floating, else in int64 (1.5
// does not truncate to 1; a bigint key does not wrap on map<int,_>). The
// stored key is first narrowed to the map's key type, as the reference's
// _from_bits reads it. Then
//   out_valid[r] = map_valid[r] && key_valid[r] && found && value valid,
//   out[r] = the value's bits narrowed to the value type (float64 bits ->
//            float32 for a float value, int64 -> the integer type, != 0 for
//            a boolean) where out_valid[r], else 0.
//
// Bound on the card: bytes (each live row's lanes up to its match or its
// length, the lengths, validity and key read; the value and its validity
// written). Design: one thread per row walking its lanes with a stride of
// three int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// type codes of the wrapper (ops/maps.py _TYPE_CODE)
enum : int { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

__device__ __forceinline__ long long narrow_int(long long bits, int t) {
  switch (t) {
    case kBool: return bits != 0;
    case kI8: return (long long)(signed char)bits;
    case kI16: return (long long)(short)bits;
    case kI32: return (long long)(int)bits;
    default: return bits;
  }
}

__device__ __forceinline__ double stored_as_f64(long long bits, int t) {
  if (t == kF64) return __longlong_as_double(bits);
  if (t == kF32) return (double)(float)__longlong_as_double(bits);
  return (double)narrow_int(bits, t);
}

__device__ __forceinline__ long long load_int(const void* p, long long r,
                                              int t) {
  switch (t) {
    case kBool: return ((const unsigned char*)p)[r] != 0;
    case kI8: return ((const signed char*)p)[r];
    case kI16: return ((const short*)p)[r];
    case kI32: return ((const int*)p)[r];
    default: return ((const long long*)p)[r];
  }
}

__device__ __forceinline__ double load_f64(const void* p, long long r,
                                           int t) {
  if (t == kF64) return ((const double*)p)[r];
  if (t == kF32) return (double)((const float*)p)[r];
  return (double)load_int(p, r, t);
}

__global__ void lookup_kernel(const long long* mat, const int* lengths,
                              const bool* map_valid, long long n, int width,
                              int key_type, const void* key,
                              const bool* key_valid, int lookup_type,
                              long long scalar_i, double scalar_f,
                              int cmp_float, int value_type, void* out,
                              bool* out_valid) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  bool ok = map_valid[r] && (key == nullptr || key_valid[r]);
  long long bits = 0;
  if (ok) {
    const long long* row = mat + r * 3LL * width;
    const int len = lengths[r] < width ? lengths[r] : width;
    bool found = false;
    if (cmp_float) {
      const double k = key == nullptr ? scalar_f : load_f64(key, r,
                                                            lookup_type);
      for (int j = 0; j < len && !found; ++j)
        if (stored_as_f64(row[3 * j], key_type) == k) {
          found = true;
          bits = row[3 * j + 1];
          ok = row[3 * j + 2] != 0;
        }
    } else {
      const long long k = key == nullptr ? scalar_i : load_int(key, r,
                                                               lookup_type);
      for (int j = 0; j < len && !found; ++j)
        if (narrow_int(row[3 * j], key_type) == k) {
          found = true;
          bits = row[3 * j + 1];
          ok = row[3 * j + 2] != 0;
        }
    }
    ok = ok && found;
  }
  out_valid[r] = ok;
  if (!ok) bits = 0;
  switch (value_type) {
    case kBool: ((unsigned char*)out)[r] = bits != 0; break;
    case kI8: ((signed char*)out)[r] = (signed char)bits; break;
    case kI16: ((short*)out)[r] = (short)bits; break;
    case kI32: ((int*)out)[r] = (int)bits; break;
    case kF32:
      ((float*)out)[r] = ok ? (float)__longlong_as_double(bits) : 0.0f;
      break;
    default: ((long long*)out)[r] = bits; break;  // int64, float64 bits
  }
}

}  // namespace

extern "C" {

// mat: int64[n, 3 * width]; lengths int32, map_valid bool [n]; key: the
// lookup key column's data [n] of lookup_type (with key_valid bool[n]), or
// null for the scalar (scalar_i in integer compares, scalar_f in float
// ones); out [n] of value_type and out_valid bool[n] (written).
int map_lookup(const void* mat, const void* lengths, const void* map_valid,
               long long n, int width, int key_type, const void* key,
               const void* key_valid, int lookup_type, long long scalar_i,
               double scalar_f, int cmp_float, int value_type, void* out,
               void* out_valid, void* stream) {
  if (n < 1 || width < 1 || (key != nullptr && key_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  lookup_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const long long*)mat, (const int*)lengths, (const bool*)map_valid, n,
      width, key_type, key, (const bool*)key_valid, lookup_type, scalar_i,
      scalar_f, cmp_float, value_type, out, (bool*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
