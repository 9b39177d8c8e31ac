// Key-column descriptors shared by sort_key_lanes.cu (K2) and
// segment_bounds.cu (K3). The host passes a small array of KeyDesc; the
// launcher copies it into a KeyTable passed to the kernel by value, so no
// descriptor ever needs a device allocation.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

enum KeyKind {
  K_INT = 0,     // signed integer of `width` bytes (int8..int64, date, timestamp)
  K_BOOL = 1,    // one byte, 0 or 1
  K_F32 = 2,
  K_F64 = 3,
  K_STRING = 4,  // uint8[rows, width] bytes plus int32 lengths
};

// Mirrored by ctypes in spark_rapids_tpu_torch/native.py (48 bytes).
struct KeyDesc {
  const void* data;
  const void* valid;    // uint8 (torch.bool)
  const void* lengths;  // int32, strings only
  int kind;
  int width;
  int len_bits;         // strings: bits of the length field
  int ascending;
  int nulls_first;
  int pad;
};

// Descriptors one call takes. The Python wrappers of K2, K3 and K11 split a
// longer key list into blocks of at most MAX_KEYS (ops/kernels.py MAX_KEYS)
// and combine the blocks' results.
#define MAX_KEYS 8

struct KeyTable {
  int n;
  KeyDesc k[MAX_KEYS];
};

__device__ __forceinline__ long long load_int(const void* p, int width,
                                              long long i) {
  switch (width) {
    case 1: return (long long)((const int8_t*)p)[i];
    case 2: return (long long)((const int16_t*)p)[i];
    case 4: return (long long)((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ double load_float(const KeyDesc& k, long long i) {
  return k.kind == K_F32 ? (double)((const float*)k.data)[i]
                         : ((const double*)k.data)[i];
}
