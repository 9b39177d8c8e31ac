// Shared by K29 (exchange_bucket.cu) and K30 (exchange_flatten.cu): the
// payload array descriptor, the launch limits and the block-wide prefix sum
// of the n slot counts.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace exch {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 32;
constexpr int kMaxWorkers = 1024;
constexpr int kPerThread = kMaxWorkers / kThreads;

// One payload array: rows of row_bytes bytes, moved in units of `unit`
// bytes (1, 2, 4 or 8; it divides row_bytes and both pointers' alignment).
struct Array {
  const void* src;
  void* dst;
  long long row_bytes;
  int unit;
  int pad;
};

struct Table {
  int k;
  Array a[kMaxArrays];
};

inline bool valid_array(const Array& a) {
  return (a.unit == 1 || a.unit == 2 || a.unit == 4 || a.unit == 8) &&
         a.row_bytes >= 1 && a.row_bytes % a.unit == 0 &&
         (uintptr_t)a.src % a.unit == 0 && (uintptr_t)a.dst % a.unit == 0;
}

// incl[t] = counts[0] + ... + counts[t] for t < n (n <= kMaxWorkers), in
// shared memory, by every thread of the block (Hillis-Steele: log2 n
// rounds, each thread kPerThread entries). Every thread must call it.
__device__ __forceinline__ void inclusive_counts(const int* counts, int n,
                                                 int* incl) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) incl[i] = counts[i];
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    int v[kPerThread];
    int j = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x, ++j)
      v[j] = i >= off ? incl[i - off] : 0;
    __syncthreads();
    j = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x, ++j) incl[i] += v[j];
    __syncthreads();
  }
}

}  // namespace exch
