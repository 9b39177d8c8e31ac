// K15 cross_expand: the (left row, right row) pair of every output slot of
// a cross join.
//
// Replaces spark_rapids_tpu/ops/joins.py:cross_join_gather's index half
// (241-258, B12). With n_left and n_right read from the device, for every
// slot i < out_cap:
//   li[i] = i / n_right, ri[i] = i % n_right   when i < n_left * n_right,
//   li[i] = ri[i] = 0                          otherwise (the caller masks),
// and total[0] = n_left * n_right. The product is kept in int64 (the
// reference narrows it to int32); n_right == 0 gives no live slot.
//
// Bound on the card: bytes (16 bytes an output slot written). Design: one
// thread per output slot, one 64-bit division each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void cross_kernel(const int* n_left, const int* n_right,
                             long long out_cap, long long* li, long long* ri,
                             long long* total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nr = (long long)*n_right;
  const long long t = (long long)*n_left * nr;
  if (i == 0) *total = t;
  if (i >= out_cap) return;
  if (i < t) {
    li[i] = i / nr;
    ri[i] = i % nr;
  } else {
    li[i] = 0;
    ri[i] = 0;
  }
}

}  // namespace

extern "C" {

// n_left, n_right: int32[1] on the device; li, ri: int64[out_cap]; total:
// int64[1]. Returns 0 or the CUDA error of the launch.
int cross_expand(const void* n_left, const void* n_right, long long out_cap,
                 void* li, void* ri, void* total, void* stream) {
  if (out_cap < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (out_cap + kThreads - 1) / kThreads;
  cross_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)n_left, (const int*)n_right, out_cap, (long long*)li,
      (long long*)ri, (long long*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
