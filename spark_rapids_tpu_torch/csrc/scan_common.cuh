// Block and grid scans shared by compact_scan.cu (K5) and join_expand.cu
// (K7); block sums for other kernels (K6's totals among them).
//
// A grid scan runs in three launches and no atomics, as K3's does: a
// per-row pass reduces each block of kThreads rows to one total, one block
// of kTotalsThreads threads turns the block totals into exclusive offsets
// (scan_totals_kernel), and a second per-row pass scans each block with
// block_inclusive_scan and adds its offset. The result is the same from
// run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 256;         // threads of a per-row pass
constexpr int kTotalsThreads = 1024;  // threads of the one totals block

inline int num_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b);
}

// Inclusive scan of x over the block (blockDim.x == Threads, a multiple of
// 32 up to 1024). Every thread gets its inclusive prefix; *block_total,
// when given, gets the block's sum in every thread. Holds static shared
// memory: two calls in one kernel need a __syncthreads() between them.
template <typename T, int Threads = kThreads>
__device__ __forceinline__ T block_inclusive_scan(T x, T* block_total) {
  constexpr int kWarps = Threads / 32;
  __shared__ T warp_tot[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T t = lane < kWarps ? warp_tot[lane] : T(0);
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kWarps) warp_tot[lane] = t;  // inclusive warp totals
  }
  __syncthreads();
  if (block_total != nullptr) *block_total = warp_tot[kWarps - 1];
  return x + (warp > 0 ? warp_tot[warp - 1] : T(0));
}

// Sum of x over the block, in every thread.
template <typename T, int Threads = kThreads>
__device__ __forceinline__ T block_sum(T x) {
  T total;
  block_inclusive_scan<T, Threads>(x, &total);
  return total;
}

// Exclusive scan of totals[0..nb) in place by one block of kTotalsThreads
// threads; *grand_total gets the sum.
template <typename T>
__global__ void scan_totals_kernel(T* totals, int nb, T* grand_total) {
  __shared__ T sh[kTotalsThreads];
  const int per = (nb + kTotalsThreads - 1) / kTotalsThreads;
  const int b0 = threadIdx.x * per;
  T local = 0;
  for (int b = b0; b < b0 + per && b < nb; ++b) local += totals[b];
  sh[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < kTotalsThreads; off <<= 1) {
    const T add = threadIdx.x >= off ? sh[threadIdx.x - off] : T(0);
    __syncthreads();
    sh[threadIdx.x] += add;
    __syncthreads();
  }
  T run = sh[threadIdx.x] - local;  // exclusive prefix of this thread
  for (int b = b0; b < b0 + per && b < nb; ++b) {
    const T c = totals[b];
    totals[b] = run;
    run += c;
  }
  if (threadIdx.x == kTotalsThreads - 1) *grand_total = sh[kTotalsThreads - 1];
}

}  // namespace scan
