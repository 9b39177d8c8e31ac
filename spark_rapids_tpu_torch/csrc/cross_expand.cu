// K15 cross_expand: the (left row, right row) pair of every output slot of
// a cross join.
//
// Replaces spark_rapids_tpu/ops/joins.py:cross_join_gather's index half
// (241-258, B12). With n_left and n_right passed by value, for every slot
// i < out_cap:
//   li[i] = i / n_right, ri[i] = i % n_right   when i < n_left * n_right,
//   li[i] = ri[i] = 0                          otherwise (the caller masks),
// and total[0] = n_left * n_right. The product is kept in int64 (the
// reference narrows it to int32); n_right == 0 gives no live slot.
//
// Bound on the card: bytes (16 bytes an output slot written). At the main
// path's sizes (2^14-2^19 slots) the work is a few microseconds, so the
// design takes out what is not the writes:
//   - the counts come by value: no host -> device copy, no synchronize;
//   - no division below 2^32 slots: i / n_right is a multiply-high by a
//     32-bit round-up multiplier and a shift, worked out on the host
//     (ops/joins.py:_fast_divisor), with an add-and-halve step for the
//     divisors whose multiplier needs 33 bits; n_right == 1 is a copy;
//     past 2^32 slots a 64-bit division branch of the same kernel;
//   - each thread writes two neighbouring slots of each output with one
//     16-byte store, grid-stride over a grid sized to the card (the
//     capacity is even: the engine's are powers of two of at least 128).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Divisor {
  unsigned magic;
  int shift;
  int add;
};

// (i / n_right, i % n_right) of a live slot below 2^32.
__device__ __forceinline__ void split32(unsigned i, unsigned nr, Divisor d,
                                        long long& l, long long& r) {
  unsigned q = i;
  if (nr != 1) {
    const unsigned h = __umulhi(i, d.magic);
    q = (d.add ? h + ((i - h) >> 1) : h) >> d.shift;
  }
  l = q;
  r = i - q * nr;
}

// Idx: unsigned below 2^32 slots (the multiply-high), long long past it.
// Thread p writes slots 2p and 2p + 1 of each output with one 16-byte
// store (the capacity is even).
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cross_kernel(long long n_left, long long n_right, Idx out_cap, Divisor d,
             long long* __restrict__ li, long long* __restrict__ ri,
             long long* total) {
  const long long t = n_left * n_right;
  const Idx pairs = out_cap / 2;
  const Idx first = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (first == 0) *total = t;
  const Idx step = (Idx)gridDim.x * kThreads;
  for (Idx p = first; p < pairs; p += step) {
    longlong2 l = make_longlong2(0, 0), r = make_longlong2(0, 0);
    const Idx i = 2 * p;
    if constexpr (sizeof(Idx) == 4) {
      if ((long long)i < t)
        split32((unsigned)i, (unsigned)n_right, d, l.x, r.x);
      if ((long long)i + 1 < t)
        split32((unsigned)i + 1, (unsigned)n_right, d, l.y, r.y);
    } else {
      if ((long long)i < t) {
        l.x = (long long)i / n_right;
        r.x = (long long)i - l.x * n_right;
      }
      if ((long long)i + 1 < t) {
        l.y = ((long long)i + 1) / n_right;
        r.y = (long long)i + 1 - l.y * n_right;
      }
    }
    reinterpret_cast<longlong2*>(li)[p] = l;
    reinterpret_cast<longlong2*>(ri)[p] = r;
  }
}

}  // namespace

extern "C" {

// li, ri: int64[out_cap], each 16-byte aligned, out_cap even; total:
// int64[1]. divisor: K15's round-up divisor of n_right, magic | shift << 32
// | add << 40 (used below 2^32 slots with n_right in [2, 2^32)). Returns 0
// or the CUDA error of the launch.
int cross_expand(long long n_left, long long n_right, long long out_cap,
                 unsigned long long divisor, long long* li, long long* ri,
                 long long* total, void* stream) {
  const Divisor d{(unsigned)divisor, (int)((divisor >> 32) & 0xff),
                  (int)((divisor >> 40) & 1)};
  if (out_cap < 2 || out_cap % 2 != 0 || n_left < 0 || n_right < 0 ||
      d.shift > 31 || ((uintptr_t)li % 16) != 0 ||
      ((uintptr_t)ri % 16) != 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = (long long)kBlocksPerSm * launch::sm_count();
  const long long need = (out_cap / 2 + kThreads - 1) / kThreads;
  if (need < blocks) blocks = need;
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = out_cap < (1ll << 32) && n_right < (1ll << 32);
  if (narrow && n_right > 1 && d.magic == 0)
    return (int)cudaErrorInvalidValue;
  if (narrow)
    cross_kernel<unsigned><<<(unsigned)blocks, kThreads, 0, s>>>(
        n_left, n_right, (unsigned)out_cap, d, li, ri, total);
  else
    cross_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        n_left, n_right, out_cap, d, li, ri, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
