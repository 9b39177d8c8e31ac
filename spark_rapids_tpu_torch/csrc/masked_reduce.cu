// K1 masked_reduce: grouping-free aggregate of the live rows of one column.
//
// Replaces spark_rapids_tpu/ops/aggregates.py:reduce_aggregate (which runs
// segment_aggregate over one segment). Computes COUNT(*), COUNT, SUM, AVG,
// MIN, MAX, FIRST or LAST of data[i] over rows with live[i] (and valid[i]
// where the op skips NULLs) into slot 0 of an out_slots-slot column; slots
// 1.. are zeroed and invalid. Empty input gives count 0 (valid) and NULL for
// everything else.
//
// Bound on the card: bytes. Every input byte is read once (data, validity,
// live mask: 10 bytes a row for f64) and the arithmetic is one add or
// compare per row, far below the H100's ratio of operations to bandwidth.
// Design: launch 1 runs a fixed grid of blocks, each thread striding over
// the rows with coalesced loads into a private accumulator, then a fixed
// shared-memory tree per block writes one partial per block to scratch.
// Launch 2 (one block) folds the partials in block order and writes the
// result. No atomics: the same input gives the same bits on every run.
// Launch 2 is also an entry of its own, masked_reduce_fold: the generated
// K20 fused_reduce (plan/stage_codegen.py) writes these same partials, on
// this grid and tree, for every aggregate of a stage in one launch.
#include "agg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 1024;
constexpr long long kRowsPerPart = 4096;

int num_parts(long long n) {
  long long p = (n + kRowsPerPart - 1) / kRowsPerPart;
  if (p < 1) p = 1;
  if (p > kMaxParts) p = kMaxParts;
  return (int)p;
}

template <int OP, typename T>
__device__ __forceinline__ void block_tree(Acc* sh, Acc mine) {
  sh[threadIdx.x] = mine;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) acc_combine<OP, T>(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
}

template <int OP, typename T>
__global__ void partial_kernel(const T* data, const uint8_t* valid,
                               const uint8_t* live, long long n,
                               int ignore_nulls, Acc* parts) {
  __shared__ Acc sh[kThreads];
  Acc a = acc_identity<OP, T>();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    acc_update<OP, T>(a, data, valid, i, live[i] != 0, ignore_nulls);
  }
  block_tree<OP, T>(sh, a);
  if (threadIdx.x == 0) parts[blockIdx.x] = sh[0];
}

template <int OP, typename T>
__global__ void final_kernel(const T* data, const uint8_t* valid,
                             const Acc* parts, int nparts, void* out,
                             uint8_t* out_valid, int out_slots) {
  __shared__ Acc sh[kThreads];
  Acc a = acc_identity<OP, T>();
  // thread t folds parts t, t + 256, ...; the tree then combines threads in
  // index order. Both are fixed by nparts alone.
  for (int p = threadIdx.x; p < nparts; p += kThreads) acc_combine<OP, T>(a, parts[p]);
  block_tree<OP, T>(sh, a);
  typedef typename OutType<OP, T>::type O;
  for (int s = threadIdx.x; s < out_slots; s += kThreads) {
    if (s == 0) {
      acc_write<OP, T>(sh[0], data, valid, out, out_valid, 0, true);
    } else {
      ((O*)out)[s] = (O)0;
      out_valid[s] = 0;
    }
  }
}

template <int OP, typename T>
struct Launch {
  static int run(const void* data, const void* valid, const void* live,
                 long long n, int ignore_nulls, void* parts, int nparts,
                 void* out, void* out_valid, int out_slots,
                 cudaStream_t stream) {
    partial_kernel<OP, T><<<nparts, kThreads, 0, stream>>>(
        (const T*)data, (const uint8_t*)valid, (const uint8_t*)live, n,
        ignore_nulls, (Acc*)parts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    final_kernel<OP, T><<<1, kThreads, 0, stream>>>(
        (const T*)data, (const uint8_t*)valid, (const Acc*)parts, nparts, out,
        (uint8_t*)out_valid, out_slots);
    return (int)cudaGetLastError();
  }
};

template <int OP, typename T>
struct Fold {
  static int run(const void* data, const void* valid, const void* parts,
                 int nparts, void* out, void* out_valid, int out_slots,
                 cudaStream_t stream) {
    final_kernel<OP, T><<<1, kThreads, 0, stream>>>(
        (const T*)data, (const uint8_t*)valid, (const Acc*)parts, nparts, out,
        (uint8_t*)out_valid, out_slots);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Partials (blocks of launch 1) masked_reduce uses for n rows.
int masked_reduce_num_parts(long long n) { return num_parts(n); }

// Launch 2 alone: fold nparts partials (sizeof(Acc) == 32 bytes each) into
// slot 0 of out. data/valid are the input column, read by FIRST/LAST only.
int masked_reduce_fold(int op, int dcode, const void* data, const void* valid,
                       const void* parts, int nparts, void* out,
                       void* out_valid, int out_slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  AGG_DISPATCH(op, dcode, Fold, data, valid, parts, nparts, out, out_valid,
               out_slots, s)
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch masked_reduce needs for n rows.
long long masked_reduce_scratch_bytes(long long n) {
  return (long long)num_parts(n) * (long long)sizeof(Acc);
}

// Returns 0 or the CUDA error of the launch.
static_assert(sizeof(Acc) == 32, "the generated partials' layout");

int masked_reduce(int op, int dcode, const void* data, const void* valid,
                  const void* live, long long n, int ignore_nulls,
                  void* scratch, void* out, void* out_valid, int out_slots,
                  void* stream) {
  const int nparts = num_parts(n);
  cudaStream_t s = (cudaStream_t)stream;
  AGG_DISPATCH(op, dcode, Launch, data, valid, live, n, ignore_nulls, scratch,
               nparts, out, out_valid, out_slots, s)
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
