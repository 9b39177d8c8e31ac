// K29 exchange_bucket: pack a worker's rows into [n, cap] slots by target
// worker, the send side of the mesh's all_to_all.
//
// Replaces spark_rapids_tpu/parallel/mesh.py:bucket_rows_for_exchange 129
// (B18), which runs one compaction, one gather and one where per target
// worker and payload array. Here K12 (csrc/partition_split.cu) first orders
// the rows stably by target (dead rows last) and counts each target's rows;
// this kernel then places every payload array in one launch per block of
// up to kMaxArrays arrays:
//   dst[t, j] = src[perm[start(t) + j]]   for j < counts[t]
//   dst[t, j] = 0                         otherwise
// with start(t) the exclusive prefix of counts. A row is row_bytes bytes (a
// fixed-width element of 1, 2, 4 or 8 bytes, a string's W bytes); each
// array moves in units of the widest of 8, 4, 2 or 1 bytes that divides its
// row and both its pointers' alignment. The output equals the reference
// bit for bit, its zero padding included.
//
// Bound on the card: bytes (each live row's payload and its permutation
// entry read once, the n x cap slots of every array written once). A block
// takes the prefix of the n counts in shared memory, then walks the units
// of one slot (blockIdx.z) of one array (blockIdx.y) with a grid stride.
#include "exchange_common.cuh"

namespace {

using exch::kThreads;
constexpr int kBlocksPerSlot = 1024;

template <typename T>
__device__ __forceinline__ void place(const exch::Array& a,
                                      const long long* perm, long long n_t,
                                      long long s_t, long long cap) {
  const long long upr = a.row_bytes / (long long)sizeof(T);
  const long long units = cap * upr;          // units of one slot
  const T* src = (const T*)a.src;
  T* out = (T*)a.dst + (long long)blockIdx.z * units;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    // a row of one unit (every fixed-width array) needs no division
    const long long j = upr == 1 ? u : u / upr;
    const long long w = u - j * upr;
    T v = T(0);
    if (j < n_t) v = src[perm[s_t + j] * upr + w];
    out[u] = v;
  }
}

__global__ void bucket_kernel(exch::Table table, const long long* perm,
                              const int* counts, int n, long long cap) {
  __shared__ int incl[exch::kMaxWorkers];
  exch::inclusive_counts(counts, n, incl);
  const int t = blockIdx.z;                   // the target worker
  const long long n_t = counts[t];
  const long long s_t = t > 0 ? incl[t - 1] : 0;
  const exch::Array& a = table.a[blockIdx.y];
  switch (a.unit) {
    case 8: place<unsigned long long>(a, perm, n_t, s_t, cap); break;
    case 4: place<unsigned int>(a, perm, n_t, s_t, cap); break;
    case 2: place<unsigned short>(a, perm, n_t, s_t, cap); break;
    default: place<unsigned char>(a, perm, n_t, s_t, cap); break;
  }
}

}  // namespace

extern "C" {

int exchange_bucket_max_arrays() { return exch::kMaxArrays; }
int exchange_bucket_max_workers() { return exch::kMaxWorkers; }

// arrays: k descriptors (1 <= k <= kMaxArrays), src [cap, row], dst
// [n, cap, row]; perm: int64[cap], K12's stable order of the rows by target
// (dead rows last); counts: int32[n], the live rows of each target. Returns
// 0 or the CUDA error of the launch.
int exchange_bucket(const exch::Array* arrays, int k, const long long* perm,
                    const int* counts, int n, long long cap, void* stream) {
  if (k < 1 || k > exch::kMaxArrays || n < 1 || n > exch::kMaxWorkers ||
      cap < 1)
    return (int)cudaErrorInvalidValue;
  exch::Table t;
  t.k = k;
  long long most = 0;
  for (int i = 0; i < k; ++i) {
    if (!exch::valid_array(arrays[i])) return (int)cudaErrorInvalidValue;
    t.a[i] = arrays[i];
    const long long units = cap * (arrays[i].row_bytes / arrays[i].unit);
    if (units > most) most = units;
  }
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > kBlocksPerSlot) blocks = kBlocksPerSlot;
  // x: units of one slot; y: the array; z: the target worker
  dim3 grid((unsigned)blocks, (unsigned)k, (unsigned)n);
  bucket_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      t, perm, counts, n, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
