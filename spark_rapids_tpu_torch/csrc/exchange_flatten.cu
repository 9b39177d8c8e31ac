// K30 exchange_flatten: the received [n, cap] slots of a worker, flattened
// into out_cap rows, the receive side of the mesh's all_to_all.
//
// Replaces spark_rapids_tpu/parallel/mesh.py:flatten_received 166 (B18),
// which builds a gather index with a cumsum and a searchsorted and then runs
// one gather and one where per payload array. For output row i < total
// (total = the sum of the n counts):
//   s   = upper_bound(incl, i)     the first slot whose inclusive prefix
//                                  of counts exceeds i (clipped to n - 1)
//   out[i] = src[s, i - excl[s]]   (the offset clipped to [0, cap - 1])
// and out[i] = 0 at and past total; total itself is written too. The n
// prefix sums live in shared memory, computed by every block; every
// payload array of the call is placed in one launch (blockIdx.y), each in
// units of the widest of 8, 4, 2 or 1 bytes that divides its row and its
// pointers' alignment. The output equals the reference bit for bit.
//
// Bound on the card: bytes (each received live row read once, the counts,
// out_cap rows of every array written once).
#include "exchange_common.cuh"

namespace {

using exch::kThreads;
constexpr int kMaxBlocks = 4096;

template <typename T>
__device__ __forceinline__ void place(const exch::Array& a, const int* incl,
                                      int n, long long cap, long long out_cap,
                                      long long total) {
  const long long upr = a.row_bytes / (long long)sizeof(T);
  const T* src = (const T*)a.src;
  T* dst = (T*)a.dst;
  const long long units = out_cap * upr;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    // a row of one unit (every fixed-width array) needs no division
    const long long i = upr == 1 ? u : u / upr;
    const long long w = u - i * upr;
    T v = T(0);
    if (i < total) {
      // upper bound: the first s with incl[s] > i
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((long long)incl[mid] > i) hi = mid; else lo = mid + 1;
      }
      const int s = lo < n ? lo : n - 1;
      long long off = i - (s > 0 ? (long long)incl[s - 1] : 0LL);
      off = off < 0 ? 0 : (off > cap - 1 ? cap - 1 : off);
      v = src[((long long)s * cap + off) * upr + w];
    }
    dst[u] = v;
  }
}

__global__ void flatten_kernel(exch::Table table, const int* counts, int n,
                               long long cap, long long out_cap,
                               int* total_out) {
  __shared__ int incl[exch::kMaxWorkers];
  exch::inclusive_counts(counts, n, incl);
  const long long total = incl[n - 1];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    *total_out = (int)total;
  if ((int)blockIdx.y >= table.k) return;
  const exch::Array& a = table.a[blockIdx.y];
  switch (a.unit) {
    case 8: place<unsigned long long>(a, incl, n, cap, out_cap, total); break;
    case 4: place<unsigned int>(a, incl, n, cap, out_cap, total); break;
    case 2: place<unsigned short>(a, incl, n, cap, out_cap, total); break;
    default: place<unsigned char>(a, incl, n, cap, out_cap, total); break;
  }
}

}  // namespace

extern "C" {

int exchange_flatten_max_arrays() { return exch::kMaxArrays; }

// arrays: k descriptors (0 <= k <= kMaxArrays; with none only the total is
// written), src [n, cap, row], dst [out_cap, row]; counts: int32[n], the
// live rows of each received slot; total_out: int32[1]. Returns 0 or the
// CUDA error of the launch.
int exchange_flatten(const exch::Array* arrays, int k, const int* counts,
                     int n, long long cap, long long out_cap, int* total_out,
                     void* stream) {
  if (k < 0 || k > exch::kMaxArrays || n < 1 || n > exch::kMaxWorkers ||
      cap < 1 || out_cap < 1)
    return (int)cudaErrorInvalidValue;
  exch::Table t;
  t.k = k;
  long long most = 1;
  for (int i = 0; i < k; ++i) {
    if (!exch::valid_array(arrays[i])) return (int)cudaErrorInvalidValue;
    t.a[i] = arrays[i];
    const long long units = out_cap * (arrays[i].row_bytes / arrays[i].unit);
    if (units > most) most = units;
  }
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dim3 grid((unsigned)blocks, (unsigned)(k > 0 ? k : 1));
  flatten_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      t, counts, n, cap, out_cap, total_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
