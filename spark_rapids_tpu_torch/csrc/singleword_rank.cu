// K10 singleword_rank: each row's group id for the single-word group-by.
//
// Replaces the per-row compare-reduce of
// spark_rapids_tpu/ops/aggregates.py:groupby_singleword (B3), which counts
// for every row the distinct keys below its key, sum over g of
// [uniq_g < key_i], chunk by chunk. Over sorted distinct keys that count is
// a lower-bound search, so here each row does a binary search:
//   live, non-NULL key  -> number of uniq[0..n_uniq) below the key;
//   live, NULL key      -> null_slot (the NULL group, after every key);
//   dead row            -> dead_slot.
// The result is bit-exact: the same integers as the compare-reduce.
//
// Bound on the card: bytes (key, validity and live mask read, an int32
// written: 13 bytes a row for an int64 key); the search is 12 steps over at
// most 4096 keys. Design: every block loads the distinct keys (at most
// 32 KB) into shared memory once, then each thread searches its rows there,
// so the search never reads device memory.
#include "agg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUniq = 4096;
constexpr int kMaxBlocks = 1024;

template <typename K>
__global__ void rank_kernel(const K* key, const uint8_t* kvalid,
                            const uint8_t* live, const int* nrows, long long n,
                            const long long* uniq, int n_uniq, int null_slot,
                            int dead_slot, int* out) {
  __shared__ long long su[kMaxUniq];
  for (int j = threadIdx.x; j < n_uniq; j += kThreads) su[j] = uniq[j];
  __syncthreads();
  long long lim = n;
  if (nrows != nullptr && (long long)*nrows < lim) lim = (long long)*nrows;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int r;
    if (i >= lim || (live != nullptr && live[i] == 0)) {
      r = dead_slot;
    } else if (kvalid[i] == 0) {
      r = null_slot;
    } else {
      const long long k = (long long)key[i];
      int lo = 0, hi = n_uniq;  // first index whose key is >= k
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (su[mid] < k) lo = mid + 1; else hi = mid;
      }
      r = lo;
    }
    out[i] = r;
  }
}

template <typename K>
int launch(const void* key, const void* kvalid, const void* live,
           const void* nrows, long long n, const void* uniq, int n_uniq,
           int null_slot, int dead_slot, void* out, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rank_kernel<K><<<(int)blocks, kThreads, 0, s>>>(
      (const K*)key, (const uint8_t*)kvalid, (const uint8_t*)live,
      (const int*)nrows, n, (const long long*)uniq, n_uniq, null_slot,
      dead_slot, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// key_dcode: D_I8 (also bool), D_I16, D_I32 or D_I64; uniq: n_uniq
// (<= 4096) sorted distinct int64 keys; live and nrows (int32[1]) may be
// null. Writes int32 out[n]. Returns 0 or the CUDA error.
int singleword_rank(int key_dcode, const void* key, const void* kvalid,
                    const void* live, const void* nrows, long long n,
                    const void* uniq, int n_uniq, int null_slot,
                    int dead_slot, void* out, void* stream) {
  if (n_uniq < 0 || n_uniq > kMaxUniq) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (key_dcode) {
    case D_I8: return launch<int8_t>(key, kvalid, live, nrows, n, uniq, n_uniq, null_slot, dead_slot, out, s);
    case D_I16: return launch<int16_t>(key, kvalid, live, nrows, n, uniq, n_uniq, null_slot, dead_slot, out, s);
    case D_I32: return launch<int32_t>(key, kvalid, live, nrows, n, uniq, n_uniq, null_slot, dead_slot, out, s);
    case D_I64: return launch<long long>(key, kvalid, live, nrows, n, uniq, n_uniq, null_slot, dead_slot, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
