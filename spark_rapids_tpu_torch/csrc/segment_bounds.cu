// K3 segment_bounds: group boundaries, group ids and group heads of sorted
// key columns.
//
// Replaces spark_rapids_tpu/ops/kernels.py:segment_starts_from_sorted_keys,
// segment_ids (B8) and the start compaction groupby_aggregate runs through
// compaction_indices (B7). For rows sorted by the keys, with the live rows
// first (*n_live of them), it writes
//   starts[cap]   row i starts a group: live, and i == 0 or some key differs
//                 from row i - 1 (NULL equals NULL, NaN equals NaN, strings
//                 compare all bytes and the length);
//   seg_ids[cap]  inclusive scan of starts minus 1 (padding rows carry the
//                 last id);
//   n_groups[1]   the number of starts;
//   first_row[cap] the stable kept-first permutation of starts: group g's
//                 first row at g < n_groups, then the other rows in order
//                 (compaction_indices(starts)[0]).
//
// Bound on the card: bytes (the key columns read once, 1 + 4 + 4 bytes a row
// written). Design: three launches and no atomics. Launch 1 (one thread per
// row) compares each row with its predecessor and counts starts per block;
// launch 2 (one block) scans the block counts; launch 3 scans each block's
// starts with warp shuffles, adds the block offset and scatters the
// permutation. The scan is written here, not taken from a library.
//
// More than MAX_KEYS key columns come in blocks of descriptors, one call
// each: every call but the first `accumulate`s (a row already flagged stays
// a start, so a row starts a segment when any block differs from the row
// before), and only the last one `finish`es with launches 2 and 3.
#include "keys_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool key_changed(const KeyDesc& d, long long i) {
  const uint8_t* valid = (const uint8_t*)d.valid;
  const bool v = valid[i] != 0;
  const bool pv = valid[i - 1] != 0;
  if (v != pv) return true;
  if (!v) return false;  // both NULL: equal
  switch (d.kind) {
    case K_INT:
      return load_int(d.data, d.width, i) != load_int(d.data, d.width, i - 1);
    case K_BOOL:
      return ((const uint8_t*)d.data)[i] != ((const uint8_t*)d.data)[i - 1];
    case K_F32:
    case K_F64: {
      const double a = load_float(d, i);
      const double b = load_float(d, i - 1);
      return a != b && !(isnan(a) && isnan(b));
    }
    default: {  // K_STRING
      const int* len = (const int*)d.lengths;
      if (len[i] != len[i - 1]) return true;
      const uint8_t* s = (const uint8_t*)d.data;
      const long long w = d.width;
      for (long long j = 0; j < w; ++j)
        if (s[i * w + j] != s[(i - 1) * w + j]) return true;
      return false;
    }
  }
}

__global__ void flags_kernel(KeyTable kt, int accumulate, const int* n_live,
                             long long cap, uint8_t* starts,
                             int* block_counts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool start = false;
  if (i < cap && i < (long long)*n_live) {
    start = accumulate ? starts[i] != 0 : (i == 0);
    for (int k = 0; k < kt.n && !start; ++k) start = key_changed(kt.k[k], i);
  }
  if (i < cap) starts[i] = start ? 1 : 0;
  const int count = __syncthreads_count(start);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = count;
}

// Exclusive scan of counts[0..nb) in place; *total gets the sum.
__global__ void scan_kernel(int* counts, int nb, int* total) {
  __shared__ int sh[kScanThreads];
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = threadIdx.x * per;
  int local = 0;
  for (int b = b0; b < b0 + per && b < nb; ++b) local += counts[b];
  sh[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    sh[threadIdx.x] += add;
    __syncthreads();
  }
  int run = sh[threadIdx.x] - local;  // exclusive prefix of this thread
  for (int b = b0; b < b0 + per && b < nb; ++b) {
    const int c = counts[b];
    counts[b] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) *total = sh[kScanThreads - 1];
}

__global__ void ids_kernel(const uint8_t* starts, const int* offsets,
                           const int* n_groups, long long cap, int* seg_ids,
                           int* first_row) {
  __shared__ int warp_tot[kThreads / 32];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int s = (i < cap && starts[i]) ? 1 : 0;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int x = s;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kThreads / 32 ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t;  // inclusive warp totals
  }
  __syncthreads();
  if (i >= cap) return;
  const int incl = offsets[blockIdx.x] + (warp > 0 ? warp_tot[warp - 1] : 0) + x;
  seg_ids[i] = incl - 1;
  const long long ng = *n_groups;
  const long long pos = s ? (long long)incl - 1 : ng + (i + 1 - incl) - 1;
  first_row[pos] = (int)i;
}

int num_blocks(long long cap) {
  long long b = (cap + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// Bytes of scratch segment_bounds needs for cap rows.
long long segment_bounds_scratch_bytes(long long cap) {
  return (long long)num_blocks(cap) * (long long)sizeof(int);
}

// accumulate: OR this block of keys' starts into `starts` (a later block of
// the same key list); finish: write seg_ids, first_row and n_groups (the
// last block). Returns 0 or the CUDA error of the launch.
int segment_bounds(const KeyDesc* keys, int nkeys, int accumulate, int finish,
                   const void* n_live, long long cap, void* starts,
                   void* seg_ids, void* first_row, void* n_groups,
                   void* scratch, void* stream) {
  if (nkeys < 1 || nkeys > MAX_KEYS) return (int)cudaErrorInvalidValue;
  KeyTable kt;
  kt.n = nkeys;
  for (int i = 0; i < nkeys; ++i) kt.k[i] = keys[i];
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = num_blocks(cap);
  flags_kernel<<<nb, kThreads, 0, s>>>(kt, accumulate, (const int*)n_live,
                                       cap, (uint8_t*)starts, (int*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !finish) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>((int*)scratch, nb, (int*)n_groups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ids_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)starts,
                                     (const int*)scratch,
                                     (const int*)n_groups, cap, (int*)seg_ids,
                                     (int*)first_row);
  return (int)cudaGetLastError();
}

}  // extern "C"
