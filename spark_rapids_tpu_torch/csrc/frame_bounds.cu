// K23 frame_bounds: each row's [lo, hi] row range of a bounded ROWS or RANGE
// window frame.
//
// Replaces spark_rapids_tpu/ops/window.py:segment_positions (309),
// frame_bounds_rows (319) and frame_bounds_range (330) (B15). The batch is
// sorted by (partition keys, order keys), its first *n_live rows live; K3
// gives each row's segment id and each segment's first row, so segment g
// spans [first_row[g], last] with last = first_row[g + 1] - 1, or
// *n_live - 1 for the last segment. For a live row i of that segment [s, e]:
//   ROWS:  lo = s for an unbounded lower end, else i + lower clamped into
//          [s, e + 1]; hi = e for an unbounded upper end, else i + upper
//          clamped into [s - 1, e].
//   RANGE: one ascending order key of at most 32 bits (int8/16/32, date).
//          The segment's NULL keys form one run (first with NULLS FIRST),
//          and a NULL-key row's frame is that run. A valid-key row's frame
//          is the valid rows of its segment whose key lies in
//          [k + lower, k + upper] (the offsets added in 64 bits, so nothing
//          wraps, as the reference's clip to int32 gives); an unbounded end
//          runs to the first or last valid row.
// hi < lo is an empty frame. Dead rows get lo = 0, hi = -1.
//
// The reference packs (segment, validity, key) into one uint64 so that one
// searchsorted over the whole batch finds each bound: a TPU workaround. Here
// each row binary-searches its own segment.
//
// Bound on the card: bytes (ids, first rows and keys read, two int32
// written a row). Design: one thread a row; a RANGE row does three binary
// searches inside its segment (the NULL run's edge, then each bound), so its
// work is O(log segment) and a segment's rows read the same cached lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  int range;
  const int* seg_ids;
  const int* first_row;
  const int* n_groups;
  const int* n_live;
  long long cap;
  int has_lower;
  long long lower;
  int has_upper;
  long long upper;
  const void* key;
  int key_width;
  const uint8_t* key_valid;
  int nulls_first;
  int* lo;
  int* hi;
};

__device__ __forceinline__ long long load_key(const void* p, int width,
                                              long long i) {
  switch (width) {
    case 1: return (long long)((const int8_t*)p)[i];
    case 2: return (long long)((const int16_t*)p)[i];
    default: return (long long)((const int32_t*)p)[i];
  }
}

// First index in [a, b) whose key is >= v (b when none).
__device__ __forceinline__ long long lower_bound(const Params& p,
                                                 long long a, long long b,
                                                 long long v) {
  while (a < b) {
    const long long m = a + (b - a) / 2;
    if (load_key(p.key, p.key_width, m) < v) a = m + 1;
    else b = m;
  }
  return a;
}

// First index in [a, b) whose key is > v (b when none).
__device__ __forceinline__ long long upper_bound(const Params& p,
                                                 long long a, long long b,
                                                 long long v) {
  while (a < b) {
    const long long m = a + (b - a) / 2;
    if (load_key(p.key, p.key_width, m) <= v) a = m + 1;
    else b = m;
  }
  return a;
}

__global__ void bounds_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.cap) return;
  const long long n = *p.n_live;
  if (i >= n) {
    p.lo[i] = 0;
    p.hi[i] = -1;
    return;
  }
  const int g = p.seg_ids[i];
  const long long s = p.first_row[g];
  const long long e = (g + 1 < *p.n_groups ? (long long)p.first_row[g + 1]
                                            : n) - 1;
  long long lo, hi;
  if (!p.range) {
    lo = s;
    if (p.has_lower) {
      lo = i + p.lower;
      lo = lo < s ? s : (lo > e + 1 ? e + 1 : lo);
    }
    hi = e;
    if (p.has_upper) {
      hi = i + p.upper;
      hi = hi > e ? e : (hi < s - 1 ? s - 1 : hi);
    }
  } else {
    // the valid keys of [s, e] are one run: [vs, ve]; the NULLs the rest
    long long vs, ve;
    long long a = s, b = e + 1;
    if (p.nulls_first) {  // first valid row
      while (a < b) {
        const long long m = a + (b - a) / 2;
        if (p.key_valid[m] == 0) a = m + 1;
        else b = m;
      }
      vs = a;
      ve = e;
    } else {              // first NULL row
      while (a < b) {
        const long long m = a + (b - a) / 2;
        if (p.key_valid[m] != 0) a = m + 1;
        else b = m;
      }
      vs = s;
      ve = a - 1;
    }
    if (p.key_valid[i] == 0) {
      lo = p.nulls_first ? s : ve + 1;
      hi = p.nulls_first ? vs - 1 : e;
    } else {
      const long long k = load_key(p.key, p.key_width, i);
      lo = p.has_lower ? lower_bound(p, vs, ve + 1, k + p.lower) : vs;
      hi = p.has_upper ? upper_bound(p, vs, ve + 1, k + p.upper) - 1 : ve;
    }
  }
  p.lo[i] = (int)lo;
  p.hi[i] = (int)hi;
}

}  // namespace

extern "C" {

// range: 0 ROWS, 1 RANGE. seg_ids, first_row int32[cap]; n_groups, n_live
// int32[1]. RANGE only: key (key_width bytes a row), key_valid uint8[cap],
// nulls_first. lo, hi: int32[cap]. Returns 0 or the CUDA error of the launch.
int frame_bounds(int range, const void* seg_ids, const void* first_row,
                 const void* n_groups, const void* n_live, long long cap,
                 int has_lower, long long lower, int has_upper,
                 long long upper, const void* key, int key_width,
                 const void* key_valid, int nulls_first, void* lo, void* hi,
                 void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (range && (key == nullptr || key_valid == nullptr ||
                (key_width != 1 && key_width != 2 && key_width != 4)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.range = range;
  p.seg_ids = (const int*)seg_ids;
  p.first_row = (const int*)first_row;
  p.n_groups = (const int*)n_groups;
  p.n_live = (const int*)n_live;
  p.cap = cap;
  p.has_lower = has_lower;
  p.lower = lower;
  p.has_upper = has_upper;
  p.upper = upper;
  p.key = key;
  p.key_width = key_width;
  p.key_valid = (const uint8_t*)key_valid;
  p.nulls_first = nulls_first;
  p.lo = (int*)lo;
  p.hi = (int*)hi;
  const long long nb = (cap + kThreads - 1) / kThreads;
  bounds_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
