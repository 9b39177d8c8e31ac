// K28 map_build: map(k1, v1, ..., kP, vP) into the MAP layout.
//
// Replaces spark_rapids_tpu/ops/maps.py:CreateMap.eval (74), B17. For every
// row r over the P literal-count (key, value) pairs, keys and values
// integral or boolean columns widened to int64 (the reference stacks them
// into one promoted type; the planner keeps floating keys and values off
// this kernel, as the reference does):
//   a NULL key, or a dead row, gives a NULL map (validity 0, length 0, all
//   lanes 0);
//   else, LAST_WIN deduplication as Spark's ArrayBasedMapBuilder does it: a
//   key keeps the position of its first occurrence and the value (and the
//   value's validity) of its last; the kept entries go to the front in
//   order, as lanes [key, value (0 where NULL), value valid] of
//   mat[r, 0:3W), the lanes past them 0, and lengths[r] = their count.
//
// Bound on the card: bytes (the keys, values and their validity read, the
// lanes, lengths and validity written). Design: one thread per row, the P
// pairs in local arrays (P is the literal count of create_map's arguments,
// at most kMaxPairs), O(P^2) compares each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 32;

struct Pairs {
  const void* key[kMaxPairs];
  const bool* key_valid[kMaxPairs];
  const void* value[kMaxPairs];
  const bool* value_valid[kMaxPairs];
  int key_bytes[kMaxPairs];
  int value_bytes[kMaxPairs];
};

__device__ __forceinline__ long long load_widened(const void* p, long long r,
                                                  int bytes) {
  switch (bytes) {
    case 1: return ((const signed char*)p)[r];
    case 2: return ((const short*)p)[r];
    case 4: return ((const int*)p)[r];
    default: return ((const long long*)p)[r];
  }
}

__global__ void build_kernel(Pairs pairs, int n_pairs, const bool* live,
                             long long n, int width, long long* mat,
                             int* lengths, bool* valid) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  long long* row = mat + r * 3LL * width;
  bool ok = live[r];
  for (int j = 0; j < n_pairs && ok; ++j) ok = pairs.key_valid[j][r];
  int kept = 0;
  if (ok) {
    long long k[kMaxPairs];
    long long v[kMaxPairs];
    bool vv[kMaxPairs];
    for (int j = 0; j < n_pairs; ++j) {
      k[j] = load_widened(pairs.key[j], r, pairs.key_bytes[j]);
      vv[j] = pairs.value_valid[j][r];
      v[j] = vv[j] ? load_widened(pairs.value[j], r, pairs.value_bytes[j])
                   : 0;
    }
    for (int i = 0; i < n_pairs; ++i) {
      bool first = true;
      for (int j = 0; j < i && first; ++j) first = k[j] != k[i];
      if (!first) continue;
      int last = i;
      for (int j = i + 1; j < n_pairs; ++j)
        if (k[j] == k[i]) last = j;
      row[3 * kept] = k[i];
      row[3 * kept + 1] = v[last];
      row[3 * kept + 2] = vv[last] ? 1 : 0;
      ++kept;
    }
  }
  for (int c = 3 * kept; c < 3 * width; ++c) row[c] = 0;
  lengths[r] = kept;
  valid[r] = ok;
}

}  // namespace

extern "C" {

int map_build_max_pairs() { return kMaxPairs; }

// keys, values: n_pairs device pointers each to [n] columns of key_bytes /
// value_bytes-byte integers (booleans as 1 byte), with key_valid and
// value_valid bool[n] pointers; live bool[n]; mat int64[n, 3 * width]
// (width >= n_pairs), lengths int32[n] and valid bool[n] (written).
int map_build(const void* const* keys, const void* const* key_valid,
              const int* key_bytes, const void* const* values,
              const void* const* value_valid, const int* value_bytes,
              int n_pairs, const void* live, long long n, int width,
              void* mat, void* lengths, void* valid, void* stream) {
  if (n < 1 || n_pairs < 1 || n_pairs > kMaxPairs || width < n_pairs)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  for (int j = 0; j < kMaxPairs; ++j) {
    const bool in = j < n_pairs;
    p.key[j] = in ? keys[j] : nullptr;
    p.key_valid[j] = in ? (const bool*)key_valid[j] : nullptr;
    p.value[j] = in ? values[j] : nullptr;
    p.value_valid[j] = in ? (const bool*)value_valid[j] : nullptr;
    p.key_bytes[j] = in ? key_bytes[j] : 8;
    p.value_bytes[j] = in ? value_bytes[j] : 8;
  }
  build_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                 (cudaStream_t)stream>>>(p, n_pairs, (const bool*)live, n,
                                         width, (long long*)mat,
                                         (int*)lengths, (bool*)valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
