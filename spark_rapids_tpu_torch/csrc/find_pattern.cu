// K13 find_pattern: the byte position of a literal pattern in every row of
// a string column, or -1.
//
// Replaces spark_rapids_tpu/ops/strings.py:_find_pattern (first
// occurrence, Contains) and the prefix and suffix tests of StartsWith and
// EndsWith (B16). Strings are uint8[n, w] zero-padded byte rows with
// int32 lengths; the pattern is p bytes in device memory. For row i, with
// len = lengths[i]:
//   mode 0 (first):  the least j with j + p <= len and
//                    data[i, j .. j+p) == pattern;
//   mode 1 (prefix): 0 when p <= len and data[i, 0 .. p) == pattern;
//   mode 2 (suffix): len - p when p <= len and
//                    data[i, len-p .. len) == pattern;
// and -1 where there is none. Mode 3 (locate) replaces the
// character-position step of StringLocate (strings.py:465-472): with j the
// first-occurrence position of mode 0, it writes the number of UTF-8
// character-start bytes ((b & 0xC0) != 0x80) in data[i, 0 .. j], the
// 1-based character index of the match, and 0 where there is no match (a
// match at a leading continuation byte also gives 0, as the reference's
// cumsum - 1 + 1 does). As in the reference: an empty pattern
// matches at 0 in every row, a pattern longer than w matches nowhere, a
// match must end within the row's length (bytes past it never match,
// whatever they hold), and the comparison is bytewise, so a multi-byte
// UTF-8 pattern matches where its bytes do.
//
// Bound on the card: bytes (n * (w + 4) read, 4n written). Design: one
// thread per row, the pattern staged once per block in shared memory (up
// to kSharedPattern bytes; a longer one is read from device memory), a
// naive scan of the row's candidate starts with the first byte compared
// before the rest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedPattern = 4096;

__global__ void find_kernel(const uint8_t* data, const int* lengths,
                            long long n, int w, const uint8_t* pattern,
                            int p, int mode, int* out) {
  __shared__ uint8_t sh[kSharedPattern];
  const uint8_t* pat = pattern;
  if (p <= kSharedPattern) {
    for (int k = threadIdx.x; k < p; k += blockDim.x) sh[k] = pattern[k];
    __syncthreads();
    pat = sh;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = data + i * (long long)w;
  if (p == 0) {
    out[i] = mode == 3 ? ((row[0] & 0xC0) != 0x80 ? 1 : 0) : 0;
    return;
  }
  int len = lengths[i];
  if (len > w) len = w;
  int pos = -1;
  if (p <= len) {
    int j = 0;
    int last = len - p;
    if (mode == 1) last = 0;
    if (mode == 2) j = last;
    const uint8_t first = pat[0];
    for (; j <= last; ++j) {
      if (row[j] != first) continue;
      int k = 1;
      while (k < p && row[j + k] == pat[k]) ++k;
      if (k == p) {
        pos = j;
        break;
      }
    }
  }
  if (mode == 3) {
    int chars = 0;
    for (int j = 0; j <= pos; ++j) chars += (row[j] & 0xC0) != 0x80;
    pos = chars;  // 0 when not found (pos == -1)
  }
  out[i] = pos;
}

}  // namespace

extern "C" {

// data: uint8[n * w]; lengths: int32[n]; pattern: uint8[p] on the device
// (any valid pointer when p == 0); out: int32[n]. Returns 0 or the CUDA
// error of the launch.
int find_pattern(const void* data, const void* lengths, long long n, int w,
                 const void* pattern, int p, int mode, void* out,
                 void* stream) {
  if (n < 1 || w < 1 || p < 0 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  find_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lengths, n, w,
      (const uint8_t*)pattern, p, mode, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
