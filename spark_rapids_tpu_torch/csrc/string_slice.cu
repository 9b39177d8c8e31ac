// K17 string_slice: one contiguous byte range of every row of a string
// column moved to the front of the row: Substring and the space trims.
//
// Replaces spark_rapids_tpu/ops/strings.py:_compact_rows 45-53 with its two
// callers, Substring 182-226 and _Trim 514-546 (StringTrim 549,
// StringTrimLeft 553, StringTrimRight 557) (B16). The reference keeps a
// per-row mask of bytes and compacts it with a stable per-row argsort. In
// both callers the kept bytes are one run [b, e): Substring keeps the bytes
// whose character index (a non-decreasing cumsum of UTF-8 character
// starts, -1 on leading continuation bytes) lies in [start, end); a trim
// drops a prefix and a suffix of spaces. So the kernel finds b and e per
// row and copies that run: out[i, 0 .. e-b) = data[i, b .. e), zeros up to
// w, and out_len[i] = e - b for a valid row, 0 for a NULL one (the bytes of
// a NULL row are still the run's, as in the reference). With
// len = min(lengths[i], w):
//   mode 0 (substring): nchars = the character starts below len; with the
//       1-based position p and the length l (per row or one value):
//       start = p - 1 for p > 0, nchars + p for p < 0, 0 for p == 0;
//       end = start + l, computed before start is clamped to 0 (Spark's
//       UTF8String.substringSQL, in 64 bits); then start = max(start, 0);
//   mode 1 (trim), 2 (ltrim), 3 (rtrim): b = the leading spaces below len
//       (modes 1, 2; else 0), e = len less the trailing spaces (modes 1, 3;
//       else len); a row of spaces only is empty.
//
// Bound on the card: bytes (the rows, lengths, validity and per-row
// position and length read once, the rows and lengths written once).
// Design: one thread per row, two passes over its bytes: one finds b and e
// (mode 0 counts characters on the way), one copies the run and zeroes the
// rest of the row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool char_start(uint8_t b) {
  return (b & 0xC0) != 0x80;
}

__global__ void slice_kernel(const uint8_t* data, const int* lengths,
                             const uint8_t* valid, long long n, int w,
                             int mode, const int* pos, int pos_scalar,
                             const int* len_arr, int len_scalar, uint8_t* out,
                             int* out_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = data + i * (long long)w;
  int len = lengths[i];
  if (len > w) len = w;
  if (len < 0) len = 0;
  int b = 0, e = 0;
  if (mode == 0) {
    int nchars = 0;
    for (int j = 0; j < len; ++j) nchars += char_start(row[j]);
    const long long p = pos != nullptr ? pos[i] : pos_scalar;
    const long long l = len_arr != nullptr ? len_arr[i] : len_scalar;
    long long start = p > 0 ? p - 1 : (p < 0 ? nchars + p : 0);
    const long long end = start + l;
    if (start < 0) start = 0;
    // the run of bytes whose character index lies in [start, end)
    b = len;
    e = len;
    int ci = -1;
    for (int j = 0; j < len; ++j) {
      ci += char_start(row[j]);
      if (b == len && ci >= start && ci < end) b = j;
      if (ci >= end) {
        e = j;
        break;
      }
    }
    if (e < b) e = b;
  } else {
    e = len;
    if (mode != 3)
      while (b < len && row[b] == ' ') ++b;
    if (mode != 2)
      while (e > b && row[e - 1] == ' ') --e;
  }
  const int cnt = e - b;
  uint8_t* orow = out + i * (long long)w;
  for (int j = 0; j < cnt; ++j) orow[j] = row[b + j];
  for (int j = cnt; j < w; ++j) orow[j] = 0;
  out_len[i] = (valid == nullptr || valid[i]) ? cnt : 0;
}

}  // namespace

extern "C" {

// data: uint8[n * w]; lengths: int32[n]; valid: uint8[n] or null (every row
// valid); pos, len: int32[n] per-row values or null (then pos_scalar,
// len_scalar), mode 0 only; out: uint8[n * w]; out_len: int32[n]. Returns
// 0 or the CUDA error of the launch.
int string_slice(const void* data, const void* lengths, const void* valid,
                 long long n, int w, int mode, const void* pos, int pos_scalar,
                 const void* len, int len_scalar, void* out, void* out_len,
                 void* stream) {
  if (n < 1 || w < 1 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  slice_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lengths, (const uint8_t*)valid, n, w,
      mode, (const int*)pos, pos_scalar, (const int*)len, len_scalar,
      (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
