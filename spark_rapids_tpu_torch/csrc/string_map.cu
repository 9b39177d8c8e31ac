// K16 string_map: the per-row character count and the ASCII case maps of a
// string column.
//
// Replaces spark_rapids_tpu/ops/strings.py:_char_count 39 with Length
// 110-123, _AsciiCase 126-147 (Upper 150, Lower 154) and InitCap 158-179
// (B16). Strings are uint8[n, w] zero-padded byte rows with int32 lengths.
// For row i, with len = min(lengths[i], w):
//   mode 0 (length):  out_len[i] = the bytes j < len with
//                     (b & 0xC0) != 0x80 (UTF-8 character starts), 0 for a
//                     NULL row (valid[i] == 0);
//   mode 1 (upper):   out[i, j] = b - 32 for b in 'a'..'z', else b;
//   mode 2 (lower):   out[i, j] = b + 32 for b in 'A'..'Z', else b;
//   mode 3 (initcap): a byte that follows a space (or starts the row) is
//                     upper-cased, any other byte lower-cased, ASCII only.
// The case maps run over every byte of the row's w, past its length too,
// as the reference maps its whole [cap, W] matrix; lengths and validity
// are the input's and stay with the wrapper.
//
// Bound on the card: bytes (mode 0: the rows, lengths and validity read,
// 4 bytes a row written; the maps: the rows read and written once).
// Design: one thread per row, one pass over the row in 8-byte words (the
// port's widths are powers of two >= 8, so rows are 8-byte aligned; the
// entry point refuses another width or an unaligned pointer); INITCAP
// carries the previous byte's "is a space" from word to word in a
// register.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t map_byte(uint8_t b, int mode,
                                            bool prev_space) {
  const bool lower = b >= 'a' && b <= 'z';
  const bool upper = b >= 'A' && b <= 'Z';
  if (mode == 1) return lower ? (uint8_t)(b - 32) : b;
  if (mode == 2) return upper ? (uint8_t)(b + 32) : b;
  if (prev_space) return lower ? (uint8_t)(b - 32) : b;
  return upper ? (uint8_t)(b + 32) : b;
}

// One 8-byte word of a row: bytes k * 8 .. k * 8 + 7, little-endian.
__device__ __forceinline__ unsigned long long load_word(const uint8_t* row,
                                                        int k) {
  const uint2 v = ((const uint2*)row)[k];
  return (unsigned long long)v.x | ((unsigned long long)v.y << 32);
}

// w is a multiple of 8, so rows are read and written as words.
__global__ void map_kernel(const uint8_t* data, const int* lengths,
                           const uint8_t* valid, long long n, int w, int mode,
                           uint8_t* out, int* out_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = data + i * (long long)w;
  const int words = w / 8;
  if (mode == 0) {
    int len = lengths[i];
    if (len > w) len = w;
    int chars = 0;
    for (int k = 0; k * 8 < len; ++k) {
      const unsigned long long x = load_word(row, k);
      for (int b = 0; b < 8 && k * 8 + b < len; ++b)
        chars += ((x >> (8 * b)) & 0xC0) != 0x80;
    }
    out_len[i] = valid[i] ? chars : 0;
    return;
  }
  uint8_t* orow = out + i * (long long)w;
  bool prev_space = true;  // column 0 counts as following a space
  for (int k = 0; k < words; ++k) {
    const unsigned long long x = load_word(row, k);
    unsigned long long y = 0ull;
    for (int b = 0; b < 8; ++b) {
      const uint8_t c = (uint8_t)(x >> (8 * b));
      y |= (unsigned long long)map_byte(c, mode, prev_space) << (8 * b);
      prev_space = c == ' ';
    }
    ((uint2*)orow)[k] = make_uint2((unsigned)y, (unsigned)(y >> 32));
  }
}

}  // namespace

extern "C" {

// data: uint8[n * w]; lengths: int32[n]; valid: uint8[n]
// (mode 0 only, else any pointer); out: uint8[n * w] for modes 1-3;
// out_len: int32[n] for mode 0. w must be a multiple of 8 and data and out
// 8-byte aligned. Returns 0 or the CUDA error of the launch.
int string_map(const void* data, const void* lengths, const void* valid,
               long long n, int w, int mode, void* out, void* out_len,
               void* stream) {
  if (n < 1 || w < 8 || w % 8 != 0 || mode < 0 || mode > 3 ||
      (mode == 0 && (out_len == nullptr || valid == nullptr)) ||
      (mode != 0 && out == nullptr) || (uintptr_t)data % 8 != 0 ||
      (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  map_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lengths, (const uint8_t*)valid, n, w,
      mode, (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
