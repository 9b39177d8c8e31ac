// K26 split_parts: split(str, d) on a single-byte literal delimiter, in
// two modes.
//
// Replaces spark_rapids_tpu/ops/arrays.py:split_part_counts (189) and the
// part placement of split_explode (200), B17. Spark's split semantics with
// a one-byte delimiter: "a,b" -> ["a", "b"]; "" -> [""]; leading, trailing
// and doubled delimiters give empty parts; NULL gives no part.
//
//   count mode (split_count): parts[r] = 1 + the delimiter bytes among the
//     first lengths[r] bytes of row r where valid[r], else 0.
//   place mode (split_place): for every output row i < out_cap with the
//     source row src[i] and part number pos[i] (K25's index mode over the
//     counts), the part's bytes from [start, end) of the source row, where
//     start is 0 for part 0 and one past the pos[i]-th delimiter after,
//     and end the (pos[i]+1)-th delimiter or the row's length, written
//     from byte 0 of output row i with every byte after it 0, its length
//     end - start and validity 1; rows i >= total are zero, length 0,
//     invalid.
//
// Bound on the card: bytes (count mode: every row's validity, a valid
// row's bytes up to its length and its length read, the counts written;
// place mode: the bytes and length of each source row that has a part read
// once, src and pos of each output row read, the output bytes, lengths and
// validity written over the output capacity).
// Design: one thread per row in both modes; place mode assembles each
// 8-byte word of its output row in registers and stores it whole (widths
// are multiples of 8), so its stores are 8 bytes wide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__global__ void count_kernel(const unsigned char* bytes, const int* lengths,
                             const bool* valid, long long n, long long width,
                             unsigned char delim, int* parts) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  if (!valid[r]) {
    parts[r] = 0;
    return;
  }
  const unsigned char* row = bytes + r * width;
  const int len = lengths[r] < width ? lengths[r] : (int)width;
  int c = 1;
  for (int k = 0; k < len; ++k) c += row[k] == delim;
  parts[r] = c;
}

__global__ void place_kernel(const unsigned char* bytes, const int* lengths,
                             long long width, unsigned char delim,
                             const int* src, const int* pos,
                             long long out_cap, const long long* total,
                             unsigned long long* out, int* out_lengths,
                             bool* out_valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= out_cap) return;
  const long long words = width / 8;
  unsigned long long* orow = out + i * words;
  if (i >= *total) {
    for (long long w = 0; w < words; ++w) orow[w] = 0ull;
    out_lengths[i] = 0;
    out_valid[i] = false;
    return;
  }
  const long long r = src[i];
  const int p = pos[i];
  const unsigned char* row = bytes + r * width;
  const int len = lengths[r] < width ? lengths[r] : (int)width;
  int start = p == 0 ? 0 : len;
  int end = len;
  int seen = 0;
  for (int k = 0; k < len; ++k) {
    if (row[k] != delim) continue;
    if (seen == p) {
      end = k;
      break;
    }
    ++seen;
    if (seen == p) start = k + 1;
  }
  const int plen = end > start ? end - start : 0;
  for (long long w = 0; w < words; ++w) {
    unsigned long long word = 0ull;
    for (int b = 0; b < 8; ++b) {
      const long long c = w * 8 + b;
      if (c < plen)
        word |= (unsigned long long)row[start + c] << (8 * b);
    }
    orow[w] = word;
  }
  out_lengths[i] = plen;
  out_valid[i] = true;
}

}  // namespace

extern "C" {

// bytes: uint8[n, width]; lengths: int32[n]; valid: bool[n]; parts:
// int32[n] (written).
int split_count(const void* bytes, const void* lengths, const void* valid,
                long long n, long long width, int delim, void* parts,
                void* stream) {
  if (n < 1 || width < 1) return (int)cudaErrorInvalidValue;
  count_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)bytes, (const int*)lengths, (const bool*)valid,
      n, width, (unsigned char)delim, (int*)parts);
  return (int)cudaGetLastError();
}

// src, pos: int32[out_cap]; total: int64[1] on the device; out:
// uint8[out_cap, width] (width a multiple of 8); out_lengths int32 and
// out_valid bool [out_cap] (written).
int split_place(const void* bytes, const void* lengths, long long width,
                int delim, const void* src, const void* pos,
                long long out_cap, const void* total, void* out,
                void* out_lengths, void* out_valid, void* stream) {
  if (out_cap < 1 || width < 8 || width % 8 != 0)
    return (int)cudaErrorInvalidValue;
  place_kernel<<<blocks_for(out_cap), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)bytes, (const int*)lengths, width,
      (unsigned char)delim, (const int*)src, (const int*)pos, out_cap,
      (const long long*)total, (unsigned long long*)out, (int*)out_lengths,
      (bool*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
