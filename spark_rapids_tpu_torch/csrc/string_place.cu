// K18 string_place: string columns whose every output byte comes either
// from one source row at a per-row offset or from a cyclic pad pattern:
// ConcatStr and the pads.
//
// Replaces spark_rapids_tpu/ops/strings.py:ConcatStr 229-262 and _Pad
// 561-606 (StringLPad 616, StringRPad 620) (B16). Strings are uint8 rows
// of their own width with int32 lengths and uint8 validity; an operand is a
// column (row stride 1) or one scalar row read for every row (stride 0).
// Output rows are ow bytes wide. For output row i and byte j:
//   mode 0 (concat, k operands): the operands' lengths laid end to end;
//       byte j is operand m's byte j - off_m where off_m <= j < off_m +
//       len_m, else 0; out_len = the sum of the lengths and out_valid the
//       AND of the validities; a NULL row is all zeros with length 0;
//   mode 1 (lpad), 2 (rpad), one operand of length len, target t, pad
//       pattern of p bytes (bytes, not characters, as the reference
//       declares): t <= 0 gives an empty row; p == 0 the row cut to t bytes
//       (Spark's rule for both; the reference pads an empty pattern with a
//       space and writes a negative length); otherwise the first t bytes of
//       pad + row (lpad: pad byte j % p before the row, which starts at
//       max(t - len, 0)) or row + pad (rpad: pad byte (j - len) % p after
//       it); out_len = that length for a valid row, 0 for a NULL one (whose
//       bytes are still written, as in the reference).
// Bytes at or past the row's output length are 0.
//
// Bound on the card: bytes (each operand's rows and lengths read once, the
// output rows and lengths written once). Design: one thread per 8-byte
// word of an output row, stored at once (a first design with one thread a
// byte took 1.14 ms for a 2^20 x 128 concat on the H100); it walks the
// operands' lengths of its row once (k small loads that the row's other
// threads share through L1) and copies the bytes that fall in its word;
// the thread of word 0 writes the row's length and validity. Operand
// descriptors go by value.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_OPERANDS 32

// Mirrored by ctypes in spark_rapids_tpu_torch/native.py (32 bytes).
struct Operand {
  const uint8_t* data;   // uint8[rows, width]
  const int* lengths;    // int32[rows]
  const uint8_t* valid;  // uint8[rows]
  int width;
  int stride;            // 1: a column; 0: one scalar row for every row
};

struct OperandTable {
  int k;
  Operand op[MAX_OPERANDS];
};

namespace {

constexpr int kThreads = 256;

// One thread per 8-byte word of an output row (ow a multiple of 8 and out
// 8-byte aligned, so the word is one store).
__global__ void place_kernel(OperandTable t, long long n, int ow, int mode,
                             int target, const uint8_t* pad, int p,
                             uint8_t* out, int* out_len, uint8_t* out_valid) {
  const int words = ow / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * (long long)words) return;
  const long long i = idx / words;
  const int j0 = (int)(idx - i * words) * 8;
  const int j1 = j0 + 8;  // this word's bytes: [j0, j1)
  unsigned long long word = 0ull;
  int row_len = 0;
  bool row_valid = true;
  if (mode == 0) {
    int off = 0;
    for (int m = 0; m < t.k; ++m) {
      const Operand& o = t.op[m];
      const long long r = i * o.stride;
      row_valid = row_valid && o.valid[r] != 0;
      const int len = o.lengths[r];
      // the operand's bytes that fall in this word
      const int lo = off > j0 ? off : j0;
      const int hi = off + len < j1 ? off + len : j1;
      const uint8_t* src = o.data + r * o.width - off;
      for (int j = lo; j < hi; ++j)
        word |= (unsigned long long)src[j] << (8 * (j - j0));
      off += len;
    }
    if (!row_valid) word = 0ull;
    row_len = row_valid ? off : 0;
  } else {
    const Operand& o = t.op[0];
    const long long r = i * o.stride;
    const int len = o.lengths[r];
    const int new_len = target <= 0 ? 0 : (p == 0 ? (len < target ? len
                                                                  : target)
                                                  : target);
    const uint8_t* src = o.data + r * o.width;
    const int pad_n = target - len > 0 ? target - len : 0;
    for (int j = j0; j < j1 && j < new_len; ++j) {
      uint8_t byte;
      if (p == 0) {
        byte = src[j];
      } else if (mode == 1) {
        const int s = j - pad_n;
        byte = (s >= 0 && s < len) ? src[s] : pad[j % p];
      } else {
        byte = j < len ? src[j] : pad[(j - len) % p];
      }
      word |= (unsigned long long)byte << (8 * (j - j0));
    }
    row_valid = o.valid[r] != 0;
    row_len = row_valid ? new_len : 0;
  }
  uint8_t* orow = out + i * (long long)ow;
  ((uint2*)orow)[j0 / 8] = make_uint2((unsigned)word, (unsigned)(word >> 32));
  if (j0 == 0) {
    out_len[i] = row_len;
    if (out_valid != nullptr) out_valid[i] = row_valid ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// ops: k operand descriptors (k == 1 for the pads); out: uint8[n * ow];
// out_len: int32[n]; out_valid: uint8[n] or null; pad: p bytes on the
// device (any pointer when p == 0 or mode 0). ow must be a multiple of 8
// and out 8-byte aligned. Returns 0 or the CUDA error of the launch.
int string_place(const Operand* ops, int k, long long n, int ow, int mode,
                 int target, const void* pad, int p, void* out, void* out_len,
                 void* out_valid, void* stream) {
  if (n < 1 || ow < 8 || ow % 8 != 0 || (uintptr_t)out % 8 != 0 || k < 1 ||
      k > MAX_OPERANDS || mode < 0 || mode > 2 || (mode != 0 && k != 1) ||
      p < 0)
    return (int)cudaErrorInvalidValue;
  OperandTable t;
  t.k = k;
  for (int m = 0; m < k; ++m) t.op[m] = ops[m];
  const long long total = n * (long long)(ow / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  place_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, n, ow, mode, target, (const uint8_t*)pad, p, (uint8_t*)out,
      (int*)out_len, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
