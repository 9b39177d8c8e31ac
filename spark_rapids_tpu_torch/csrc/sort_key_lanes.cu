// K2 sort_key_lanes: order-preserving int64 sort lanes for a multi-key sort.
//
// Replaces the encoding half of spark_rapids_tpu/ops/kernels.py:sort_indices
// (_key_arrays_bits, encode_orderable_words, pack_string_words and
// pack_key_bits, B6). For each row it builds one bit string, most
// significant field first:
//   pad rank (1 bit: dead or padding rows last), then per key
//   null rank (1 bit, nulls first or last), then the value:
//     signed integers and dates: sign-flipped, 8 * width bits;
//     bool: the byte, 8 bits;
//     floats: a NaN rank bit, then the 64-bit orderable pattern of the value
//       with NaN replaced by 0 and -0.0 by +0.0 (both sort as equal to it,
//       as XLA's float sort treats them);
//     strings: every byte big-endian, then the length (len_bits bits);
//   a descending key complements its value bits.
// The string is cut into 63-bit lanes, written lane-major (lanes[l * cap +
// row]). Every lane is a non-negative int64, so the signed order of a lane
// is the unsigned order of its bits, and a stable sort by the lanes, least
// significant lane first, is the lexicographic order of the keys: the same
// permutation jnp.lexsort gives over the JAX package's 32-bit lanes.
//
// Bound on the card: bytes (the key columns read once, 8 bytes a lane
// written). Design: one thread per row, coalesced across the warp, a
// register bit-writer, no shared memory.
#include "keys_common.cuh"

namespace {

struct BitWriter {
  unsigned long long cur;
  int used;
  int lane;
  long long* out;
  long long cap;
  long long row;

  __device__ void put(unsigned long long v, int nbits) {
    while (nbits > 0) {
      int take = 63 - used;
      if (take > nbits) take = nbits;
      const unsigned long long chunk =
          (v >> (nbits - take)) & ((1ull << take) - 1ull);
      cur = (cur << take) | chunk;
      used += take;
      nbits -= take;
      if (used == 63) {
        out[(long long)lane * cap + row] = (long long)cur;
        ++lane;
        cur = 0ull;
        used = 0;
      }
    }
  }

  __device__ void flush() {
    if (used > 0) out[(long long)lane * cap + row] = (long long)cur;
  }
};

__global__ void lanes_kernel(KeyTable kt, const uint8_t* live,
                             const int* n_rows, long long cap,
                             long long* lanes) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap) return;
  BitWriter w;
  w.cur = 0ull;
  w.used = 0;
  w.lane = 0;
  w.out = lanes;
  w.cap = cap;
  w.row = row;
  const bool is_live = live != nullptr ? live[row] != 0 : row < (long long)*n_rows;
  w.put(is_live ? 0ull : 1ull, 1);
  for (int k = 0; k < kt.n; ++k) {
    const KeyDesc& d = kt.k[k];
    const bool vld = ((const uint8_t*)d.valid)[row] != 0;
    w.put(d.nulls_first ? (vld ? 1ull : 0ull) : (vld ? 0ull : 1ull), 1);
    if (d.kind == K_INT) {
      const int bits = 8 * d.width;
      const unsigned long long mask =
          bits == 64 ? ~0ull : ((1ull << bits) - 1ull);
      unsigned long long u =
          ((unsigned long long)load_int(d.data, d.width, row) & mask) ^
          (1ull << (bits - 1));
      if (!d.ascending) u ^= mask;
      w.put(u, bits);
    } else if (d.kind == K_BOOL) {
      unsigned long long u = ((const uint8_t*)d.data)[row];
      if (!d.ascending) u ^= 0xFFull;
      w.put(u, 8);
    } else if (d.kind == K_F32 || d.kind == K_F64) {
      double x = load_float(d, row);
      const bool nan = isnan(x);
      w.put(d.ascending ? (nan ? 1ull : 0ull) : (nan ? 0ull : 1ull), 1);
      if (nan || x == 0.0) x = 0.0;
      const unsigned long long b = (unsigned long long)__double_as_longlong(x);
      unsigned long long u = (b >> 63) ? ~b : (b | (1ull << 63));
      if (!d.ascending) u = ~u;
      w.put(u, 64);
    } else {  // K_STRING
      const uint8_t* bytes = (const uint8_t*)d.data + row * (long long)d.width;
      const unsigned long long flip = d.ascending ? 0ull : 0xFFull;
      for (int j = 0; j < d.width; ++j) w.put((unsigned long long)bytes[j] ^ flip, 8);
      const unsigned long long lmask = (1ull << d.len_bits) - 1ull;
      unsigned long long len =
          (unsigned long long)((const int*)d.lengths)[row] & lmask;
      if (!d.ascending) len ^= lmask;
      w.put(len, d.len_bits);
    }
  }
  w.flush();
}

}  // namespace

extern "C" {

// keys: nkeys descriptors. live: uint8 mask or null (then rows >= *n_rows
// are padding). lanes: int64[nlanes * cap]. Returns 0 or the CUDA error.
int sort_key_lanes(const KeyDesc* keys, int nkeys, const void* live,
                   const void* n_rows, long long cap, int nlanes, void* lanes,
                   void* stream) {
  if (nkeys < 0 || nkeys > MAX_KEYS || nlanes < 1) return (int)cudaErrorInvalidValue;
  KeyTable kt;
  kt.n = nkeys;
  for (int i = 0; i < nkeys; ++i) kt.k[i] = keys[i];
  const int threads = 256;
  const long long blocks = (cap + threads - 1) / threads;
  lanes_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), threads, 0,
                 (cudaStream_t)stream>>>(kt, (const uint8_t*)live,
                                         (const int*)n_rows, cap,
                                         (long long*)lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
