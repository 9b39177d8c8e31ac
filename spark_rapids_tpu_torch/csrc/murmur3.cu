// K11 murmur3: Spark's Murmur3Hash over a row's key columns (x86_32,
// chained through the seed), and the hash partition id pmod(hash, n).
//
// Replaces spark_rapids_tpu/ops/hashing.py:_hash_int32 54, _hash_int64 61,
// _hash_bytes 70, murmur3_column 98 and murmur3_batch 123 (B13), and the
// pmod of shuffle/partitioning.py:HashPartitioner.partition_ids 195-200.
// For every row i < cap, starting from the seed (one value, or seeds[i]):
//   a NULL leaves the running hash as it is;
//   int8/int16/int32/date/bool: hashInt of the sign-extended int32;
//   int64/timestamp: hashLong (the low word, then the high word);
//   float/double: -0.0 becomes 0.0 and every NaN the canonical NaN
//     (Float.floatToIntBits / Double.doubleToLongBits), then hashInt /
//     hashLong of the bits;
//   string: hashUnsafeBytes: the 4-byte little-endian blocks that lie
//     inside the length, then each tail byte as a SIGNED int block, then
//     the final mix with the length in bytes.
// Outputs (either may be null): hash[i] (int32), and pid[i] =
// pmod(hash, n) for i < *n_rows, n for padding rows (the form in which K12
// puts padding last).
//
// Bound on the card: bytes (the key columns and their validity read once,
// 4 bytes a row written; a string row reads its bytes up to its length).
// Design: one thread per row walks the columns in order; integer mixing
// only, so the result is the same on every run and equals the CPU twin
// (ops/hashing.py:_murmur3_torch) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keys_common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix(mix_h1(seed, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t hash_long(unsigned long long v,
                                              uint32_t seed) {
  uint32_t h1 = mix_h1(seed, mix_k1((uint32_t)v));
  h1 = mix_h1(h1, mix_k1((uint32_t)(v >> 32)));
  return fmix(h1, 8u);
}

__device__ uint32_t hash_bytes(const uint8_t* row, int len, uint32_t seed) {
  uint32_t h1 = seed;
  const int aligned = len - len % 4;
  for (int b = 0; b < aligned; b += 4) {
    const uint32_t k1 = (uint32_t)row[b] | ((uint32_t)row[b + 1] << 8) |
                        ((uint32_t)row[b + 2] << 16) |
                        ((uint32_t)row[b + 3] << 24);
    h1 = mix_h1(h1, mix_k1(k1));
  }
  for (int b = aligned; b < len; ++b)
    h1 = mix_h1(h1, mix_k1((uint32_t)(int)(int8_t)row[b]));
  return fmix(h1, (uint32_t)len);
}

__device__ __forceinline__ uint32_t hash_key(const KeyDesc& k, long long i,
                                             uint32_t h) {
  switch (k.kind) {
    case K_STRING: {
      const uint8_t* row = (const uint8_t*)k.data + i * (long long)k.width;
      return hash_bytes(row, ((const int*)k.lengths)[i], h);
    }
    case K_BOOL:
      return hash_int(((const uint8_t*)k.data)[i] != 0 ? 1u : 0u, h);
    case K_F32: {
      const float f = ((const float*)k.data)[i];
      const uint32_t bits = f != f ? 0x7FC00000u
                                   : (f == 0.0f ? 0u : __float_as_uint(f));
      return hash_int(bits, h);
    }
    case K_F64: {
      const double d = ((const double*)k.data)[i];
      const unsigned long long bits =
          d != d ? 0x7FF8000000000000ull
                 : (d == 0.0 ? 0ull : (unsigned long long)__double_as_longlong(d));
      return hash_long(bits, h);
    }
    default: {
      const long long v = load_int(k.data, k.width, i);
      return k.width == 8 ? hash_long((unsigned long long)v, h)
                          : hash_int((uint32_t)(int)v, h);
    }
  }
}

__global__ void murmur3_kernel(KeyTable kt, uint32_t seed,
                               const int* seeds, long long cap,
                               const int* n_rows, int n_parts, int* hash,
                               int* pid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  uint32_t h = seeds != nullptr ? (uint32_t)seeds[i] : seed;
  for (int c = 0; c < kt.n; ++c) {
    const KeyDesc& k = kt.k[c];
    if (((const uint8_t*)k.valid)[i] != 0) h = hash_key(k, i, h);
  }
  if (hash != nullptr) hash[i] = (int)h;
  if (pid != nullptr) {
    const int hs = (int)h;
    pid[i] = i < (long long)*n_rows ? ((hs % n_parts) + n_parts) % n_parts
                                    : n_parts;
  }
}

}  // namespace

extern "C" {

// keys: nkeys descriptors (K2's KeyDesc: kind, width, data, valid,
// lengths). seeds: int32[cap] per-row seeds or null (then `seed` for every
// row). hash: int32[cap] or null. pid: int32[cap] or null; it needs n_rows
// (int32[1] on the device) and n_parts >= 1. Returns 0 or the CUDA error.
int murmur3(const KeyDesc* keys, int nkeys, unsigned int seed,
            const void* seeds, long long cap, const void* n_rows,
            int n_parts, void* hash, void* pid, void* stream) {
  if (nkeys < 0 || nkeys > MAX_KEYS || cap < 1 ||
      (pid != nullptr && (n_parts < 1 || n_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  KeyTable kt;
  kt.n = nkeys;
  for (int i = 0; i < nkeys; ++i) kt.k[i] = keys[i];
  const int threads = 256;
  const long long blocks = (cap + threads - 1) / threads;
  murmur3_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      kt, (uint32_t)seed, (const int*)seeds, cap, (const int*)n_rows,
      n_parts, (int*)hash, (int*)pid);
  return (int)cudaGetLastError();
}

}  // extern "C"
