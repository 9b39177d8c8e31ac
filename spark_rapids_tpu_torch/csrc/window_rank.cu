// K21 window_rank: row_number, rank and dense_rank over a sorted batch, and
// the source rows of lead/lag (its offset mode).
//
// Replaces spark_rapids_tpu/ops/window.py:row_number_k (161), rank_k (169)
// and the index half of shift_in_segment (190) (B15). The batch is sorted by
// (partition keys, order keys), its first *n_live rows live. K3
// (segment_bounds.cu) gives, over the partition keys, each row's segment id
// and each segment's first row (seg_first[g]), and over partition + order
// keys each row's peer group (tie run) id and each peer group's first row.
// Then, for a live row i of segment g and peer group p:
//   row_number = i - seg_first[g] + 1
//   rank       = peer_first[p] - seg_first[g] + 1
//   dense_rank = p - peer_ids[seg_first[g]] + 1
// and 0 on the other rows. The offset mode writes for every row its source
// row i + offset clamped into [0, cap) and whether that row is live and in
// the same segment (the reference tests against the capacity, so its lead
// reads a padding row past the last segment: ROADMAP's reference faults).
//
// Bound on the card: bytes (a few int32 loads a row, one int32 or 9 bytes
// written). Design: one thread a row, no shared state; the loads through
// seg_first and peer_first hit the same few lines for a segment's rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum RankKind { ROW_NUMBER = 0, RANK = 1, DENSE_RANK = 2 };

__global__ void rank_kernel(int kind, const int* seg_ids,
                            const int* seg_first, const int* peer_ids,
                            const int* peer_first, const int* n_live,
                            long long cap, int* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap) return;
  if (i >= (long long)*n_live) {
    out[i] = 0;
    return;
  }
  const int first = seg_first[seg_ids[i]];
  int r;
  if (kind == ROW_NUMBER) {
    r = (int)(i - first + 1);
  } else if (kind == RANK) {
    r = peer_first[peer_ids[i]] - first + 1;
  } else {
    r = peer_ids[i] - peer_ids[first] + 1;
  }
  out[i] = r;
}

__global__ void offset_kernel(const int* seg_ids, const int* n_live,
                              long long cap, long long offset,
                              long long* src, uint8_t* same) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap) return;
  const long long n = *n_live;
  const long long j = i + offset;
  const long long jc = j < 0 ? 0 : (j >= cap ? cap - 1 : j);
  src[i] = jc;
  same[i] = (i < n && j >= 0 && j < n && seg_ids[j] == seg_ids[i]) ? 1 : 0;
}

int num_blocks(long long cap) {
  const long long b = (cap + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// kind: 0 row_number, 1 rank, 2 dense_rank (peer_ids/peer_first unused for
// row_number). All index arrays int32[cap]; n_live int32[1] on the device.
// Returns 0 or the CUDA error of the launch.
int window_rank(int kind, const void* seg_ids, const void* seg_first,
                const void* peer_ids, const void* peer_first,
                const void* n_live, long long cap, void* out, void* stream) {
  if (cap < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (kind != ROW_NUMBER && (peer_ids == nullptr || peer_first == nullptr))
    return (int)cudaErrorInvalidValue;
  rank_kernel<<<num_blocks(cap), kThreads, 0, (cudaStream_t)stream>>>(
      kind, (const int*)seg_ids, (const int*)seg_first,
      (const int*)peer_ids, (const int*)peer_first, (const int*)n_live, cap,
      (int*)out);
  return (int)cudaGetLastError();
}

// src: int64[cap]; same: uint8[cap] (torch.bool).
int window_offset(const void* seg_ids, const void* n_live, long long cap,
                  long long offset, void* src, void* same, void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  offset_kernel<<<num_blocks(cap), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seg_ids, (const int*)n_live, cap, offset, (long long*)src,
      (uint8_t*)same);
  return (int)cudaGetLastError();
}

}  // extern "C"
