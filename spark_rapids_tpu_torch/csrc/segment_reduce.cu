// K4 segment_reduce: aggregate of one column over runs of sorted segment ids.
//
// Replaces spark_rapids_tpu/ops/aggregates.py:segment_aggregate (the
// scatter segment_sum/min/max group-by update, B5) and
// segment_aggregate_matmul (the MXU one-hot matmul form, B4): COUNT(*),
// COUNT, SUM, AVG, MIN, MAX, FIRST and LAST of data into kb slots, slot g
// taking the live rows with seg_ids == g. Rows must come sorted by group:
// seg_ids is nondecreasing over the live rows, as the sort-based group-by
// produces it. Slots that no live row reaches are zeroed and invalid.
//
// Bound on the card: bytes (data, validity, live mask and the int32 ids,
// 14 bytes a row for f64; each input read once). The hard part is the
// shape of the segments, which varies from a few huge runs (q1 on TPC-H
// data: 6 groups of ~175K rows in a 2^20-row batch) to millions of one-row
// runs (the merge of partials). Neither may serialize.
// Design: each thread walks 16 consecutive rows in order; a run that starts
// and ends inside its rows is finished and written straight to its slot,
// while the first and last run of the 16 rows (which may continue into the
// neighbours) are kept as partials. The same walk then runs over the
// partials of a warp (lane 0), of the block (thread 0) and, in a second
// launch of one block, over the blocks in order. Every combine is in row
// order with a fixed shape, so float sums are reproducible, and there are
// no atomics.
#include "agg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr long long kRowsPerBlock = (long long)kThreads * kRowsPerThread;

struct Part {
  long long seg;  // -1: empty
  Acc acc;
};

struct Summary {
  Part first;  // first run of the range (may continue to the left)
  Part last;   // last run of the range when it differs from the first
};

__device__ __forceinline__ Part empty_part() {
  Part p;
  p.seg = -1;
  p.acc.n_live = 0;
  p.acc.n_pick = 0;
  p.acc.n_nan = 0;
  p.acc.v.u = 0ull;
  return p;
}

// In-order walk over the partials of a range. Runs that close with both
// neighbours inside the range are finished and written to the output.
template <int OP, typename T>
struct Walker {
  Part head;
  Part open;
  bool head_open;
  const T* data;
  const uint8_t* valid;
  void* out;
  uint8_t* out_valid;
  long long kb;

  __device__ void init(const T* d, const uint8_t* v, void* o, uint8_t* ov,
                       long long k) {
    head = empty_part();
    open = empty_part();
    head_open = false;
    data = d;
    valid = v;
    out = o;
    out_valid = ov;
    kb = k;
  }

  __device__ void emit(const Part& p) {
    if (p.seg >= 0 && p.seg < kb)
      acc_write<OP, T>(p.acc, data, valid, out, out_valid, p.seg, false);
  }

  __device__ void push(const Part& p) {
    if (p.seg < 0) return;
    if (open.seg < 0) {
      open = p;
      head_open = true;
      return;
    }
    if (p.seg == open.seg) {
      acc_combine<OP, T>(open.acc, p.acc);
      return;
    }
    if (head_open) {
      head = open;
      head_open = false;
    } else {
      emit(open);
    }
    open = p;
  }

  __device__ Summary finish() {
    Summary s;
    if (open.seg < 0) {
      s.first = empty_part();
      s.last = empty_part();
    } else if (head_open) {
      s.first = open;
      s.last = empty_part();
    } else {
      s.first = head;
      s.last = open;
    }
    return s;
  }
};

// Combine the per-thread summaries of a block in thread order: lane 0 of
// each warp walks its 32 threads, then thread 0 walks the warps. Returns
// the block summary in thread 0.
template <int OP, typename T>
__device__ Summary block_walk(Summary mine, Summary* sh_t, Summary* sh_w,
                              const T* data, const uint8_t* valid, void* out,
                              uint8_t* out_valid, long long kb) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  sh_t[tid] = mine;
  __syncthreads();
  if (lane == 0) {
    Walker<OP, T> w;
    w.init(data, valid, out, out_valid, kb);
    for (int t = warp * 32; t < warp * 32 + 32; ++t) {
      w.push(sh_t[t].first);
      w.push(sh_t[t].last);
    }
    sh_w[warp] = w.finish();
  }
  __syncthreads();
  Summary s;
  if (tid == 0) {
    Walker<OP, T> w;
    w.init(data, valid, out, out_valid, kb);
    for (int v = 0; v < kWarps; ++v) {
      w.push(sh_w[v].first);
      w.push(sh_w[v].last);
    }
    s = w.finish();
  }
  return s;
}

template <int OP, typename T>
__global__ void init_kernel(void* out, uint8_t* out_valid, long long kb) {
  typedef typename OutType<OP, T>::type O;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < kb;
       s += (long long)gridDim.x * blockDim.x) {
    ((O*)out)[s] = (O)0;
    out_valid[s] = 0;
  }
}

template <int OP, typename T>
__global__ void block_kernel(const T* data, const uint8_t* valid,
                             const int* seg_ids, const uint8_t* live,
                             long long n, int ignore_nulls, long long kb,
                             void* out, uint8_t* out_valid,
                             Summary* block_sums) {
  __shared__ Summary sh_t[kThreads];
  __shared__ Summary sh_w[kWarps];
  Walker<OP, T> w;
  w.init(data, valid, out, out_valid, kb);
  const long long lo = (long long)blockIdx.x * kRowsPerBlock +
                       (long long)threadIdx.x * kRowsPerThread;
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long i = lo + r;
    if (i >= n) break;
    if (!live[i]) continue;
    const int seg = seg_ids[i];
    if (seg < 0 || seg >= kb) continue;
    Part p;
    p.seg = seg;
    p.acc = acc_identity<OP, T>();
    acc_update<OP, T>(p.acc, data, valid, i, true, ignore_nulls);
    w.push(p);
  }
  Summary s = block_walk<OP, T>(w.finish(), sh_t, sh_w, data, valid, out,
                                out_valid, kb);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = s;
}

template <int OP, typename T>
__global__ void final_kernel(const T* data, const uint8_t* valid,
                             const Summary* block_sums, int nblocks,
                             long long kb, void* out, uint8_t* out_valid) {
  __shared__ Summary sh_t[kThreads];
  __shared__ Summary sh_w[kWarps];
  Walker<OP, T> w;
  w.init(data, valid, out, out_valid, kb);
  // thread t walks a contiguous range of block summaries, in block order
  const int per = (nblocks + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  for (int b = b0; b < b0 + per && b < nblocks; ++b) {
    w.push(block_sums[b].first);
    w.push(block_sums[b].last);
  }
  Summary s = block_walk<OP, T>(w.finish(), sh_t, sh_w, data, valid, out,
                                out_valid, kb);
  if (threadIdx.x == 0) {
    // nothing lies beyond the whole input: both open runs are finished
    w.init(data, valid, out, out_valid, kb);
    w.emit(s.first);
    w.emit(s.last);
  }
}

int num_blocks(long long n) {
  long long b = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  return (int)(b < 1 ? 1 : b);
}

template <int OP, typename T>
struct Launch {
  static int run(const void* data, const void* valid, const void* seg_ids,
                 const void* live, long long n, int ignore_nulls, long long kb,
                 void* out, void* out_valid, void* scratch,
                 cudaStream_t stream) {
    const int nb = num_blocks(n);
    long long ib = (kb + kThreads - 1) / kThreads;
    if (ib < 1) ib = 1;
    if (ib > 4096) ib = 4096;
    init_kernel<OP, T><<<(int)ib, kThreads, 0, stream>>>(
        out, (uint8_t*)out_valid, kb);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    block_kernel<OP, T><<<nb, kThreads, 0, stream>>>(
        (const T*)data, (const uint8_t*)valid, (const int*)seg_ids,
        (const uint8_t*)live, n, ignore_nulls, kb, out, (uint8_t*)out_valid,
        (Summary*)scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    final_kernel<OP, T><<<1, kThreads, 0, stream>>>(
        (const T*)data, (const uint8_t*)valid, (const Summary*)scratch, nb, kb,
        out, (uint8_t*)out_valid);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Bytes of scratch segment_reduce needs for n rows.
long long segment_reduce_scratch_bytes(long long n) {
  return (long long)num_blocks(n) * (long long)sizeof(Summary);
}

// Returns 0 or the CUDA error of the launch.
int segment_reduce(int op, int dcode, const void* data, const void* valid,
                   const void* seg_ids, const void* live, long long n,
                   int ignore_nulls, long long kb, void* out, void* out_valid,
                   void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  AGG_DISPATCH(op, dcode, Launch, data, valid, seg_ids, live, n, ignore_nulls,
               kb, out, out_valid, scratch, s)
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
