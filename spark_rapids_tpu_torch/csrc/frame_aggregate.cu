// K24 frame_aggregate: count(*), count, sum, avg, min and max over each row's
// [lo, hi] frame (frame_bounds.cu, K23).
//
// Replaces spark_rapids_tpu/ops/window.py:bounded_frame_agg (373) and
// _prefix_pad (368) (B15). For a live row with a non-empty frame [lo, hi]
// (inside its segment): count(*) is hi - lo + 1; count, sum, avg, min and
// max aggregate the rows of the frame whose value is valid; sum, avg, min
// and max are NULL when there is none. An empty frame (hi < lo) gives count
// 0 and NULL for the rest. Types as segmented_scan.cu's; min and max in
// Spark's order (window_common.cuh). Dead rows are zero and NULL.
//
// The reference builds a doubling table of log2(cap) full copies of the
// column for min/max (27 x 512 MB at lineitem's 2^26 rows), and takes float
// sums as differences of one prefix over the whole batch, so one NaN or
// infinity makes every later frame's sum NaN. Here a frame of at most
// kDirect rows is aggregated directly, in row order. A wider frame takes
// count, sum and avg from the segment-local running count and sum that
// segmented_scan.cu wrote (prefix and pcount: the value at hi less the value
// before lo, inside the segment; a float prefix holds the finite values
// only, and nonfinite the packed count of the others, so a frame's NaN and
// infinities come from its difference too), and min and max from a
// two-level table: each aligned block of kBlock rows reduced to one order
// key, and a sparse table over those blocks (log2(cap / kBlock) levels,
// 1/kBlock of the reference's bytes); the frame's partial blocks at either
// end are read directly. Every row's work is bounded (at most 2 kBlock + 2
// loads on the wide path), so a frame with an unbounded end stays linear in
// its segment.
//
// Bound on the card: bytes (values, validity, bounds and prefixes read once,
// the result written once). Design: one thread a row; the table builds in
// one launch for the block keys and one a level.
#include "window_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 32;
constexpr long long kDirect = 2 * kBlock;

struct Params {
  int op;
  int dcode;
  const void* data;
  const uint8_t* valid;
  const int* seg_ids;
  const int* n_live;
  long long cap;
  const int* lo;
  const int* hi;
  const void* prefix;          // running sum: int64, or finite doubles
  const long long* pcount;     // running count of valid rows
  const long long* nonfinite;  // a float sum's running packed count of
                               // NaN and infinities (segmented_scan.cu)
  const long long* table;      // [levels][nb] order keys (MIN/MAX)
  long long nb;
  void* out;
  uint8_t* out_valid;
};

__global__ void block_keys_kernel(Params p, long long* level0) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= p.nb) return;
  const long long n = *p.n_live;
  long long k = win::key_identity(p.op);
  const long long r0 = b * kBlock;
  for (long long r = r0; r < r0 + kBlock && r < n; ++r)
    if (p.valid[r])
      k = win::best(p.op, k, win::order_key(p.data, p.dcode, r));
  level0[b] = k;
}

// level[j] = best(prev[j], prev[j + half]): 2 * half blocks.
__global__ void level_kernel(int op, const long long* prev, long long* level,
                             long long nb, long long half) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= nb) return;
  level[j] =
      j + half < nb ? win::best(op, prev[j], prev[j + half]) : prev[j];
}

// The best order key over rows [lo, hi] (at least one whole block).
__device__ __forceinline__ long long table_query(const Params& p,
                                                 long long lo, long long hi) {
  const long long bl = (lo + kBlock - 1) / kBlock;  // first whole block
  const long long bh = (hi + 1) / kBlock - 1;       // last whole block
  long long k = win::key_identity(p.op);
  for (long long j = lo; j < bl * kBlock; ++j)
    if (p.valid[j])
      k = win::best(p.op, k, win::order_key(p.data, p.dcode, j));
  const int lvl = 63 - __clzll(bh - bl + 1);
  const long long* t = p.table + (long long)lvl * p.nb;
  k = win::best(p.op, k, t[bl]);
  k = win::best(p.op, k, t[bh - (1LL << lvl) + 1]);
  for (long long j = (bh + 1) * kBlock; j <= hi; ++j)
    if (p.valid[j])
      k = win::best(p.op, k, win::order_key(p.data, p.dcode, j));
  return k;
}

__device__ __forceinline__ long long before(const Params& p,
                                           const long long* a, long long lo) {
  return (lo > 0 && p.seg_ids[lo - 1] == p.seg_ids[lo]) ? a[lo - 1] : 0;
}

__device__ __forceinline__ double before_f(const Params& p, const double* a,
                                           long long lo) {
  return (lo > 0 && p.seg_ids[lo - 1] == p.seg_ids[lo]) ? a[lo - 1] : 0.0;
}

__global__ void agg_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.cap) return;
  const int op = p.op;
  const long long n = *p.n_live;
  const bool fsum = win::is_float(p.dcode);
  const bool ext = op == win::MIN || op == win::MAX;
  const long long lo = p.lo[i];
  const long long hi = p.hi[i];
  const long long width = hi - lo + 1;
  if (i >= n || width <= 0 || op == win::COUNT_STAR) {
    const bool live = i < n;
    if (op == win::COUNT_STAR || op == win::COUNT) {
      ((long long*)p.out)[i] =
          (live && width > 0 && op == win::COUNT_STAR) ? width : 0;
      p.out_valid[i] = live ? 1 : 0;
    } else {
      if (ext) win::store_zero(p.out, p.dcode, i);
      else if (fsum || op == win::AVG) ((double*)p.out)[i] = 0.0;
      else ((long long*)p.out)[i] = 0;
      p.out_valid[i] = 0;
    }
    return;
  }
  long long cnt = 0;
  long long isum = 0;
  double fsum_v = 0.0;
  long long key = win::key_identity(op);
  if (width <= kDirect) {
    for (long long j = lo; j <= hi; ++j) {
      if (!p.valid[j]) continue;
      ++cnt;
      if (ext) {
        key = win::best(op, key, win::order_key(p.data, p.dcode, j));
      } else if (op != win::COUNT) {
        if (fsum) fsum_v += win::load_float(p.data, p.dcode, j);
        else isum = win::wrap_add(isum, win::load_int(p.data, p.dcode, j));
      }
    }
  } else {
    cnt = p.pcount[hi] - before(p, p.pcount, lo);
    if (op == win::SUM || op == win::AVG) {
      if (fsum) {
        // low half: NaN and -inf values; high half: NaN and +inf
        const unsigned long long nf = (unsigned long long)win::wrap_sub(
            p.nonfinite[hi], before(p, p.nonfinite, lo));
        const bool neg = (nf & 0xFFFFFFFFULL) != 0;
        const bool pos = (nf >> 32) != 0;
        const double* pf = (const double*)p.prefix;
        if (neg && pos) fsum_v = (double)NAN;
        else if (pos) fsum_v = (double)INFINITY;
        else if (neg) fsum_v = -(double)INFINITY;
        else fsum_v = pf[hi] - before_f(p, pf, lo);
      } else {
        const long long* pi = (const long long*)p.prefix;
        isum = win::wrap_sub(pi[hi], before(p, pi, lo));
      }
    } else if (ext) {
      key = table_query(p, lo, hi);
    }
  }
  if (op == win::COUNT) {
    ((long long*)p.out)[i] = cnt;
    p.out_valid[i] = 1;
    return;
  }
  const bool has = cnt > 0;
  if (op == win::SUM) {
    if (fsum) ((double*)p.out)[i] = has ? fsum_v : 0.0;
    else ((long long*)p.out)[i] = has ? isum : 0;
  } else if (op == win::AVG) {
    ((double*)p.out)[i] =
        has ? (fsum ? fsum_v : (double)isum) / (double)cnt : 0.0;
  } else if (has) {
    win::store_key(p.out, p.dcode, i, key);
  } else {
    win::store_zero(p.out, p.dcode, i);
  }
  p.out_valid[i] = has ? 1 : 0;
}

unsigned grid(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// Rows of one block of the min/max table.
int frame_aggregate_block_rows() { return kBlock; }

// op: ops/aggregates.py _OPS code; dcode its _DCODES code. data/valid NULL
// for count(*). seg_ids, lo, hi int32[cap]; n_live int32[1]. prefix (sum,
// avg: int64 for integer input, finite-only doubles for float input),
// nonfinite (a float sum or avg) and pcount (count, sum, avg, min, max) are
// segmented_scan.cu's running sum, packed non-finite count and count.
// table: int64[levels * nb] scratch for min/max (nb = ceil(cap / block
// rows), levels = bit length of nb), else NULL. Returns 0 or the CUDA error
// of a launch.
int frame_aggregate(int op, int dcode, const void* data, const void* valid,
                    const void* seg_ids, const void* n_live, long long cap,
                    const void* lo, const void* hi, const void* prefix,
                    const void* pcount, const void* nonfinite, void* table,
                    int levels, void* out, void* out_valid, void* stream) {
  if (cap < 1 || op < win::COUNT_STAR || op > win::MAX)
    return (int)cudaErrorInvalidValue;
  const bool ext = op == win::MIN || op == win::MAX;
  const bool sums = op == win::SUM || op == win::AVG;
  if (op != win::COUNT_STAR && (valid == nullptr || pcount == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sums && (prefix == nullptr ||
               (win::is_float(dcode) && nonfinite == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (ext && (table == nullptr || levels < 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.op = op;
  p.dcode = dcode;
  p.data = data;
  p.valid = (const uint8_t*)valid;
  p.seg_ids = (const int*)seg_ids;
  p.n_live = (const int*)n_live;
  p.cap = cap;
  p.lo = (const int*)lo;
  p.hi = (const int*)hi;
  p.prefix = prefix;
  p.pcount = (const long long*)pcount;
  p.nonfinite = (const long long*)nonfinite;
  p.table = (const long long*)table;
  p.nb = (cap + kBlock - 1) / kBlock;
  p.out = out;
  p.out_valid = (uint8_t*)out_valid;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (ext) {
    long long* t = (long long*)table;
    block_keys_kernel<<<grid(p.nb), kThreads, 0, s>>>(p, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int l = 1; l < levels; ++l) {
      level_kernel<<<grid(p.nb), kThreads, 0, s>>>(
          op, t + (long long)(l - 1) * p.nb, t + (long long)l * p.nb, p.nb,
          1LL << (l - 1));
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  agg_kernel<<<grid(cap), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
