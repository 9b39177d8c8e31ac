// K22 segmented_scan: running (UNBOUNDED PRECEDING .. CURRENT ROW) window
// aggregates, a scan that starts again at every segment.
//
// Replaces spark_rapids_tpu/ops/window.py:running_agg (213), _seg_base (264)
// and _segmented_scan (274) (B15). Over a batch sorted by segment (int32
// seg_ids, nondecreasing over the first *n_live rows, which are live), row i
// gets the aggregate of the contributing rows from its segment's first row
// to i: count(*) counts live rows; count, sum, avg, min and max the live
// rows whose value is valid. Results as the reference's: count and count(*)
// int64 and valid; sum int64 for integer input (wrapping) and double for
// float input; avg double (an integer sum is converted at the end); min and
// max the input's type, in Spark's order (window_common.cuh); sum, avg,
// min and max are NULL until the segment's first valid value. out_count, when
// given, gets the running count of contributing rows. With out_nonfinite
// (a float sum only) the sum skips NaN and +-inf (they still count), and
// out_nonfinite gets the running packed count of them: each NaN adds
// 1 + 2^32, each +inf 2^32 and each -inf 1, so the low 32 bits count the
// NaN and -inf values and the high ones the NaN and +inf values
// (frame_aggregate.cu's prefix: a frame's sum is NaN when both are nonzero,
// else +inf or -inf by the one that is). Dead rows are zero and NULL.
//
// The reference sums a float prefix over the whole batch and subtracts the
// prefix at the segment start, which loses the low digits of a segment's
// sum once the batch's prefix is large (l_extendedprice's reaches ~3e12
// over lineitem at SF 10). This is a true segmented scan: a segment's sum
// is taken over its own rows only.
//
// Bound on the card: bytes (the values, validity and ids read once, the
// results and counts written once). Design: the three-pass grid scan of
// scan_common.cuh over a segmented carry (reset flag, count, int or key,
// double): a tile of kTile rows (kItems a thread) reduces to one carry, one
// block scans the tile carries, and each tile rescans its rows from its
// incoming carry. The combine is associative, so the result is the same
// from run to run; float sums add in tile order, not row order.
#include "window_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr long long kTile = (long long)kThreads * kItems;
constexpr int kCarryThreads = 1024;

struct Carry {
  long long cnt;   // contributing rows
  long long iv;    // integer sum, the MIN/MAX order key, or a float sum's
                   // packed non-finite count
  double fv;       // float sum
  int flag;        // a segment starts in the rows this carry covers
};

struct Params {
  int op;
  int dcode;
  const void* data;
  const uint8_t* valid;
  const int* seg_ids;
  const int* n_live;
  long long cap;
  void* out;
  uint8_t* out_valid;
  long long* out_count;
  long long* out_nonfinite;
};

__device__ __forceinline__ Carry identity(int op) {
  Carry c;
  c.cnt = 0;
  c.iv = (op == win::MIN || op == win::MAX) ? win::key_identity(op) : 0;
  c.fv = 0.0;
  c.flag = 0;
  return c;
}

// a covers earlier rows than b.
__device__ __forceinline__ Carry combine(int op, const Carry& a,
                                         const Carry& b) {
  if (b.flag) return b;
  Carry r;
  r.flag = a.flag;
  r.cnt = a.cnt + b.cnt;
  r.iv = (op == win::MIN || op == win::MAX) ? win::best(op, a.iv, b.iv)
                                            : win::wrap_add(a.iv, b.iv);
  r.fv = a.fv + b.fv;
  return r;
}

__device__ __forceinline__ Carry element(const Params& p, long long i,
                                         long long n) {
  Carry c = identity(p.op);
  if (i >= n) return c;
  c.flag = (i == 0 || p.seg_ids[i] != p.seg_ids[i - 1]) ? 1 : 0;
  if (p.op != win::COUNT_STAR && p.valid[i] == 0) return c;
  c.cnt = 1;
  if (p.op == win::MIN || p.op == win::MAX) {
    c.iv = win::order_key(p.data, p.dcode, i);
  } else if (p.op == win::SUM || p.op == win::AVG) {
    if (win::is_float(p.dcode)) {
      const double v = win::load_float(p.data, p.dcode, i);
      if (p.out_nonfinite != nullptr && !isfinite(v)) {
        c.iv = isnan(v) ? (1LL << 32) + 1 : (v > 0 ? 1LL << 32 : 1);
      } else {
        c.fv = v;
      }
    } else {
      c.iv = win::load_int(p.data, p.dcode, i);
    }
  }
  return c;
}

__device__ __forceinline__ void write_out(const Params& p, long long i,
                                          long long n, const Carry& r) {
  const bool live = i < n;
  if (p.out_count != nullptr) p.out_count[i] = live ? r.cnt : 0;
  if (p.out_nonfinite != nullptr) p.out_nonfinite[i] = live ? r.iv : 0;
  const bool has = live && r.cnt > 0;
  const bool fsum = win::is_float(p.dcode);
  switch (p.op) {
    case win::COUNT_STAR:
    case win::COUNT:
      ((long long*)p.out)[i] = live ? r.cnt : 0;
      p.out_valid[i] = live ? 1 : 0;
      return;
    case win::SUM:
      if (fsum) ((double*)p.out)[i] = has ? r.fv : 0.0;
      else ((long long*)p.out)[i] = has ? r.iv : 0;
      break;
    case win::AVG:
      ((double*)p.out)[i] =
          has ? (fsum ? r.fv : (double)r.iv) / (double)r.cnt : 0.0;
      break;
    default:
      if (has) win::store_key(p.out, p.dcode, i, r.iv);
      else win::store_zero(p.out, p.dcode, i);
  }
  p.out_valid[i] = has ? 1 : 0;
}

// Inclusive scan of x over a block of THREADS threads through sh[THREADS];
// on return sh holds every thread's inclusive carry.
template <int THREADS>
__device__ __forceinline__ Carry block_scan(int op, Carry x, Carry* sh) {
  const int t = threadIdx.x;
  sh[t] = x;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    Carry y = x;
    if (t >= off) y = combine(op, sh[t - off], x);
    __syncthreads();
    sh[t] = y;
    x = y;
    __syncthreads();
  }
  return x;
}

__global__ void tile_kernel(Params p, Carry* tiles) {
  __shared__ Carry sh[kThreads];
  const long long n = *p.n_live;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  Carry acc = identity(p.op);
  for (int k = 0; k < kItems; ++k) acc = combine(p.op, acc,
                                                 element(p, base + k, n));
  const Carry incl = block_scan<kThreads>(p.op, acc, sh);
  if (threadIdx.x == kThreads - 1) tiles[blockIdx.x] = incl;
}

// Tile carries -> each tile's incoming (exclusive) carry, in place.
__global__ void carry_kernel(int op, Carry* tiles, long long nt) {
  __shared__ Carry sh[kCarryThreads];
  const long long per = (nt + kCarryThreads - 1) / kCarryThreads;
  const long long b0 = (long long)threadIdx.x * per;
  Carry acc = identity(op);
  for (long long b = b0; b < b0 + per && b < nt; ++b)
    acc = combine(op, acc, tiles[b]);
  block_scan<kCarryThreads>(op, acc, sh);
  Carry run = threadIdx.x > 0 ? sh[threadIdx.x - 1] : identity(op);
  for (long long b = b0; b < b0 + per && b < nt; ++b) {
    const Carry c = tiles[b];
    tiles[b] = run;
    run = combine(op, run, c);
  }
}

__global__ void out_kernel(Params p, const Carry* tiles) {
  __shared__ Carry sh[kThreads];
  const long long n = *p.n_live;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  Carry acc = identity(p.op);
  for (int k = 0; k < kItems; ++k) acc = combine(p.op, acc,
                                                 element(p, base + k, n));
  block_scan<kThreads>(p.op, acc, sh);
  Carry run = combine(p.op, tiles[blockIdx.x],
                      threadIdx.x > 0 ? sh[threadIdx.x - 1]
                                      : identity(p.op));
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i >= p.cap) return;
    run = combine(p.op, run, element(p, i, n));
    write_out(p, i, n, run);
  }
}

long long num_tiles(long long cap) {
  const long long t = (cap + kTile - 1) / kTile;
  return t < 1 ? 1 : t;
}

}  // namespace

extern "C" {

long long segmented_scan_scratch_bytes(long long cap) {
  return num_tiles(cap) * (long long)sizeof(Carry);
}

// op: ops/aggregates.py _OPS code (count_star 0 .. max 5); dcode: its
// _DCODES storage code (unused for the counts). data/valid may be NULL for
// count(*). seg_ids int32[cap], n_live int32[1]; out by op (see above),
// out_valid uint8[cap], out_count int64[cap] or NULL, out_nonfinite
// int64[cap] (a float SUM only, see above) or NULL. Returns 0 or the CUDA
// error of a launch.
int segmented_scan(int op, int dcode, const void* data, const void* valid,
                   const void* seg_ids, const void* n_live, long long cap,
                   void* out, void* out_valid, void* out_count,
                   void* out_nonfinite, void* scratch, void* stream) {
  if (cap < 1 || op < win::COUNT_STAR || op > win::MAX)
    return (int)cudaErrorInvalidValue;
  if (op != win::COUNT_STAR && valid == nullptr)
    return (int)cudaErrorInvalidValue;
  if (out_nonfinite != nullptr && (op != win::SUM || !win::is_float(dcode)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.op = op;
  p.dcode = dcode;
  p.data = data;
  p.valid = (const uint8_t*)valid;
  p.seg_ids = (const int*)seg_ids;
  p.n_live = (const int*)n_live;
  p.cap = cap;
  p.out = out;
  p.out_valid = (uint8_t*)out_valid;
  p.out_count = (long long*)out_count;
  p.out_nonfinite = (long long*)out_nonfinite;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nt = num_tiles(cap);
  Carry* tiles = (Carry*)scratch;
  tile_kernel<<<(unsigned)nt, kThreads, 0, s>>>(p, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  carry_kernel<<<1, kCarryThreads, 0, s>>>(op, tiles, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  out_kernel<<<(unsigned)nt, kThreads, 0, s>>>(p, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
