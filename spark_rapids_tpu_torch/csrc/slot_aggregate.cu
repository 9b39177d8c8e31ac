// K9 slot_aggregate: per-slot aggregate features of the rows, for at most
// 4096 slots, in any row order.
//
// Replaces spark_rapids_tpu/ops/aggregates.py:groupby_dense's one-hot MXU
// reduction (_onehot_feature_sums with the hi/lo f32 split and the int64
// nibble planes, B2), segment_aggregate_matmul (B4) and segment_aggregate
// with few segments. A row's slot is key - rmin with NULL keys in the last
// slot (key mode, clipped to [0, K) as groupby_dense clips), or ids[i]
// (ids mode, where rows with an id outside [0, K) are dropped, as the
// one-hot and the scatter drop them). Rows are live when i < n, i < *nrows
// (when given) and live[i] (when given). Each feature is one of:
//   OCC    live rows                      (int64 count)
//   CNT    live rows with valid[i]        (int64 count)
//   ISUM   wrapping int64 sum of data     (Spark bigint: mod 2^64)
//   NAN    live valid NaN rows            (int64 count)
//   IMIN/IMAX  int64 min/max of data
//   FMIN/FMAX  min/max of the f64 non-NaN values, as order-encoded bits
//              (-0.0 below +0.0, as the scatter min/max order them)
//   FIRST/LAST least/greatest row index (valid: the pick mask, or null for
//              every live row)
//   FSUM   f64 sum of data (a NaN makes only its own slot's sum NaN)
// The caller assembles COUNT, SUM, AVG, MIN, MAX, FIRST and LAST from them
// (ops/aggregates.py), as groupby_dense assembles its one-hot sums.
//
// No TPU workaround is carried over: values accumulate natively in f64 and
// int64 in shared memory, with no one-hot matmul, hi/lo split or nibbles.
//
// Determinism: two calls on the same input give the same bits. Integer
// features use shared-memory atomics, whose result does not depend on
// order (sums mod 2^64, min/max, row indices). f64 sums never use atomics:
// a block takes its rows in steps of 256 (32 per warp); in each step a warp
// groups its rows by slot (match_any), every group sums its lanes' values
// in lane order (one shuffle round per lane of the largest group: usually
// one or two), and then the warps take turns, in warp order between
// barriers, adding their group sums to the block's slot accumulators. Each
// block writes one partial; a second launch folds the partials over the
// blocks in index order. The shape of all of this depends on n, K and the
// feature counts alone.
//
// Bound on the card: bytes (each input read once: key or id, validities,
// live mask, the data of each feature; the partials are a few MB). Budget:
// a block holds one 8-byte accumulator per slot and feature, in at most
// 227 KB (7 features at 4096 slots): the wrapper splits the features over
// launches when they do not fit. One copy per block (not one per warp)
// keeps several blocks on an SM to hide the loads' latency.
#include "agg_common.cuh"

namespace {

enum FeatKind {
  FK_OCC = 0,
  FK_CNT = 1,
  FK_ISUM = 2,
  FK_NAN = 3,
  FK_IMIN = 4,
  FK_IMAX = 5,
  FK_FMIN = 6,
  FK_FMAX = 7,
  FK_FIRST = 8,
  FK_LAST = 9,
  FK_FSUM = 10,
};

constexpr int kMaxFeat = 16;
constexpr int kWarps = 8;
constexpr long long kMaxParts = 528;           // four blocks per SM of an H100
constexpr long long kMinRowsPerPart = 16384;
constexpr long long kSmemMax = 232448;         // 227 KB opt-in per block
constexpr int kFoldThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Feat {
  const void* data;
  const uint8_t* valid;
  int kind;
  int dcode;
};

// Passed to the kernels by value: no descriptor needs a device copy.
struct Feats {
  Feat f[kMaxFeat];
};

struct SlotSrc {
  const void* key;       // key mode when not null
  const uint8_t* kvalid;
  const long long* rmin;  // device int64[1]
  const int* ids;        // ids mode
  int key_dcode;
  int pad;
};

long long rows_per_part(long long n) {
  long long r = (n + kMaxParts - 1) / kMaxParts;
  return r < kMinRowsPerPart ? kMinRowsPerPart : r;
}

long long num_parts(long long n) {
  const long long p = (n + rows_per_part(n) - 1) / rows_per_part(n);
  return p < 1 ? 1 : p;
}

__device__ __forceinline__ long long load_i(const void* p, int dc,
                                            long long i) {
  switch (dc) {
    case D_I8: return ((const int8_t*)p)[i];
    case D_I16: return ((const int16_t*)p)[i];
    case D_I32: return ((const int32_t*)p)[i];
    case D_I64: return ((const long long*)p)[i];
    default: return 0;
  }
}

__device__ __forceinline__ double load_f(const void* p, int dc, long long i) {
  if (dc == D_F64) return ((const double*)p)[i];
  if (dc == D_F32) return (double)((const float*)p)[i];
  return (double)load_i(p, dc, i);
}

// Order-preserving int64 image of a non-NaN double.
__device__ __forceinline__ long long order_bits(double d) {
  const long long b = __double_as_longlong(d);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

__device__ __forceinline__ long long ident(int kind) {
  switch (kind) {
    case FK_IMIN: case FK_FMIN: case FK_FIRST: return LLONG_MAX;
    case FK_IMAX: case FK_FMAX: case FK_LAST: return LLONG_MIN;
    default: return 0;
  }
}

__device__ __forceinline__ long long combine(int kind, long long a,
                                             long long b) {
  switch (kind) {
    case FK_IMIN: case FK_FMIN: case FK_FIRST: return a < b ? a : b;
    case FK_IMAX: case FK_FMAX: case FK_LAST: return a > b ? a : b;
    default: return (long long)((unsigned long long)a + (unsigned long long)b);
  }
}

__device__ __forceinline__ void int_update(unsigned long long* acc,
                                           const Feat& f, long long i) {
  long long* sacc = (long long*)acc;
  switch (f.kind) {
    case FK_OCC:
      atomicAdd(acc, 1ull);
      break;
    case FK_CNT:
      if (f.valid[i]) atomicAdd(acc, 1ull);
      break;
    case FK_ISUM:
      if (f.valid[i])
        atomicAdd(acc, (unsigned long long)load_i(f.data, f.dcode, i));
      break;
    case FK_NAN:
      if (f.valid[i] && isnan(load_f(f.data, f.dcode, i))) atomicAdd(acc, 1ull);
      break;
    case FK_IMIN:
      if (f.valid[i]) atomicMin(sacc, load_i(f.data, f.dcode, i));
      break;
    case FK_IMAX:
      if (f.valid[i]) atomicMax(sacc, load_i(f.data, f.dcode, i));
      break;
    case FK_FMIN:
    case FK_FMAX:
      if (f.valid[i]) {
        const double d = load_f(f.data, f.dcode, i);
        if (!isnan(d)) {
          if (f.kind == FK_FMIN) atomicMin(sacc, order_bits(d));
          else atomicMax(sacc, order_bits(d));
        }
      }
      break;
    case FK_FIRST:
      if (f.valid == nullptr || f.valid[i]) atomicMin(sacc, i);
      break;
    case FK_LAST:
      if (f.valid == nullptr || f.valid[i]) atomicMax(sacc, i);
      break;
    default:
      break;
  }
}

__global__ void slot_partial(SlotSrc src, const uint8_t* live,
                             const int* nrows, long long n, Feats fs, int nI,
                             int nF, int K, long long part_rows,
                             long long* part_i, double* part_f) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* acc_i = smem;
  double* acc_f = reinterpret_cast<double*>(smem + (long long)nI * K);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < nI * K; j += blockDim.x)
    acc_i[j] = (unsigned long long)ident(fs.f[j / K].kind);
  for (int j = threadIdx.x; j < nF * K; j += blockDim.x) acc_f[j] = 0.0;
  __syncthreads();

  long long lim = n;
  if (nrows != nullptr && (long long)*nrows < lim) lim = (long long)*nrows;
  const long long lo = (long long)blockIdx.x * part_rows;
  const long long hi = lo + part_rows < lim ? lo + part_rows : lim;
  const long long rmin = src.key != nullptr ? *src.rmin : 0;

  // the step loop is the same for every thread of the block: all 32 lanes
  // of a warp run match_any and the shuffles together, and every warp
  // reaches every barrier of the turns
  for (long long step = lo; step < hi; step += kWarps * 32) {
    const long long i = step + warp * 32 + lane;
    bool lv = i < hi && (live == nullptr || live[i] != 0);
    int slot = 0;
    if (lv) {
      if (src.key != nullptr) {
        if (src.kvalid[i] == 0) {
          slot = K - 1;
        } else {
          const int d = (int)(load_i(src.key, src.key_dcode, i) - rmin);
          slot = d < 0 ? 0 : (d > K - 1 ? K - 1 : d);
        }
      } else {
        slot = src.ids[i];
        lv = slot >= 0 && slot < K;
      }
    }
    if (lv) {
      for (int f = 0; f < nI; ++f)
        int_update(acc_i + (long long)f * K + slot, fs.f[f], i);
    }
    if (nF > 0) {
      // lanes of one slot form a group (a dead lane is a group of its
      // own); each group sums its lanes' values in lane order, in as many
      // rounds as the largest group has lanes
      const unsigned grp = __match_any_sync(kFull, lv ? slot : -1 - lane);
      const int size = __popc(grp);
      const int rounds = (int)__reduce_max_sync(kFull, (unsigned)size);
      const int leader = __ffs(grp) - 1;
      for (int f = 0; f < nF; ++f) {
        const Feat& ft = fs.f[nI + f];
        double v = 0.0;
        if (lv && ft.valid[i] != 0) v = load_f(ft.data, ft.dcode, i);
        double s = 0.0;
        unsigned rest = grp;
        for (int r = 0; r < rounds; ++r) {
          const int from = rest != 0u ? __ffs(rest) - 1 : lane;
          rest &= rest - 1u;
          const double vr = __shfl_sync(kFull, v, from);
          if (r < size) s += vr;
        }
        for (int w = 0; w < kWarps; ++w) {   // warps in order
          if (w == warp && lv && lane == leader)
            acc_f[(long long)f * K + slot] += s;
          __syncthreads();
        }
      }
    }
  }
  __syncthreads();

  long long* pi = part_i + (long long)blockIdx.x * nI * K;
  for (int j = threadIdx.x; j < nI * K; j += blockDim.x)
    pi[j] = (long long)acc_i[j];
  double* pf = part_f + (long long)blockIdx.x * nF * K;
  for (int j = threadIdx.x; j < nF * K; j += blockDim.x) pf[j] = acc_f[j];
}

__global__ void slot_fold(const long long* part_i, const double* part_f,
                          int nparts, Feats fs, int nI, int nF, int K,
                          long long* out_i, double* out_f) {
  const long long t = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  const long long ni = (long long)nI * K;
  const long long nf = (long long)nF * K;
  if (t < ni) {
    const int kind = fs.f[t / K].kind;
    long long a = ident(kind);
    for (int p = 0; p < nparts; ++p) a = combine(kind, a, part_i[p * ni + t]);
    out_i[t] = a;
  } else if (t < ni + nf) {
    const long long u = t - ni;
    double s = 0.0;
    for (int p = 0; p < nparts; ++p) s += part_f[p * nf + u];
    out_f[u] = s;
  }
}

}  // namespace

extern "C" {

int slot_aggregate_max_features() { return kMaxFeat; }

// Bytes of scratch for n rows (the per-block partials).
long long slot_aggregate_scratch_bytes(long long n, int nI, int nF, int K) {
  return num_parts(n) * (long long)(nI + nF) * K * 8;
}

// Key mode: key (key_dcode D_I8..D_I64, bool as D_I8), kvalid and rmin
// (device int64[1]) given, ids null. Ids mode: key null, ids int32[n].
// live and nrows (int32[1]) may be null. Features: nI int features then nF
// f64 features (FSUM), nI + nF <= 16. Writes out_i int64[nI * K] and
// out_f f64[nF * K], feature-major. Returns 0 or the CUDA error.
int slot_aggregate(const void* key, const void* kvalid, const void* rmin,
                   int key_dcode, const void* ids, const void* live,
                   const void* nrows, long long n, int K,
                   const void* const* feat_data,
                   const void* const* feat_valid, const int* feat_kind,
                   const int* feat_dcode, int nI, int nF, void* scratch,
                   void* out_i, void* out_f, void* stream) {
  if (K < 1 || nI < 0 || nF < 0 || nI + nF < 1 || nI + nF > kMaxFeat)
    return (int)cudaErrorInvalidValue;
  if (key == nullptr && ids == nullptr) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)(nI + nF) * K * 8;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  Feats fs;
  for (int f = 0; f < kMaxFeat; ++f) {
    const bool on = f < nI + nF;
    fs.f[f].data = on ? feat_data[f] : nullptr;
    fs.f[f].valid = on ? (const uint8_t*)feat_valid[f] : nullptr;
    fs.f[f].kind = on ? feat_kind[f] : 0;
    fs.f[f].dcode = on ? feat_dcode[f] : 0;
  }
  SlotSrc src;
  src.key = key;
  src.kvalid = (const uint8_t*)kvalid;
  src.rmin = (const long long*)rmin;
  src.ids = (const int*)ids;
  src.key_dcode = key_dcode;
  src.pad = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nparts = num_parts(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        slot_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long* part_i = (long long*)scratch;
  double* part_f = (double*)(part_i + nparts * nI * K);
  slot_partial<<<(int)nparts, kWarps * 32, (size_t)smem, s>>>(
      src, (const uint8_t*)live, (const int*)nrows, n, fs, nI, nF, K,
      rows_per_part(n), part_i, part_f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)(nI + nF) * K;
  const int blocks = (int)((total + kFoldThreads - 1) / kFoldThreads);
  slot_fold<<<blocks, kFoldThreads, 0, s>>>(part_i, part_f, (int)nparts, fs,
                                           nI, nF, K, (long long*)out_i,
                                           (double*)out_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
