// Aggregate accumulator shared by masked_reduce.cu (K1) and
// segment_reduce.cu (K4).
//
// One Acc holds everything any of the eight aggregate ops needs: the live
// and contributing row counts, the NaN count (float MIN/MAX) and one 8-byte
// value (wrapping integer sum, f64 sum, integral or f64 extreme, or a row
// index for FIRST/LAST). Update and combine are templated on the op so each
// instantiation touches only the fields it needs. Combine is applied in row
// order everywhere (left operand = earlier rows), so every reduction tree
// built from it has a fixed shape and float sums come out bit-identical from
// run to run.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

enum AggOp {
  OP_COUNT_STAR = 0,
  OP_COUNT = 1,
  OP_SUM = 2,
  OP_AVG = 3,
  OP_MIN = 4,
  OP_MAX = 5,
  OP_FIRST = 6,
  OP_LAST = 7,
};

// Storage codes of the input column (bool rides as I8: values are 0/1).
enum DCode { D_I8 = 0, D_I16 = 1, D_I32 = 2, D_I64 = 3, D_F32 = 4, D_F64 = 5 };

struct Acc {
  long long n_live;  // live rows
  long long n_pick;  // live and valid rows
  long long n_nan;   // live, valid NaN rows (float MIN/MAX)
  union {
    unsigned long long u;  // integral SUM, wraps mod 2^64
    long long i;           // integral MIN/MAX, FIRST/LAST row index
    double f;              // float SUM/AVG, float MIN/MAX of non-NaN values
  } v;
};

template <typename T> struct IsFloat { static constexpr bool value = false; };
template <> struct IsFloat<float> { static constexpr bool value = true; };
template <> struct IsFloat<double> { static constexpr bool value = true; };

template <int OP, typename T>
__device__ __forceinline__ Acc acc_identity() {
  Acc a;
  a.n_live = 0;
  a.n_pick = 0;
  a.n_nan = 0;
  a.v.u = 0ull;
  if (OP == OP_SUM) {
    if (IsFloat<T>::value) a.v.f = 0.0;
  } else if (OP == OP_AVG) {
    a.v.f = 0.0;
  } else if (OP == OP_MIN) {
    if (IsFloat<T>::value) a.v.f = INFINITY; else a.v.i = LLONG_MAX;
  } else if (OP == OP_MAX) {
    if (IsFloat<T>::value) a.v.f = -INFINITY; else a.v.i = LLONG_MIN;
  } else if (OP == OP_FIRST) {
    a.v.i = LLONG_MAX;
  } else if (OP == OP_LAST) {
    a.v.i = -1;
  }
  return a;
}

// Fold row i into a. Dead rows touch nothing.
template <int OP, typename T>
__device__ __forceinline__ void acc_update(Acc& a, const T* data,
                                           const uint8_t* valid, long long i,
                                           bool live, int ignore_nulls) {
  if (!live) return;
  a.n_live += 1;
  if (OP == OP_COUNT_STAR) return;
  const bool vld = valid[i] != 0;
  if (vld) a.n_pick += 1;
  if (OP == OP_FIRST || OP == OP_LAST) {
    const bool pick = ignore_nulls ? vld : true;
    if (pick) {
      if (OP == OP_FIRST) a.v.i = i < a.v.i ? i : a.v.i;
      else a.v.i = i > a.v.i ? i : a.v.i;
    }
    return;
  }
  if (!vld || OP == OP_COUNT) return;
  const T x = data[i];
  if (OP == OP_SUM) {
    if (IsFloat<T>::value) a.v.f += (double)x;
    else a.v.u += (unsigned long long)(long long)x;
  } else if (OP == OP_AVG) {
    a.v.f += (double)x;
  } else if (IsFloat<T>::value) {  // float MIN / MAX
    const double d = (double)x;
    if (isnan(d)) {
      a.n_nan += 1;
    } else if (OP == OP_MIN) {
      if (d < a.v.f) a.v.f = d;
    } else {
      if (d > a.v.f) a.v.f = d;
    }
  } else {  // integral MIN / MAX
    const long long y = (long long)x;
    if (OP == OP_MIN) a.v.i = y < a.v.i ? y : a.v.i;
    else a.v.i = y > a.v.i ? y : a.v.i;
  }
}

// a := a (earlier rows) combined with b (later rows).
template <int OP, typename T>
__device__ __forceinline__ void acc_combine(Acc& a, const Acc& b) {
  a.n_live += b.n_live;
  a.n_pick += b.n_pick;
  a.n_nan += b.n_nan;
  if (OP == OP_SUM) {
    if (IsFloat<T>::value) a.v.f += b.v.f; else a.v.u += b.v.u;
  } else if (OP == OP_AVG) {
    a.v.f += b.v.f;
  } else if (OP == OP_MIN) {
    if (IsFloat<T>::value) { if (b.v.f < a.v.f) a.v.f = b.v.f; }
    else if (b.v.i < a.v.i) a.v.i = b.v.i;
  } else if (OP == OP_MAX) {
    if (IsFloat<T>::value) { if (b.v.f > a.v.f) a.v.f = b.v.f; }
    else if (b.v.i > a.v.i) a.v.i = b.v.i;
  } else if (OP == OP_FIRST) {
    if (b.v.i < a.v.i) a.v.i = b.v.i;
  } else if (OP == OP_LAST) {
    if (b.v.i > a.v.i) a.v.i = b.v.i;
  }
}

// Output element type of an op over input type T: counts and integral sums
// are int64, float sums and averages f64, MIN/MAX/FIRST/LAST keep T.
template <int OP, typename T> struct OutType { typedef T type; };
template <typename T> struct OutType<OP_COUNT_STAR, T> { typedef long long type; };
template <typename T> struct OutType<OP_COUNT, T> { typedef long long type; };
template <typename T> struct OutType<OP_AVG, T> { typedef double type; };
template <typename T> struct OutType<OP_SUM, T> {
  typedef typename std::conditional<IsFloat<T>::value, double, long long>::type type;
};

// Write one finished accumulator to slot `slot` with the semantics of
// ops/aggregates.py:segment_aggregate. reduce_mode switches to
// reduce_aggregate's slot-0 semantics: counts are always valid and every
// other value is zeroed where it is NULL.
template <int OP, typename T>
__device__ __forceinline__ void acc_write(const Acc& a, const T* data,
                                          const uint8_t* valid, void* out,
                                          uint8_t* out_valid, long long slot,
                                          bool reduce_mode) {
  typedef typename OutType<OP, T>::type O;
  O* o = (O*)out;
  if (OP == OP_COUNT_STAR || OP == OP_COUNT) {
    o[slot] = (O)(OP == OP_COUNT_STAR ? a.n_live : a.n_pick);
    out_valid[slot] = reduce_mode ? 1 : (a.n_live > 0);
    return;
  }
  if (OP == OP_FIRST || OP == OP_LAST) {
    const long long idx = a.v.i;
    const bool has = OP == OP_FIRST ? idx != LLONG_MAX : idx >= 0;
    const bool v = has && valid[idx] != 0;
    T x = has ? data[idx] : (T)0;
    if (reduce_mode && !v) x = (T)0;
    o[slot] = (O)x;
    out_valid[slot] = v;
    return;
  }
  const bool has = a.n_pick > 0;
  O x = (O)0;
  if (has) {
    if (OP == OP_SUM) {
      if (IsFloat<T>::value) x = (O)a.v.f; else x = (O)(long long)a.v.u;
    } else if (OP == OP_AVG) {
      x = (O)(a.v.f / (double)a.n_pick);
    } else if (IsFloat<T>::value) {
      // Spark total order: NaN is largest. MIN is NaN only when every
      // contributing value is NaN; MAX is NaN when any is.
      double r;
      if (OP == OP_MIN) r = (a.n_pick - a.n_nan > 0) ? a.v.f : (double)NAN;
      else r = a.n_nan > 0 ? (double)NAN : a.v.f;
      x = (O)r;
    } else {
      x = (O)a.v.i;
    }
  }
  o[slot] = x;
  out_valid[slot] = has;
}

// Launch-time dispatch over (op, storage code). F is a functor template
// instantiated as F<OP, T>::run(args...).
#define AGG_DISPATCH_T(OPV, DC, F, ...)                                   \
  switch (DC) {                                                           \
    case D_I8: return F<OPV, int8_t>::run(__VA_ARGS__);                   \
    case D_I16: return F<OPV, int16_t>::run(__VA_ARGS__);                 \
    case D_I32: return F<OPV, int32_t>::run(__VA_ARGS__);                 \
    case D_I64: return F<OPV, long long>::run(__VA_ARGS__);               \
    case D_F32: return F<OPV, float>::run(__VA_ARGS__);                   \
    case D_F64: return F<OPV, double>::run(__VA_ARGS__);                  \
    default: return (int)cudaErrorInvalidValue;                           \
  }

#define AGG_DISPATCH(OP, DC, F, ...)                                      \
  switch (OP) {                                                           \
    case OP_COUNT_STAR: AGG_DISPATCH_T(OP_COUNT_STAR, DC, F, __VA_ARGS__) \
    case OP_COUNT: AGG_DISPATCH_T(OP_COUNT, DC, F, __VA_ARGS__)           \
    case OP_SUM: AGG_DISPATCH_T(OP_SUM, DC, F, __VA_ARGS__)               \
    case OP_AVG: AGG_DISPATCH_T(OP_AVG, DC, F, __VA_ARGS__)               \
    case OP_MIN: AGG_DISPATCH_T(OP_MIN, DC, F, __VA_ARGS__)               \
    case OP_MAX: AGG_DISPATCH_T(OP_MAX, DC, F, __VA_ARGS__)               \
    case OP_FIRST: AGG_DISPATCH_T(OP_FIRST, DC, F, __VA_ARGS__)           \
    case OP_LAST: AGG_DISPATCH_T(OP_LAST, DC, F, __VA_ARGS__)             \
    default: return (int)cudaErrorInvalidValue;                           \
  }
