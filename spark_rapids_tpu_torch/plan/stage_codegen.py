"""Generated CUDA stage kernels: the port of the reference's whole-stage
programs (spark_rapids_tpu/plan/stage_compiler.py:173 build_stage_program,
plan/physical.py:710 FusedStage and the aggregate's fused update phase).

The reference traces a stage's bound expression trees into one XLA program
per batch shape. Here the same trees become the source of one CUDA kernel
per stage signature, compiled for sm_90a by NVRTC at first use
(native.py) and cached by the hash of its source:

* K19 ``fused_stage``: one thread a row, grid-stride. It reads the stage's
  input columns, evaluates every filter into the live-row mask and every
  output expression into data and validity, in one launch. The outputs are
  a project's columns, a whole stage's columns (then compacted by K5 with
  the mask), or an aggregate's grouping keys and update inputs (the
  aggregate's kernels then take them with the mask).
* K20 ``fused_reduce``: the grouping-free update. It evaluates the stage
  and folds every aggregate's rows into K1's per-block partials, on K1's
  grid, block size and shared-memory tree (csrc/masked_reduce.cu), so K1's
  fold (``masked_reduce_fold``) finishes each result and the sums equal
  the unfused K1 path bit for bit.

Bound on the card: bytes. A row's arithmetic is a few dozen operations
against the bytes of its input and output columns, far under the H100's
ratio of operations to bandwidth; the design keeps every intermediate in
registers, so a stage moves its inputs once and its outputs once instead
of once per torch op.

The source depends on the trees' shapes and dtypes only. Literal values,
NULL flags, string literal bytes and the row count are runtime arguments
in one packed block of 64-bit words, so a stage compiles once whatever
its literals. Each node is emitted as the port's eager op computes it
(ops/*.py): the same NULL and NaN rules, zeroed data where the eager op
zeroes it, integer arithmetic wrapping through unsigned types, floor
division for dates, the saturating float -> integral cast. Compiled with
FMA contraction off and no fast math, ``+ - * /`` come out bit for bit;
the transcendental functions are CUDA's and may differ by a few ulps.

What the generator does not cover (every string expression but a column
compared with literals by ``=``, ``<>`` and IN, and any other class
without a handler) is found at plan time: :func:`decline_reason` names
it, the planner records it, and that stage runs its eager torch ops.

The per-row function is plain C++ (``__host__ __device__``); the
``__global__`` kernels exist only under ``__CUDACC__``. Built with a host
C++ compiler, the same source gives ``stage_host`` and
``stage_host_reduce``, which the CPU tests run over CPU tensors through
the same argument packing.
"""

from __future__ import annotations

import ctypes
import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, is_nested, storage_dtype
from ..ops import aggregates as agg_k
from ..ops import arithmetic as ar
from ..ops import conditionals as co
from ..ops import datetime as dtm
from ..ops import expressions as ex
from ..ops import math_ops as mo
from ..ops import predicates as pr
from ..ops.cast import _INT_RANGE, MICROS_PER_DAY, MICROS_PER_SECOND, Cast

THREADS = 256
MAX_BLOCKS = 8192
# fixed words at the head of the argument block
W_N, W_NROWS, W_NROWS_PTR, W_NROWS_BYTES, W_STRLIT = range(5)
HEAD_WORDS = 5

_CTYPE = {dt.BOOL: "bool", dt.INT8: "signed char", dt.INT16: "short",
          dt.INT32: "int", dt.INT64: "long long", dt.FLOAT32: "float",
          dt.FLOAT64: "double", dt.DATE: "int", dt.TIMESTAMP: "long long",
          dt.NULLTYPE: "bool"}
# the C type of each of K1's storage codes (csrc/agg_common.cuh DCode)
_DCODE_CTYPE = {0: "signed char", 1: "short", 2: "int", 3: "long long",
                4: "float", 5: "double"}


class Declined(Exception):
    """The generator does not cover an expression of the stage."""


class Materialize(ex.Expression):
    """``materialize(child)``: a scalar child broadcast over the live rows
    (NULL past them), a column as it is. Marks where the eager path
    materializes a value: a projected column, a grouping key, an
    aggregate input, a branch of a conditional."""

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return self.children[0].nullable

    def eval(self, batch: ColumnarBatch):
        return ex.materialize(self.children[0].eval(batch), batch)

    def __repr__(self):
        return f"mat({self.children[0]!r})"


def strip(e: ex.Expression) -> ex.Expression:
    """The expression under its Alias and Materialize wrappers."""
    while isinstance(e, (ex.Alias, Materialize)):
        e = e.children[0]
    return e


def inline(e: ex.Expression, cur: Sequence[ex.Expression]) -> ex.Expression:
    """``e`` (bound to a step's output) rewritten over the stage input:
    each BoundReference replaced by the expression that computed it."""
    def fn(node):
        if isinstance(node, ex.BoundReference):
            return cur[node.ordinal]
        return None
    return e.transform(fn)


def inline_chain(chain, in_schema: dt.Schema
                 ) -> Tuple[List[ex.Expression], List[ex.Expression]]:
    """(filters, columns): a StageChain's filter conditions and its output
    columns, each an expression over the stage input (``chain`` None: no
    filter, the input columns)."""
    cur: List[ex.Expression] = [
        ex.BoundReference(i, f.dtype, f.nullable, f.name)
        for i, f in enumerate(in_schema)]
    filters: List[ex.Expression] = []
    if chain is None:
        return filters, cur
    for step in chain.steps:
        if step[0] == "filter":
            filters.append(inline(step[1], cur))
        else:
            cur = [Materialize(inline(e, cur)) for e in step[1]]
    return filters, cur


# ---------------------------------------------------------------------------
# Constant subtrees: folded once, on the host, as the eager path folds them
# ---------------------------------------------------------------------------

def _has_ref(e: ex.Expression) -> bool:
    return bool(e.collect(lambda x: isinstance(
        x, (ex.BoundReference, ex.ColumnRef))))


def _probe_batch() -> ColumnarBatch:
    col = Column(dt.BOOL, torch.zeros(128, dtype=torch.bool),
                 torch.zeros(128, dtype=torch.bool))
    return ColumnarBatch(dt.Schema([dt.Field("_", dt.BOOL)]), [col], 1)


def fold_constants(roots: Sequence[ex.Expression]) -> Dict[int, Scalar]:
    """id(node) -> Scalar for every maximal subtree without a column
    reference whose eager eval is a scalar (literals, casts of literals,
    arithmetic of literals ...)."""
    out: Dict[int, Scalar] = {}
    probe = _probe_batch()

    def visit(node: ex.Expression) -> None:
        if id(node) in out:
            return
        if not _has_ref(node) and not isinstance(node, Materialize):
            v = node.eval(probe)
            if isinstance(v, Scalar):
                out[id(node)] = v
                return
        for c in node.children:
            visit(c)

    for r in roots:
        visit(r)
    return out


# ---------------------------------------------------------------------------
# The C++ source
# ---------------------------------------------------------------------------

PRELUDE = r"""
#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <string.h>
#define HD inline
#endif
typedef unsigned long long u64;

template <typename T> HD T wadd(T a, T b) { return (T)((u64)(long long)a + (u64)(long long)b); }
template <typename T> HD T wsub(T a, T b) { return (T)((u64)(long long)a - (u64)(long long)b); }
template <typename T> HD T wmul(T a, T b) { return (T)((u64)(long long)a * (u64)(long long)b); }
template <typename T> HD T wneg(T a) { return (T)((u64)0 - (u64)(long long)a); }
// Java's integral / and % with r != 0 (r == -1 never reaches the divide)
template <typename T> HD T idiv(T l, T r) { return r == (T)-1 ? wneg(l) : (T)(l / r); }
template <typename T> HD T irem(T l, T r) { return r == (T)-1 ? (T)0 : (T)(l % r); }
HD float frem(float l, float r) { return fmodf(l, r); }
HD double frem(double l, double r) { return fmod(l, r); }
template <typename T> HD T ipmod(T l, T r) { T m = irem(l, r); return m != (T)0 ? irem(wadd(m, r), r) : m; }
template <typename T> HD T fpmod(T l, T r) { T m = frem(l, r); return m != (T)0 ? frem((T)(m + r), r) : m; }
// floor division and modulo by a positive constant
HD long long fdiv(long long a, long long b) { long long q = a / b; return (a % b != 0 && a < 0) ? q - 1 : q; }
HD long long fmodp(long long a, long long b) { long long m = a % b; return m < 0 ? m + b : m; }
template <typename T> HD bool isnanv(T x) { return x != x; }
// Spark: NaN = NaN, and NaN is larger than every other value
template <typename T> HD bool feq(T l, T r) { return l == r || (isnanv(l) && isnanv(r)); }
template <typename T> HD bool flt(T l, T r) { return l < r || (isnanv(r) && !isnanv(l)); }
HD float ftrunc(float x) { return truncf(x); }
HD double ftrunc(double x) { return trunc(x); }
HD float ffloor(float x) { return floorf(x); }
HD double ffloor(double x) { return floor(x); }
HD float fceil(float x) { return ceilf(x); }
HD double fceil(double x) { return ceil(x); }
HD float fabsv(float x) { return fabsf(x); }
HD double fabsv(double x) { return fabs(x); }
// float -> integral: NaN -> 0, truncate, saturate (ops/cast.py device_cast)
template <typename F> HD long long sat64(F x, long long lo, long long hi) {
  double t = (double)ftrunc(isnanv(x) ? (F)0 : x);
  if (t >= (double)hi) return hi;
  if (t <= (double)lo) return lo;
  return (long long)t;
}
// float -> int64 as a CUDA conversion gives it (NaN -> 0, saturating)
template <typename F> HD long long cvt64(F x) { return sat64(x, (-9223372036854775807LL - 1), 9223372036854775807LL); }
HD double rd_f64(u64 w) { union { u64 u; double d; } c; c.u = w; return c.d; }
HD double pinf() { return rd_f64(0x7FF0000000000000ull); }
HD float rd_f32(u64 w) { union { unsigned int u; float f; } c; c.u = (unsigned int)w; return c.f; }
HD bool str_eq(const unsigned char* row, long long W, int len, const unsigned char* lit, long long L) {
  if ((long long)len != L) return false;
  const long long w = W > L ? W : L;
  for (long long j = 0; j < w; ++j) {
    const unsigned char a = j < W ? row[j] : (unsigned char)0;
    const unsigned char b = j < L ? lit[j] : (unsigned char)0;
    if (a != b) return false;
  }
  return true;
}
// Howard Hinnant's civil calendar (ops/datetime.py)
HD void civil(long long days, long long* y, long long* m, long long* d) {
  const long long z = days + 719468;
  const long long era = fdiv(z, 146097);
  const long long doe = z - era * 146097;
  const long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const long long mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}
HD int from_civil(long long y, long long m, long long d) {
  y = m <= 2 ? y - 1 : y;
  const long long era = fdiv(y, 400);
  const long long yoe = y - era * 400;
  const long long mp = m > 2 ? m - 3 : m + 9;
  const long long doy = (153 * mp + 2) / 5 + d - 1;
  const long long doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return (int)(era * 146097 + doe - 719468);
}
HD long long nrows_of(const u64* w) {
  if (w[2] == 0) return (long long)w[1];
  return w[3] == 4 ? (long long)*(const int*)w[2] : *(const long long*)w[2];
}
"""

# K1's accumulator (csrc/agg_common.cuh): the same layout and the same
# update and combine, so K1's fold reads these partials
ACC = r"""
struct Acc { long long n_live; long long n_pick; long long n_nan; union { u64 u; long long i; double f; } v; };
template <typename T> struct IsF { static const bool value = false; };
template <> struct IsF<float> { static const bool value = true; };
template <> struct IsF<double> { static const bool value = true; };
template <int OP, typename T> HD Acc acc_identity() {
  Acc a; a.n_live = 0; a.n_pick = 0; a.n_nan = 0; a.v.u = 0ull;
  if (OP == 2) { if (IsF<T>::value) a.v.f = 0.0; }
  else if (OP == 3) { a.v.f = 0.0; }
  else if (OP == 4) { if (IsF<T>::value) a.v.f = pinf(); else a.v.i = 9223372036854775807LL; }
  else if (OP == 5) { if (IsF<T>::value) a.v.f = -pinf(); else a.v.i = (-9223372036854775807LL - 1); }
  else if (OP == 6) { a.v.i = 9223372036854775807LL; }
  else if (OP == 7) { a.v.i = -1; }
  return a;
}
template <int OP, typename T> HD void acc_update(Acc& a, T x, bool vld, long long i, bool live, int ignore_nulls) {
  if (!live) return;
  a.n_live += 1;
  if (OP == 0) return;
  if (vld) a.n_pick += 1;
  if (OP == 6 || OP == 7) {
    const bool pick = ignore_nulls ? vld : true;
    if (pick) { if (OP == 6) a.v.i = i < a.v.i ? i : a.v.i; else a.v.i = i > a.v.i ? i : a.v.i; }
    return;
  }
  if (!vld || OP == 1) return;
  if (OP == 2) { if (IsF<T>::value) a.v.f += (double)x; else a.v.u += (u64)(long long)x; }
  else if (OP == 3) { a.v.f += (double)x; }
  else if (IsF<T>::value) {
    const double d = (double)x;
    if (d != d) a.n_nan += 1;
    else if (OP == 4) { if (d < a.v.f) a.v.f = d; }
    else { if (d > a.v.f) a.v.f = d; }
  } else {
    const long long y = (long long)x;
    if (OP == 4) a.v.i = y < a.v.i ? y : a.v.i; else a.v.i = y > a.v.i ? y : a.v.i;
  }
}
template <int OP, typename T> HD void acc_combine(Acc& a, const Acc& b) {
  a.n_live += b.n_live; a.n_pick += b.n_pick; a.n_nan += b.n_nan;
  if (OP == 2) { if (IsF<T>::value) a.v.f += b.v.f; else a.v.u += b.v.u; }
  else if (OP == 3) { a.v.f += b.v.f; }
  else if (OP == 4) { if (IsF<T>::value) { if (b.v.f < a.v.f) a.v.f = b.v.f; } else if (b.v.i < a.v.i) a.v.i = b.v.i; }
  else if (OP == 5) { if (IsF<T>::value) { if (b.v.f > a.v.f) a.v.f = b.v.f; } else if (b.v.i > a.v.i) a.v.i = b.v.i; }
  else if (OP == 6) { if (b.v.i < a.v.i) a.v.i = b.v.i; }
  else if (OP == 7) { if (b.v.i > a.v.i) a.v.i = b.v.i; }
}
"""


class _V:
    """A generated value: C expressions of its data and validity; for a
    string column, the row pointer, width and length instead of data."""

    def __init__(self, d: str, v: str, dtype: dt.DType, row: str = "",
                 width: str = "", length: str = ""):
        self.d, self.v, self.dtype = d, v, dtype
        self.row, self.width, self.length = row, width, length


def _str_name(node: ex.Expression) -> str:
    return type(node).__name__


class StageKernel:
    """One generated kernel. ``mode``: "stage" (outputs and, with filters,
    the keep mask) or "reduce" (the grouping-free update). ``filters`` and
    ``outputs`` are expressions over ``in_schema``; ``specs`` are
    (op, expression or None, ignore_nulls) for "reduce". Raises
    :class:`Declined` when an expression is not covered."""

    def __init__(self, mode: str, in_schema: dt.Schema,
                 filters: Sequence[ex.Expression],
                 outputs: Sequence[ex.Expression] = (),
                 specs: Sequence[tuple] = ()):
        self.mode = mode
        self.in_schema = in_schema
        self.filters = list(filters)
        self.outputs = list(outputs)
        self.specs = list(specs)
        roots = self.filters + self.outputs + \
            [e for _op, e, _ig in self.specs if e is not None]
        self._consts = fold_constants(roots)
        self._words = HEAD_WORDS
        self._lines: List[str] = []
        self._memo: Dict[int, _V] = {}
        self._inputs: Dict[int, int] = {}        # ordinal -> first word
        self._const_words: List[tuple] = []      # (word, value, dtype)
        self._flag_words: List[tuple] = []       # (word, bool)
        self._str_lits: List[tuple] = []         # (word, bytes)
        self._n = 0
        # outputs: ("ref", ordinal) | ("gen", dtype, data word, valid word)
        self.out_kinds: List[tuple] = []
        self.mask_word: Optional[int] = None
        self._generate()
        # nothing to compute: the caller needs no launch
        self.trivial = mode == "stage" and self.mask_word is None and \
            all(k[0] == "ref" for k in self.out_kinds)
        # the entry name carries the hash of the source around it
        source = PRELUDE + (ACC if mode == "reduce" else "") + self._body()
        self.key = hashlib.sha256(source.encode()).hexdigest()[:20]
        self.entry = f"stage_{self.key}"
        self.source = source.replace("ENTRY", self.entry)
        self._template: Optional[ctypes.Array] = None
        self._strbuf: Dict[str, torch.Tensor] = {}

    # -- argument words ------------------------------------------------------
    def _word(self, k: int = 1) -> int:
        w = self._words
        self._words += k
        return w

    def _tmp(self) -> str:
        self._n += 1
        return f"t{self._n}"

    def _emit(self, line: str) -> None:
        self._lines.append("  " + line)

    def _const_slot(self, value, t: dt.DType) -> Tuple[str, str]:
        """A runtime literal of type ``t``: (data expr, valid expr)."""
        w = self._word(2)
        self._const_words.append((w, value, t))
        c = _CTYPE[t]
        d, v = self._tmp(), self._tmp()
        if t == dt.FLOAT64:
            rd = f"rd_f64(P.w[{w}])"
        elif t == dt.FLOAT32:
            rd = f"rd_f32(P.w[{w}])"
        elif t in (dt.BOOL, dt.NULLTYPE):
            rd = f"(P.w[{w}] != 0)"
        else:
            rd = f"({c})(long long)P.w[{w}]"
        self._emit(f"const {c} {d} = {rd};")
        self._emit(f"const bool {v} = P.w[{w + 1}] != 0;")
        return d, v

    def _flag(self, value: bool) -> str:
        w = self._word()
        self._flag_words.append((w, bool(value)))
        return f"(P.w[{w}] != 0)"

    def _str_lit(self, s: Scalar) -> Tuple[str, str, str]:
        """(pointer expr, length expr, valid expr) of a string literal."""
        raw = b"" if s.is_null else (s.value.encode("utf-8") if isinstance(
            s.value, str) else bytes(s.value))
        w = self._word(3)
        self._str_lits.append((w, raw, not s.is_null))
        return (f"((const unsigned char*)P.w[{W_STRLIT}] + P.w[{w}])",
                f"(long long)P.w[{w + 1}]", f"(P.w[{w + 2}] != 0)")

    # -- values --------------------------------------------------------------
    def _is_const(self, node) -> bool:
        return id(node) in self._consts

    def operand(self, node: ex.Expression, t: dt.DType) -> _V:
        """``data_validity(node.eval(b), t)``: a literal converted to ``t``
        and valid on every row, a column as it is."""
        if self._is_const(node):
            s = self._consts[id(node)]
            if t == dt.STRING:
                raise Declined(f"string expression not generated "
                               f"({_str_name(node)})")
            d, v = self._const_slot(s.value, t)
            return _V(d, v, t)
        return self.val(node)

    def mat(self, node: ex.Expression) -> _V:
        """``materialize(node.eval(b), b)``: a literal broadcast over the
        live rows only."""
        if self._is_const(node):
            s = self._consts[id(node)]
            t = s.dtype
            if t == dt.STRING:
                raise Declined("string expression not generated "
                               "(a string literal column)")
            if t == dt.NULLTYPE or s.is_null:
                return _V("false" if t in (dt.BOOL, dt.NULLTYPE)
                          else f"({_CTYPE[t]})0", "false",
                          dt.BOOL if t == dt.NULLTYPE else t)
            d, v = self._const_slot(s.value, t)
            md, mv = self._tmp(), self._tmp()
            self._emit(f"const bool {mv} = {v} && i < nrows;")
            self._emit(f"const {_CTYPE[t]} {md} = {mv} ? {d} : "
                       f"({_CTYPE[t]})0;")
            return _V(md, mv, t)
        return self.val(node)

    def taken(self, node: ex.Expression) -> str:
        """``_bool_mask``: a predicate's rows taken (NULL not taken)."""
        if self._is_const(node):
            s = self._consts[id(node)]
            return "true" if (not s.is_null and bool(s.value)) else "false"
        p = self.val(node)
        return f"({p.d} && {p.v})"

    def val(self, node: ex.Expression) -> _V:
        hit = self._memo.get(id(node))
        if hit is not None:
            return hit
        if self._is_const(node):
            raise Declined(f"expression not generated "
                           f"(a constant {_str_name(node)} used as a column)")
        out = self._gen(node)
        self._memo[id(node)] = out
        return out

    def _decline(self, node) -> Declined:
        stringy = node.dtype == dt.STRING or any(
            c.dtype == dt.STRING for c in node.children)
        what = "string expression" if stringy else "expression"
        return Declined(f"{what} not generated ({_str_name(node)})")

    def _declared(self, t: dt.DType, expr: str, valid: str) -> _V:
        d, v = self._tmp(), self._tmp()
        self._emit(f"const bool {v} = {valid};")
        self._emit(f"const {_CTYPE[t]} {d} = {expr};")
        return _V(d, v, t)

    def _zeroed(self, t: dt.DType, valid: str, expr: str) -> _V:
        """Data zeroed where invalid (the eager ops' ``where(v, x, 0)``)."""
        c = _CTYPE[t]
        return self._declared(t, f"{valid} ? ({c})({expr}) : ({c})0", valid)

    def _gen(self, node: ex.Expression) -> _V:  # noqa: C901 - one dispatch
        if isinstance(node, ex.BoundReference):
            return self._input(node.ordinal)
        if isinstance(node, Materialize):
            return self.mat(node.children[0])
        if isinstance(node, (ex.Alias, ar.UnaryPositive)):
            return self.val(node.children[0])
        nested = [t for t in [node.dtype] + [c.dtype for c in node.children]
                  if is_nested(t)]
        if nested:
            # a deliberate difference: the reference fuses an array index
            raise Declined(f"expression not generated (reads a {nested[0]} "
                           "value)")
        if node.dtype == dt.STRING:
            raise self._decline(node)
        if isinstance(node, ar.BinaryArithmetic):
            return self._arith(node)
        if isinstance(node, ar.UnaryMinus):
            x = self.val(node.children[0])
            e = f"-{x.d}" if node.dtype.is_floating else f"wneg({x.d})"
            return self._declared(node.dtype, e, x.v)
        if isinstance(node, ar.Abs):
            x = self.val(node.children[0])
            e = f"fabsv({x.d})" if node.dtype.is_floating else \
                f"({x.d} < 0 ? wneg({x.d}) : {x.d})"
            return self._declared(node.dtype, e, x.v)
        if isinstance(node, (pr.EqualTo, pr.NotEqual)) and \
                node.children[0].dtype == dt.STRING:
            return self._string_eq(node)
        if isinstance(node, pr.BinaryComparison):
            return self._compare(node)
        if isinstance(node, pr.EqualNullSafe):
            return self._eq_null_safe(node)
        if isinstance(node, (pr.And, pr.Or)):
            a = self.operand(node.children[0], dt.BOOL)
            b = self.operand(node.children[1], dt.BOOL)
            if isinstance(node, pr.And):
                valid = (f"({a.v} && !{a.d}) || ({b.v} && !{b.d}) || "
                         f"({a.v} && {b.v})")
                v = self._tmp()
                self._emit(f"const bool {v} = {valid};")
                return self._declared(dt.BOOL, f"{a.d} && {b.d} && {v}", v)
            lt, rt = self._tmp(), self._tmp()
            self._emit(f"const bool {lt} = {a.v} && {a.d};")
            self._emit(f"const bool {rt} = {b.v} && {b.d};")
            return self._declared(dt.BOOL, f"{lt} || {rt}",
                                  f"{lt} || {rt} || ({a.v} && {b.v})")
        if isinstance(node, pr.Not):
            x = self.val(node.children[0])
            return self._declared(dt.BOOL, f"!{x.d} && {x.v}", x.v)
        if isinstance(node, (pr.IsNull, pr.IsNotNull)):
            x = self.val(node.children[0])
            e = f"!{x.v}" if isinstance(node, pr.IsNull) else x.v
            return self._declared(dt.BOOL, f"({e}) && i < nrows",
                                  "i < nrows")
        if isinstance(node, pr.IsNaN):
            x = self.val(node.children[0])
            nan = f"isnanv({x.d})" if x.dtype.is_floating else "false"
            return self._declared(dt.BOOL, f"{nan} && {x.v}", "i < nrows")
        if isinstance(node, pr.In):
            return self._in(node)
        if isinstance(node, Cast):
            return self._cast(node)
        if isinstance(node, (co.If, co.CaseWhen, co.Coalesce, co.NullIf,
                             co._MinMaxN)):
            return self._conditional(node)
        if isinstance(node, (dtm._DatePart, dtm._DateBinary,
                             dtm._TimestampUnary)):
            return self._datetime(node)
        if isinstance(node, (mo.UnaryMath, mo._Rounding, mo._BinaryMath,
                             mo.Round)):
            return self._math(node)
        raise self._decline(node)

    def _input(self, ordinal: int) -> _V:
        t = self.in_schema[ordinal].dtype
        w = self._inputs.get(ordinal)
        if w is None:
            w = self._inputs[ordinal] = self._word(
                4 if t == dt.STRING else 2)
        v = self._tmp()
        self._emit(f"const bool {v} = ((const bool*)P.w[{w + 1}])[i];")
        if t == dt.STRING:
            row, wd, ln = self._tmp(), self._tmp(), self._tmp()
            self._emit(f"const long long {wd} = (long long)P.w[{w + 3}];")
            self._emit(f"const unsigned char* {row} = (const unsigned "
                       f"char*)P.w[{w}] + i * {wd};")
            self._emit(f"const int {ln} = ((const int*)P.w[{w + 2}])[i];")
            return _V("", v, t, row, wd, ln)
        if t not in _CTYPE:
            raise Declined(f"expression not generated (a {t} column)")
        d = self._tmp()
        c = _CTYPE[t]
        self._emit(f"const {c} {d} = ((const {c}*)P.w[{w}])[i];")
        return _V(d, v, t)

    # -- families ------------------------------------------------------------
    def _arith(self, node) -> _V:
        t = node.dtype
        l_node, r_node = node.children
        if isinstance(node, ar.IntegralDivide):
            lt = l_node.dtype
            if not lt.is_integral:
                raise Declined("expression not generated (IntegralDivide "
                               "of floats)")
            a = self.operand(l_node, dt.INT64)
            b = self.operand(r_node, dt.INT64)
            # a literal operand is int64 and widens the division (eager's
            # type promotion); two columns divide in their own type
            c = "long long" if self._is_const(l_node) or \
                self._is_const(r_node) else _CTYPE[lt]
            valid = f"{a.v} && {b.v} && {b.d} != 0"
            return self._zeroed(t, valid, f"(long long)idiv(({c}){a.d}, "
                                          f"({c}){b.d})")
        a = self.operand(l_node, t)
        b = self.operand(r_node, t)
        c = _CTYPE[t]
        flt = t.is_floating
        if t not in _CTYPE or t in (dt.BOOL, dt.NULLTYPE):
            raise self._decline(node)
        valid = f"{a.v} && {b.v}"
        if isinstance(node, ar.Divide):
            if not flt:
                raise self._decline(node)
            return self._zeroed(t, f"{valid} && {b.d} != 0",
                                f"{a.d} / {b.d}")
        if isinstance(node, (ar.Remainder, ar.Pmod)):
            fn = ("frem" if flt else "irem") if isinstance(
                node, ar.Remainder) else ("fpmod" if flt else "ipmod")
            return self._zeroed(t, f"{valid} && {b.d} != 0",
                                f"{fn}<{c}>(({c}){a.d}, ({c}){b.d})"
                                if not (flt and fn == "frem") else
                                f"frem(({c}){a.d}, ({c}){b.d})")
        op = {ar.Add: ("+", "wadd"), ar.Subtract: ("-", "wsub"),
              ar.Multiply: ("*", "wmul")}.get(type(node))
        if op is None:
            raise self._decline(node)
        e = f"({c})({a.d} {op[0]} {b.d})" if flt else \
            f"{op[1]}<{c}>({a.d}, {b.d})"
        return self._zeroed(t, valid, e)

    def _cmp_expr(self, node, a: str, b: str, t: dt.DType) -> str:
        if t.is_floating:
            return {pr.EqualTo: f"feq({a}, {b})",
                    pr.NotEqual: f"!feq({a}, {b})",
                    pr.LessThan: f"flt({a}, {b})",
                    pr.LessThanOrEqual: f"(flt({a}, {b}) || feq({a}, {b}))",
                    pr.GreaterThan: f"flt({b}, {a})",
                    pr.GreaterThanOrEqual:
                        f"(flt({b}, {a}) || feq({a}, {b}))"}[type(node)]
        sym = {pr.EqualTo: "==", pr.NotEqual: "!=", pr.LessThan: "<",
               pr.LessThanOrEqual: "<=", pr.GreaterThan: ">",
               pr.GreaterThanOrEqual: ">="}[type(node)]
        return f"({a} {sym} {b})"

    def _compare(self, node) -> _V:
        t = node.children[0].dtype
        if t == dt.STRING or t not in _CTYPE:
            raise self._decline(node)
        a = self.operand(node.children[0], t)
        b = self.operand(node.children[1], t)
        v = self._tmp()
        self._emit(f"const bool {v} = {a.v} && {b.v};")
        return self._declared(
            dt.BOOL, f"{self._cmp_expr(node, a.d, b.d, t)} && {v}", v)

    def _string_side(self, node) -> Tuple[_V, Scalar]:
        """(column value, literal) of a string compare, or Declined."""
        l_node, r_node = node.children
        if self._is_const(r_node) and not self._is_const(l_node):
            col_node, lit = l_node, self._consts[id(r_node)]
        elif self._is_const(l_node) and not self._is_const(r_node):
            col_node, lit = r_node, self._consts[id(l_node)]
        else:
            raise self._decline(node)
        col = self.val(col_node)
        if col.dtype != dt.STRING or not col.row:
            raise self._decline(node)
        return col, lit

    def _string_eq(self, node) -> _V:
        col, lit = self._string_side(node)
        p, n, k = self._str_lit(lit)
        eq, v = self._tmp(), self._tmp()
        self._emit(f"const bool {v} = {col.v} && {k};")
        self._emit(f"const bool {eq} = str_eq({col.row}, {col.width}, "
                   f"{col.length}, {p}, {n});")
        e = eq if isinstance(node, pr.EqualTo) else f"!{eq}"
        return self._declared(dt.BOOL, f"{e} && {v}", v)

    def _eq_null_safe(self, node) -> _V:
        t = node.children[0].dtype
        if t == dt.STRING or t not in _CTYPE:
            raise self._decline(node)
        a = self.operand(node.children[0], t)
        b = self.operand(node.children[1], t)
        eq = f"feq({a.d}, {b.d})" if t.is_floating else \
            f"({a.d} == {b.d})"
        return self._declared(
            dt.BOOL, f"(({a.v} && {b.v}) ? {eq} : ({a.v} == {b.v})) && "
                     f"i < nrows", "i < nrows")

    def _in(self, node: pr.In) -> _V:
        child = node.children[0]
        t = child.dtype
        has_null = self._flag(any(x is None for x in node.values))
        concrete = [x for x in node.values if x is not None]
        terms = []
        if t == dt.STRING:
            if self._is_const(child):
                raise self._decline(node)
            col = self.val(child)
            for x in concrete:
                p, n, _k = self._str_lit(Scalar(x, dt.STRING))
                terms.append(f"str_eq({col.row}, {col.width}, "
                             f"{col.length}, {p}, {n})")
            cv = col.v
        else:
            if t not in _CTYPE:
                raise self._decline(node)
            x = self.operand(child, t)
            for value in concrete:
                d, _k = self._const_slot(value, t)
                terms.append(f"({x.d} == {d})")
            cv = x.v
        match, v = self._tmp(), self._tmp()
        self._emit(f"const bool {match} = "
                   f"{' || '.join(terms) if terms else 'false'};")
        self._emit(f"const bool {v} = {cv} && ({match} || !{has_null});")
        return self._declared(dt.BOOL, f"{match} && {v}", v)

    def _cast(self, node: Cast) -> _V:
        src, dst = node.children[0].dtype, node.to
        if dt.STRING in (src, dst) or dst not in _CTYPE or \
                src not in _CTYPE:
            raise self._decline(node)
        x = self.val(node.children[0])
        if src == dst:
            return x
        c = _CTYPE[dst]
        d = x.d
        if dst == dt.BOOL:
            e = f"{d} != 0"
        elif src in (dt.BOOL, dt.NULLTYPE):
            e = f"({c})({d} ? 1 : 0)"
        elif src == dt.DATE and dst == dt.TIMESTAMP:
            e = f"wmul<long long>((long long){d}, {MICROS_PER_DAY}LL)"
        elif src == dt.TIMESTAMP and dst == dt.DATE:
            e = f"(int)fdiv({d}, {MICROS_PER_DAY}LL)"
        elif src == dt.TIMESTAMP and dst.is_integral:
            e = f"({c})fdiv({d}, {MICROS_PER_SECOND}LL)"
        elif src.is_integral and dst == dt.TIMESTAMP:
            e = f"wmul<long long>((long long){d}, {MICROS_PER_SECOND}LL)"
        elif src == dt.TIMESTAMP and dst.is_floating:
            if dst != dt.FLOAT64:
                raise self._decline(node)
            e = f"(double){d} / {float(MICROS_PER_SECOND)!r}"
        elif src.is_floating and dst == dt.TIMESTAMP:
            e = f"cvt64(({_CTYPE[src]})({d} * ({_CTYPE[src]})" \
                f"{float(MICROS_PER_SECOND)!r}))"
        elif src.is_floating and dst.is_integral:
            lo, hi = _INT_RANGE[dst]
            e = f"({c})sat64({d}, {lo}LL, {hi}LL)" if lo > -(1 << 63) \
                else f"sat64({d}, (-9223372036854775807LL - 1), " \
                     f"9223372036854775807LL)"
        elif src.is_floating and not dst.is_floating:
            e = f"({c})cvt64({d})"
        else:
            # integral -> integral (wraps), -> float, float <-> float,
            # date <-> int
            e = f"({c}){d}"
        return self._declared(dst, e, x.v)

    def _conditional(self, node) -> _V:
        t = node.dtype
        if t == dt.STRING or t not in _CTYPE:
            raise self._decline(node)
        c = _CTYPE[t if t != dt.NULLTYPE else dt.BOOL]
        if isinstance(node, co.If):
            m = self.taken(node.children[0])
            a = self.mat(node.children[1])
            b = self.mat(node.children[2])
            return self._declared(t, f"{m} ? ({c}){a.d} : ({c}){b.d}",
                                  f"{m} ? {a.v} : {b.v}")
        if isinstance(node, co.NullIf):
            a = self.mat(node.children[0])
            b = self.operand(node.children[1], t)
            eq = f"feq({a.d}, {b.d})" if t.is_floating else \
                f"({a.d} == {b.d})"
            v = self._tmp()
            self._emit(f"const bool {v} = {a.v} && !({eq} && {b.v} && "
                       f"{a.v});")
            return self._zeroed(t, v, a.d)
        rd, rv = self._tmp(), self._tmp()
        self._lines.append(f"  {c} {rd} = ({c})0;")
        self._lines.append(f"  bool {rv} = false;")
        if isinstance(node, co.CaseWhen):
            if node.has_else:
                e = self.mat(node.children[-1])
                self._emit(f"{rd} = ({c}){e.d}; {rv} = {e.v};")
            for i in reversed(range(node.num_branches)):
                m = self.taken(node.children[2 * i])
                val = self.mat(node.children[2 * i + 1])
                self._emit(f"if ({m}) {{ {rd} = ({c}){val.d}; "
                           f"{rv} = {val.v}; }}")
        elif isinstance(node, co.Coalesce):
            dec = self._tmp()
            self._emit(f"bool {dec} = false;")
            for ch in node.children:
                val = self.mat(ch)
                self._emit(f"if (!{dec} && {val.v}) {{ {rd} = ({c}){val.d}; "
                           f"{rv} = true; }}")
                self._emit(f"{dec} = {dec} || {val.v};")
        else:   # Greatest / Least
            for ch in node.children:
                val = self.mat(ch)
                if t.is_floating:
                    better = f"flt({rd}, ({c}){val.d})" if \
                        node._take_greater else f"flt(({c}){val.d}, {rd})"
                else:
                    better = f"(({c}){val.d} > {rd})" if \
                        node._take_greater else f"(({c}){val.d} < {rd})"
                self._emit(f"if ({val.v} && (!{rv} || {better})) {{ "
                           f"{rd} = ({c}){val.d}; {rv} = true; }}")
        return _V(rd, rv, t)

    def _datetime(self, node) -> _V:
        if isinstance(node, dtm._DateBinary):
            return self._date_binary(node)
        child = node.children[0]
        src = child.dtype
        if isinstance(node, dtm.FromUnixTime) and src in _CTYPE and \
                not src.is_floating:
            x = self.val(child)
            return self._zeroed(node.dtype, x.v, f"wmul<long long>((long "
                                f"long){x.d}, {MICROS_PER_SECOND}LL)")
        if src not in (dt.DATE, dt.TIMESTAMP):
            raise self._decline(node)
        if isinstance(node, dtm.ToDate) and src == dt.DATE:
            return self.val(child)
        x = self.val(child)
        if isinstance(node, dtm.UnixTimestamp):
            e = f"wmul<long long>((long long){x.d}, 86400LL)" \
                if src == dt.DATE else f"fdiv({x.d}, {MICROS_PER_SECOND}LL)"
            return self._zeroed(node.dtype, x.v, e)
        if isinstance(node, dtm.ToDate):
            return self._zeroed(node.dtype, x.v,
                                f"(int)fdiv({x.d}, {MICROS_PER_DAY}LL)")
        days = self._tmp()
        if src == dt.TIMESTAMP:
            self._emit(f"const int {days} = (int)fdiv({x.d}, "
                       f"{MICROS_PER_DAY}LL);")
        else:
            self._emit(f"const int {days} = {x.d};")
        if isinstance(node, dtm._TimePart):
            if src != dt.TIMESTAMP:
                raise self._decline(node)
            e = f"(int)fmodp(fdiv(fdiv({x.d}, {MICROS_PER_SECOND}LL), " \
                f"{node._div}LL), {node._mod}LL)"
            return self._zeroed(node.dtype, x.v, e)
        if isinstance(node, dtm.DayOfWeek):
            return self._zeroed(node.dtype, x.v,
                                f"(int)(fmodp((long long){days} + 4, 7) + 1)")
        if isinstance(node, dtm.WeekDay):
            return self._zeroed(node.dtype, x.v,
                                f"(int)fmodp((long long){days} + 3, 7)")
        y, m, d = self._tmp(), self._tmp(), self._tmp()
        self._emit(f"long long {y}, {m}, {d}; civil({days}, &{y}, &{m}, "
                   f"&{d});")
        e = {dtm.Year: f"(int){y}", dtm.Month: f"(int){m}",
             dtm.DayOfMonth: f"(int){d}",
             dtm.Quarter: f"(int)(fdiv((long long)((int){m} - 1), 3) + 1)",
             dtm.DayOfYear: f"wsub<int>({days}, from_civil((long long)"
                            f"(int){y}, 1, 1)) + 1",
             dtm.LastDay: f"from_civil({m} == 12 ? (long long)((int){y} + 1)"
                          f" : (long long)(int){y}, {m} == 12 ? 1 : {m} + 1, "
                          f"1) - 1"}.get(type(node))
        if e is None:
            raise self._decline(node)
        return self._zeroed(node.dtype, x.v, e)

    def _date_binary(self, node) -> _V:
        if node.children[0].dtype != dt.DATE:
            raise self._decline(node)
        a = self.operand(node.children[0], dt.DATE)
        b = self.operand(node.children[1], node.right_type)
        valid = f"{a.v} && {b.v}"
        if isinstance(node, dtm.DateSub):
            e = f"wsub<int>({a.d}, (int){b.d})"
        elif isinstance(node, dtm.DateAdd):
            e = f"wadd<int>({a.d}, (int){b.d})"
        elif isinstance(node, dtm.DateDiff):
            e = f"wsub<int>({a.d}, (int){b.d})"
        elif isinstance(node, dtm.AddMonths):
            y, m, d, tot, ny, nm, ln = (self._tmp() for _ in range(7))
            self._emit(f"long long {y}, {m}, {d}; civil({a.d}, &{y}, &{m}, "
                       f"&{d});")
            self._emit(f"const long long {tot} = (long long)(int){y} * 12 + "
                       f"((int){m} - 1) + (long long){b.d};")
            self._emit(f"const int {ny} = (int)fdiv({tot}, 12);")
            self._emit(f"const int {nm} = (int)(fmodp({tot}, 12) + 1);")
            self._emit(f"const int {ln} = wsub<int>(from_civil({nm} == 12 ? "
                       f"(long long)({ny} + 1) : (long long){ny}, {nm} == 12"
                       f" ? 1 : {nm} + 1, 1), from_civil({ny}, {nm}, 1));")
            e = f"from_civil({ny}, {nm}, (int){d} < {ln} ? (int){d} : {ln})"
        else:
            raise self._decline(node)
        return self._zeroed(node.dtype, valid, e)

    def _math(self, node) -> _V:
        if isinstance(node, mo.UnaryMath):
            x = self.val(node.children[0])
            if x.dtype != dt.FLOAT64:
                raise self._decline(node)
            fn = {"signum": "(({0}) > 0 ? 1.0 : (({0}) < 0 ? -1.0 : ({0})))",
                  "degrees": "(({0}) * 57.29577951308232)",
                  "radians": "(({0}) * 0.017453292519943295)"}.get(
                node.cname, node.cname + "({0})")
            dom = {"Log": ("> 0", "1.0"), "Log10": ("> 0", "1.0"),
                   "Log2": ("> 0", "1.0"), "Log1p": ("> -1", "0.0")}.get(
                type(node).__name__)
            if dom is None:
                return self._zeroed(dt.FLOAT64, x.v, fn.format(x.d))
            ok = self._tmp()
            self._emit(f"const bool {ok} = {x.d} {dom[0]};")
            arg = f"({ok} ? {x.d} : {dom[1]})"
            return self._zeroed(dt.FLOAT64, f"{x.v} && {ok}", fn.format(arg))
        if isinstance(node, mo._Rounding):
            x = self.val(node.children[0])
            if not x.dtype.is_floating:
                return x
            f = "ffloor" if isinstance(node, mo.Floor) else "fceil"
            return self._declared(dt.INT64, f"cvt64({f}({x.d}))", x.v)
        if isinstance(node, mo._BinaryMath):
            a = self.operand(node.children[0], dt.FLOAT64)
            b = self.operand(node.children[1], dt.FLOAT64)
            fn = "pow" if isinstance(node, mo.Pow) else "atan2"
            return self._zeroed(dt.FLOAT64, f"{a.v} && {b.v}",
                                f"{fn}((double){a.d}, (double){b.d})")
        # Round
        x = self.val(node.children[0])
        t = x.dtype
        c = _CTYPE[t]
        if t.is_floating:
            factor = 10.0 ** node.scale
            fl = f"({c}){factor!r}"
            sc, rd = self._tmp(), self._tmp()
            self._emit(f"const {c} {sc} = ({c})(fabsv({x.d}) * {fl});")
            self._emit(f"const {c} {rd} = ({c})(ffloor(({c})({sc} + ({c})0.5"
                       f")) / {fl});")
            return self._declared(t, f"{x.d} < 0 ? -{rd} : {rd}", x.v)
        if node.scale >= 0:
            return x
        f = 10 ** (-node.scale)
        mag = self._tmp()
        self._emit(f"const long long {mag} = (long long){x.d} < 0 ? "
                   f"wneg((long long){x.d}) : (long long){x.d};")
        e = f"wmul<{c}>(({c})wmul<long long>(fdiv(wadd<long long>({mag}, " \
            f"{f // 2}LL), {f}LL), {f}LL), ({c})({x.d} < 0 ? -1 : 1))"
        return self._declared(t, e, x.v)

    # -- the whole kernel ------------------------------------------------------
    def _generate(self) -> None:
        keep = []
        for f in self.filters:
            keep.append(self.taken(f))
        self._keep_expr = " && ".join(["i < nrows"] + keep)
        if self.filters and self.mode == "stage":
            self.mask_word = self._word()
        for e in self.outputs:
            base = strip(e)
            if isinstance(base, ex.BoundReference) and \
                    not self._is_const(base):
                self.out_kinds.append(("ref", base.ordinal))
                continue
            v = self.mat(e)
            if v.dtype == dt.STRING:
                raise Declined("string expression not generated "
                               f"({_str_name(base)})")
            w = self._word(2)
            self.out_kinds.append(("gen", v.dtype, w))
            self._emit(f"if (store) {{ (({_CTYPE[v.dtype]}*)P.w[{w}])[i] = "
                       f"{v.d}; ((bool*)P.w[{w + 1}])[i] = {v.v}; }}")
        self._row_out: List[tuple] = []
        for op, e, _ig in self.specs:
            if e is None:
                self._row_out.append((op, None, None, 0))
                continue
            if op in ("first", "last") and \
                    not isinstance(strip(e), ex.BoundReference):
                raise Declined(f"{op} of a computed value not generated")
            v = self.mat(e)
            if v.dtype == dt.STRING and op != "count":
                raise Declined("string aggregate input not generated "
                               f"({op})")
            if v.dtype == dt.STRING:
                dcode = 0
            elif op == "sum" and v.dtype in (dt.DATE, dt.TIMESTAMP):
                dcode = 5        # SUM of a date is a double sum (K1's)
            else:
                dcode = agg_k._DCODES[storage_dtype(v.dtype)]
            self._row_out.append((op, v, e, dcode))
        if self.mode == "reduce":
            self.spec_parts_word = self._word(len(self._row_out))

    def _body(self) -> str:
        nw = max(self._words, 1)
        lines = "\n".join(self._lines)
        out = [f"struct StageArgs {{ u64 w[{nw}]; }};"]
        if self.mode == "stage":
            out.append(
                "HD void stage_row(const StageArgs& P, long long i, "
                "long long nrows, bool store) {\n" + lines + "\n"
                + (f"  ((bool*)P.w[{self.mask_word}])[i] = "
                   f"{self._keep_expr};\n" if self.mask_word is not None
                   else "") + "}")
            out.append(_STAGE_KERNELS)
            return "\n".join(out) + "\n"
        # reduce: one Acc per spec, the row's values handed over
        fields, assigns, updates, trees = [], [], [], []
        for k, (op, v, _e, dcode) in enumerate(self._row_out):
            code = agg_k._OPS[op]
            ct = _DCODE_CTYPE[dcode]
            if v is None:
                assigns.append(f"  r.x{k} = 0; r.k{k} = true;")
            elif v.dtype == dt.STRING:
                assigns.append(f"  r.x{k} = 0; r.k{k} = {v.v};")
            else:
                assigns.append(f"  r.x{k} = ({ct}){v.d}; r.k{k} = {v.v};")
            fields.append(f"{ct} x{k}; bool k{k};")
            ig = 1 if self.specs[k][2] else 0
            updates.append(f"acc_update<{code}, {ct}>(a{k}, r.x{k}, r.k{k}, "
                           f"i, r.live, {ig});")
            trees.append((code, ct, k))
        out.append("struct Row { bool live; " + " ".join(fields) + " };")
        out.append(
            "HD Row stage_row(const StageArgs& P, long long i, "
            "long long nrows, bool store) {\n" + lines + "\n  Row r;\n"
            + f"  r.live = {self._keep_expr};\n" + "\n".join(assigns)
            + "\n  return r;\n}")
        parts0 = self.spec_parts_word
        decl = "\n".join(f"  Acc a{k} = acc_identity<{c}, {t}>();"
                         for c, t, k in trees)
        upd = "\n".join("    " + u for u in updates)
        tree_code = "\n".join(
            f"  block_tree<{c}, {t}>(sh, a{k});\n"
            f"  if (threadIdx.x == 0) ((Acc*)P.w[{parts0 + k}])"
            f"[blockIdx.x] = sh[0];\n  __syncthreads();"
            for c, t, k in trees)
        host_decl = "\n".join(
            f"      Acc a{k} = acc_identity<{c}, {t}>();" for c, t, k in trees)
        host_upd = "\n".join("        " + u for u in updates)
        host_tree = "\n".join(
            f"    {{ for (int t = 0; t < THREADS; ++t) sh[t] = acc{k}[t];\n"
            f"      for (int s = THREADS / 2; s > 0; s >>= 1)\n"
            f"        for (int t = 0; t < s; ++t) acc_combine<{c}, {t_}>"
            f"(sh[t], sh[t + s]);\n"
            f"      ((Acc*)P.w[{parts0 + k}])[b] = sh[0]; }}"
            for c, t_, k in trees)
        host_store = "\n".join(f"      acc{k}[tid] = a{k};"
                               for _c, _t, k in trees)
        host_arrays = "\n".join(f"    Acc acc{k}[THREADS];"
                                for _c, _t, k in trees)
        out.append(_REDUCE_KERNELS.replace("@DECL@", decl)
                   .replace("@UPDATE@", upd).replace("@TREES@", tree_code)
                   .replace("@HOSTARRAYS@", host_arrays)
                   .replace("@HOSTDECL@", host_decl)
                   .replace("@HOSTUPDATE@", host_upd)
                   .replace("@HOSTSTORE@", host_store)
                   .replace("@HOSTTREES@", host_tree))
        return "\n".join(out) + "\n"

    # -- launching ---------------------------------------------------------------
    def _strbuf_for(self, device) -> torch.Tensor:
        key = str(device)
        buf = self._strbuf.get(key)
        if buf is None:
            raw = b"".join(b for _w, b, _k in self._str_lits) or b"\0"
            buf = self._strbuf[key] = torch.frombuffer(
                bytearray(raw), dtype=torch.uint8).to(device)
        return buf

    def _base_words(self) -> ctypes.Array:
        """The batch-independent words: literals, flags, string offsets."""
        if self._template is not None:
            return self._template
        w = (ctypes.c_ulonglong * self._words)()
        for word, value, t in self._const_words:
            w[word] = _pack_value(value, t)
            w[word + 1] = 0 if value is None else 1
        for word, flag in self._flag_words:
            w[word] = int(flag)
        off = 0
        for word, raw, valid in self._str_lits:
            w[word], w[word + 1], w[word + 2] = off, len(raw), int(valid)
            off += len(raw)
        self._template = w
        return w

    def pack(self, batch: ColumnarBatch, outs: Sequence[Optional[Column]],
             mask: Optional[torch.Tensor],
             parts: Sequence[torch.Tensor] = ()) -> ctypes.Array:
        """The argument block for ``batch`` and the output buffers."""
        w = (ctypes.c_ulonglong * self._words)()
        ctypes.memmove(w, self._base_words(), ctypes.sizeof(w))
        w[W_N] = batch.capacity
        n = batch.num_rows_raw
        if isinstance(n, torch.Tensor):
            if n.dtype not in (torch.int32, torch.int64):
                raise ValueError(f"row count of dtype {n.dtype}")
            w[W_NROWS_PTR] = n.data_ptr()
            w[W_NROWS_BYTES] = n.element_size()
        else:
            w[W_NROWS] = int(n)
        w[W_STRLIT] = self._strbuf_for(batch.device).data_ptr()
        for ordinal, word in self._inputs.items():
            col = batch.columns[ordinal]
            w[word] = col.data.data_ptr()
            w[word + 1] = col.validity.data_ptr()
            if col.dtype == dt.STRING:
                w[word + 2] = col.lengths.data_ptr()
                w[word + 3] = int(col.data.shape[1])
        for kind, col in zip(self.out_kinds, outs):
            if kind[0] == "gen":
                w[kind[2]] = col.data.data_ptr()
                w[kind[2] + 1] = col.validity.data_ptr()
        if self.mask_word is not None:
            w[self.mask_word] = mask.data_ptr()
        for k, p in enumerate(parts):
            w[self.spec_parts_word + k] = p.data_ptr()
        return w

    def allocate(self, batch: ColumnarBatch
                 ) -> Tuple[List[Column], Optional[torch.Tensor]]:
        """Output columns (input columns where an output is one) and the
        keep mask."""
        cap, device = batch.capacity, batch.device
        outs = []
        for kind in self.out_kinds:
            if kind[0] == "ref":
                outs.append(batch.columns[kind[1]])
            else:
                t = kind[1]
                outs.append(Column(t, torch.empty(
                    cap, dtype=storage_dtype(t), device=device),
                    torch.empty(cap, dtype=torch.bool, device=device)))
        mask = torch.empty(cap, dtype=torch.bool, device=device) \
            if self.mask_word is not None else None
        return outs, mask

    def check_inputs(self, batch: ColumnarBatch) -> None:
        """The kernel reads each input column's arrays as contiguous
        ``capacity``-row arrays of the column type's storage."""
        cap = batch.capacity
        for ordinal in self._inputs:
            col = batch.columns[ordinal]
            arrays = [col.data, col.validity] + \
                ([col.lengths] if col.dtype == dt.STRING else [])
            if col.dtype != self.in_schema[ordinal].dtype or \
                    col.data.dtype != storage_dtype(col.dtype) or \
                    col.validity.dtype != torch.bool or any(
                        not a.is_contiguous() or a.shape[0] != cap
                        for a in arrays):
                raise ValueError(f"fused stage input {ordinal}: expected "
                                 f"contiguous {self.in_schema[ordinal].dtype}"
                                 f"[{cap}] arrays")

    def launch(self, batch: ColumnarBatch
               ) -> Tuple[List[Column], Optional[torch.Tensor]]:
        """K19 on a CUDA batch: (output columns, keep mask or None)."""
        if self.mode != "stage":
            raise ValueError("launch() runs a stage kernel; use reduce()")
        device = batch.device
        if device.type != "cuda":
            raise RuntimeError(f"fused_stage: unsupported device {device}")
        self.check_inputs(batch)
        outs, mask = self.allocate(batch)
        fn = native.generated_kernel(self.source, self.entry, device)
        n = batch.capacity
        blocks = max(1, min((n + THREADS - 1) // THREADS, MAX_BLOCKS))
        native.launch_generated(fn, blocks, THREADS,
                                self.pack(batch, outs, mask), device)
        native.bump("fused_stage")
        return outs, mask

    def reduce(self, batch: ColumnarBatch,
               out_slots: int) -> List[Column]:
        """K20 then K1's fold per aggregate on a CUDA batch: one
        ``out_slots``-slot column per spec, as masked_reduce gives."""
        device = batch.device
        if device.type != "cuda":
            raise RuntimeError(f"fused_reduce: unsupported device {device}")
        self.check_inputs(batch)
        n = batch.capacity
        nparts = agg_k.masked_reduce_parts(n)
        outs, _mask = self.allocate(batch)
        parts = [torch.empty(nparts * 32, dtype=torch.uint8, device=device)
                 for _ in self.specs]
        fn = native.generated_kernel(self.source, self.entry, device)
        native.launch_generated(fn, nparts, THREADS,
                                self.pack(batch, outs, None, parts), device)
        native.bump("fused_reduce")
        result = []
        for (op, e, ig), p, (_o, v, _e, dcode) in zip(
                self.specs, parts, self._row_out):
            data = valid = None
            if op in ("first", "last"):
                data, valid = self._first_last_input(batch, e)
            result.append(agg_k.masked_reduce_fold(
                op, dcode, e.dtype if e is not None else None, p, nparts,
                data, valid, out_slots, device))
        return result

    @staticmethod
    def _first_last_input(batch, e):
        col = batch.columns[strip(e).ordinal]
        return col.data, col.validity


def _pack_value(value, t: dt.DType) -> int:
    """A literal's 64-bit word: the value converted to ``t`` as
    ``torch.tensor(value, dtype)`` converts it."""
    if value is None:
        return 0
    if t in (dt.BOOL, dt.NULLTYPE):
        return int(bool(value))
    x = torch.tensor(value, dtype=storage_dtype(t)).item()
    if t == dt.FLOAT64:
        return struct.unpack("<Q", struct.pack("<d", x))[0]
    if t == dt.FLOAT32:
        return struct.unpack("<I", struct.pack("<f", x))[0]
    return int(x) & ((1 << 64) - 1)


_STAGE_KERNELS = r"""
#ifdef __CUDACC__
extern "C" __global__ void __launch_bounds__(256) ENTRY(StageArgs P) {
  const long long n = (long long)P.w[0];
  const long long nrows = nrows_of(P.w);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    stage_row(P, i, nrows, true);
}
#else
extern "C" void stage_host(const u64* w) {
  StageArgs P;
  memcpy(P.w, w, sizeof(P.w));
  const long long n = (long long)P.w[0];
  const long long nrows = nrows_of(P.w);
  for (long long i = 0; i < n; ++i) stage_row(P, i, nrows, true);
}
#endif
"""

# K1's grid: one block per part, 256 threads, each thread striding over
# the rows in order, then K1's fixed shared-memory tree per aggregate
_REDUCE_KERNELS = r"""
#define THREADS 256
#ifdef __CUDACC__
template <int OP, typename T>
__device__ __forceinline__ void block_tree(Acc* sh, Acc mine) {
  sh[threadIdx.x] = mine;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) acc_combine<OP, T>(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
}
extern "C" __global__ void __launch_bounds__(256) ENTRY(StageArgs P) {
  __shared__ Acc sh[THREADS];
  const long long n = (long long)P.w[0];
  const long long nrows = nrows_of(P.w);
@DECL@
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const Row r = stage_row(P, i, nrows, false);
@UPDATE@
  }
@TREES@
}
#else
extern "C" void stage_host_reduce(const u64* w, int nparts) {
  StageArgs P;
  memcpy(P.w, w, sizeof(P.w));
  const long long n = (long long)P.w[0];
  const long long nrows = nrows_of(P.w);
  const long long stride = (long long)nparts * THREADS;
  Acc sh[THREADS];
  for (int b = 0; b < nparts; ++b) {
@HOSTARRAYS@
    for (int tid = 0; tid < THREADS; ++tid) {
@HOSTDECL@
      for (long long i = (long long)b * THREADS + tid; i < n; i += stride) {
        const Row r = stage_row(P, i, nrows, false);
@HOSTUPDATE@
      }
@HOSTSTORE@
    }
@HOSTTREES@
  }
}
#endif
"""


def decline_reason(mode: str, in_schema: dt.Schema,
                   filters: Sequence[ex.Expression],
                   outputs: Sequence[ex.Expression] = (),
                   specs: Sequence[tuple] = ()) -> Optional[str]:
    """Why the generator does not cover this stage (None: it does)."""
    try:
        StageKernel(mode, in_schema, filters, outputs, specs)
    except Declined as e:
        return str(e)
    return None
