"""Arithmetic expressions: the port of spark_rapids_tpu/ops/arithmetic.py
(Add, Subtract, Multiply, Divide, IntegralDivide, Remainder, Pmod,
UnaryMinus, UnaryPositive, Abs).

Spark null semantics: the result is NULL if any input is NULL; division by
zero is NULL (non-ANSI Spark); integral ops wrap on overflow. Analysis
inserts casts, so both sides share the result dtype here. An integral
division or remainder by -1 never reaches the hardware divide (the
minimum over -1 traps on a CPU): the quotient is the wrapped negation and
the remainder 0, what the reference's XLA division gives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)


def _is_float(x) -> bool:
    return x.dtype.is_floating_point if isinstance(x, torch.Tensor) \
        else np.issubdtype(np.asarray(x).dtype, np.floating)


def _where(cond, a, b):
    """torch.where or np.where, after the operands' kind."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _safe_divisor(r):
    """r with 0 and (integral) -1 replaced by 1; the callers patch those
    rows."""
    bad = (r == 0) if _is_float(r) else ((r == 0) | (r == -1))
    return _where(bad, np.ones((), np.asarray(r).dtype) if not
                  isinstance(r, torch.Tensor) else 1, r)


def trunc_div(l, r):
    """Java's integral ``/`` (toward zero) with r != 0; MIN / -1 wraps."""
    sr = _safe_divisor(r)
    if isinstance(l, torch.Tensor):
        q = torch.div(l, sr, rounding_mode="trunc")
    else:
        q = _np_trunc_div(l, sr)
    with np.errstate(all="ignore"):
        return _where(r == -1, -l, q)


def _np_trunc_div(l, r):
    with np.errstate(all="ignore"):
        q = np.floor_divide(l, r)
        rem = l - q * r
        fix = ((l < 0) != (r < 0)) & (rem != 0)
        return q + fix.astype(q.dtype)


def java_fmod(l, r):
    """Java's ``%`` (the sign of the dividend); x % -1 = 0 for integers.
    Rows where r is 0 hold junk the callers zero (NULL)."""
    if _is_float(l):
        return torch.fmod(l, r) if isinstance(l, torch.Tensor) else \
            np.fmod(l, r)
    sr = _safe_divisor(r)
    m = torch.fmod(l, sr) if isinstance(l, torch.Tensor) else \
        np.fmod(l, sr)
    return _where(r == -1, 0 * l, m)


class BinaryArithmetic(Expression):
    symbol = "?"

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    @property
    def dtype(self) -> dt.DType:
        return self.left.dtype

    def _compute(self, l, r):
        raise NotImplementedError

    def _extra_validity(self, l, r):
        """Override to add NULL-producing conditions (division by zero)."""
        return None

    def _compute_safe(self, l, r):
        return self._compute(l, r)

    def eval(self, batch: ColumnarBatch):
        lv = self.left.eval(batch)
        rv = self.right.eval(batch)
        if isinstance(lv, Scalar) and isinstance(rv, Scalar):
            return self._fold_scalars(lv, rv)
        device = batch.device
        ld, lval = data_validity(lv, self.dtype, device)
        rd, rval = data_validity(rv, self.dtype, device)
        extra = self._extra_validity(ld, rd)
        data = self._compute_safe(ld, rd)
        validity = combine_validity(lval, rval)
        if extra is not None:
            validity = extra if validity is True else (validity & extra)
        if validity is not True:
            v = validity if isinstance(validity, torch.Tensor) else \
                torch.tensor(bool(validity), device=device)
            data = torch.where(v.expand(batch.capacity), data,
                               torch.zeros((), dtype=data.dtype,
                                           device=device))
        return result_column(self.dtype, data, validity, batch.capacity)

    def _fold_scalars(self, lv: Scalar, rv: Scalar) -> Scalar:
        """Literal-literal folds stay on the host, in numpy."""
        if lv.is_null or rv.is_null:
            return Scalar(None, self.dtype)
        npdt = self.dtype.numpy_dtype
        l = np.asarray(lv.value, npdt)
        r = np.asarray(rv.value, npdt)
        extra = self._extra_validity(l, r)
        if extra is not None and not bool(extra):
            return Scalar(None, self.dtype)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            out = self._compute_safe(l, r)
        return Scalar(np.asarray(out).item(), self.dtype)

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def _compute(self, l, r):
        return l + r


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _compute(self, l, r):
        return l - r


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _compute(self, l, r):
        return l * r


class Divide(BinaryArithmetic):
    """Spark `/`: always floating; x / 0 -> NULL."""
    symbol = "/"

    @property
    def nullable(self) -> bool:
        return True

    def _extra_validity(self, l, r):
        return r != 0

    def _compute_safe(self, l, r):
        if isinstance(r, torch.Tensor):
            safe_r = torch.where(r != 0, r, torch.ones((), dtype=r.dtype,
                                                       device=r.device))
        else:
            safe_r = np.where(r != 0, r, np.ones((), r.dtype))
        return l / safe_r


class IntegralDivide(BinaryArithmetic):
    """Spark `div`: long division toward zero; x div 0 -> NULL
    (GpuIntegralDivide). Computed in the columns' type, then widened to
    int64; a literal operand is an int64 and widens the division, as in
    the reference."""
    symbol = "div"

    @property
    def dtype(self) -> dt.DType:
        return dt.INT64

    @property
    def nullable(self) -> bool:
        return True

    def _extra_validity(self, l, r):
        return r != 0

    def _compute_safe(self, l, r):
        if _is_float(l):
            from .cast import device_cast
            src = dt.FLOAT32 if l.dtype == torch.float32 else dt.FLOAT64
            sr = torch.where(r != 0, r, torch.ones((), dtype=r.dtype,
                                                   device=r.device))
            return device_cast(torch.trunc(l / sr), src, dt.INT64)
        if isinstance(l, torch.Tensor) and (l.dim() == 0 or r.dim() == 0):
            l, r = l.to(torch.int64), r.to(torch.int64)
        q = trunc_div(l, r)
        if isinstance(q, torch.Tensor):
            return q.to(torch.int64)
        return np.asarray(q).astype(np.int64)


class Remainder(BinaryArithmetic):
    """Spark `%`: Java semantics (the sign of the dividend); x % 0 -> NULL,
    floats too (GpuRemainder)."""
    symbol = "%"

    @property
    def nullable(self) -> bool:
        return True

    def _extra_validity(self, l, r):
        return r != 0

    def _compute_safe(self, l, r):
        return java_fmod(l, r)


class Pmod(BinaryArithmetic):
    """Positive modulus (GpuPmod): m = x % y; (m + y) % y where m != 0;
    y == 0 -> NULL. The sum wraps for integers."""
    symbol = "pmod"

    @property
    def nullable(self) -> bool:
        return True

    def _extra_validity(self, l, r):
        return r != 0

    def _compute_safe(self, l, r):
        m = java_fmod(l, r)
        with np.errstate(all="ignore"):
            return _where(m != 0, java_fmod(m + r, r), m)


class UnaryMinus(Expression):
    """GpuUnaryMinus: -x (integers wrap)."""

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(None if v.is_null else -v.value, self.dtype)
        return Column(self.dtype, -v.data, v.validity)

    def __repr__(self):
        return f"(- {self.children[0]!r})"


class UnaryPositive(Expression):
    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, batch: ColumnarBatch):
        return self.children[0].eval(batch)


class Abs(Expression):
    """GpuAbs (the integral minimum stays itself)."""

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(None if v.is_null else abs(v.value), self.dtype)
        return Column(self.dtype, torch.abs(v.data), v.validity)
