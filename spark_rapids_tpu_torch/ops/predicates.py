"""Predicate expressions: the port of spark_rapids_tpu/ops/predicates.py
(comparisons, AND/OR/NOT, IS [NOT] NULL).

Spark semantics: comparisons are NULL if either side is NULL; AND/OR are
Kleene three-valued; NaN = NaN is TRUE and NaN is greater than every other
double (``float_eq``/``float_lt``). String comparison needs the byte-matrix
helpers of ops/strings_util.py, which are not ported yet: it raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)


def float_eq(l, r):
    """Spark float equality: NaN = NaN is TRUE (unlike IEEE)."""
    return (l == r) | (torch.isnan(l) & torch.isnan(r))


def float_lt(l, r):
    """Spark float ordering: NaN is greater than every other value."""
    return (l < r) | (torch.isnan(r) & ~torch.isnan(l))


class BinaryComparison(Expression):
    symbol = "?"

    @property
    def dtype(self) -> dt.DType:
        return dt.BOOL

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def _cmp(self, l, r):
        raise NotImplementedError

    def _cmp_float(self, l, r):
        raise NotImplementedError

    def eval(self, batch: ColumnarBatch):
        in_dtype = self.left.dtype
        if in_dtype == dt.STRING:
            raise NotImplementedError(
                f"string comparison {self.symbol} is not ported yet "
                "(needs ops/strings_util.py)")
        lv = self.left.eval(batch)
        rv = self.right.eval(batch)
        if isinstance(lv, Scalar) and isinstance(rv, Scalar):
            if lv.is_null or rv.is_null:
                return Scalar(None, dt.BOOL)
            return Scalar(bool(self._py_cmp(lv, rv)), dt.BOOL)
        device = batch.device
        ld, lval = data_validity(lv, in_dtype, device)
        rd, rval = data_validity(rv, in_dtype, device)
        data = self._cmp_float(ld, rd) if in_dtype.is_floating \
            else self._cmp(ld, rd)
        validity = combine_validity(lval, rval)
        if validity is not True:
            v = validity if isinstance(validity, torch.Tensor) else \
                torch.tensor(bool(validity), device=device)
            data = data & v.expand(batch.capacity)
        return result_column(dt.BOOL, data, validity, batch.capacity)

    def _py_cmp(self, lv: Scalar, rv: Scalar):
        """Host scalar compare with Spark's NaN semantics."""
        l, r = lv.value, rv.value
        if self.left.dtype.is_floating:
            npdt = np.dtype(self.left.dtype.numpy_dtype).type
            l, r = float(npdt(l)), float(npdt(r))
            ln, rn = math.isnan(l), math.isnan(r)
            if ln or rn:
                eq = ln and rn
                lt = rn and not ln
            else:
                eq, lt = (l == r), (l < r)
        else:
            eq, lt = (l == r), (l < r)
        return {"=": eq, "!=": not eq, "<": lt, "<=": lt or eq,
                ">": not (lt or eq), ">=": not lt}[self.symbol]

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def _cmp(self, l, r):
        return l == r

    def _cmp_float(self, l, r):
        return float_eq(l, r)


class NotEqual(BinaryComparison):
    symbol = "!="

    def _cmp(self, l, r):
        return l != r

    def _cmp_float(self, l, r):
        return ~float_eq(l, r)


class LessThan(BinaryComparison):
    symbol = "<"

    def _cmp(self, l, r):
        return l < r

    def _cmp_float(self, l, r):
        return float_lt(l, r)


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _cmp(self, l, r):
        return l <= r

    def _cmp_float(self, l, r):
        return float_lt(l, r) | float_eq(l, r)


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, l, r):
        return l > r

    def _cmp_float(self, l, r):
        return float_lt(r, l)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _cmp(self, l, r):
        return l >= r

    def _cmp_float(self, l, r):
        return float_lt(r, l) | float_eq(l, r)


def _bool_dv(value, batch: ColumnarBatch):
    """(data, validity) of a BOOL operand as full-capacity tensors."""
    cap, device = batch.capacity, batch.device
    d, v = data_validity(value, dt.BOOL, device)
    return d.expand(cap), torch.as_tensor(v, device=device).expand(cap)


class And(Expression):
    """Kleene AND: F & NULL = F; T & NULL = NULL."""

    @property
    def dtype(self):
        return dt.BOOL

    def eval(self, batch: ColumnarBatch):
        ld, lval = _bool_dv(self.children[0].eval(batch), batch)
        rd, rval = _bool_dv(self.children[1].eval(batch), batch)
        validity = (lval & ~ld) | (rval & ~rd) | (lval & rval)
        data = ld & rd & validity
        return result_column(dt.BOOL, data, validity, batch.capacity)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    """Kleene OR: T | NULL = T; F | NULL = NULL."""

    @property
    def dtype(self):
        return dt.BOOL

    def eval(self, batch: ColumnarBatch):
        ld, lval = _bool_dv(self.children[0].eval(batch), batch)
        rd, rval = _bool_dv(self.children[1].eval(batch), batch)
        l_true = lval & ld
        r_true = rval & rd
        validity = l_true | r_true | (lval & rval)
        return result_column(dt.BOOL, l_true | r_true, validity,
                             batch.capacity)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class Not(Expression):
    @property
    def dtype(self):
        return dt.BOOL

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(None if v.is_null else (not v.value), dt.BOOL)
        return Column(dt.BOOL, (~v.data) & v.validity, v.validity)

    def __repr__(self):
        return f"(NOT {self.children[0]!r})"


class IsNull(Expression):
    @property
    def dtype(self):
        return dt.BOOL

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(v.is_null, dt.BOOL)
        live = batch.row_mask_raw()
        return result_column(dt.BOOL, (~v.validity) & live, live,
                             batch.capacity)


class IsNotNull(Expression):
    @property
    def dtype(self):
        return dt.BOOL

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(not v.is_null, dt.BOOL)
        live = batch.row_mask_raw()
        return result_column(dt.BOOL, v.validity & live, live,
                             batch.capacity)
