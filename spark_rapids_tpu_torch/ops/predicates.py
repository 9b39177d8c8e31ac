"""Predicate expressions: the port of spark_rapids_tpu/ops/predicates.py
(comparisons, ``<=>``, AND/OR/NOT, IS [NOT] NULL, ISNAN, IN).

Spark semantics: comparisons are NULL if either side is NULL; AND/OR are
Kleene three-valued; NaN = NaN is TRUE and NaN is greater than every other
double (``float_eq``/``float_lt``). Strings compare bytewise through the
byte-matrix helpers of ops/strings_util.py.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)
from .strings_util import string_compare, string_equal


def float_eq(l, r):
    """Spark float equality: NaN = NaN is TRUE (unlike IEEE)."""
    return (l == r) | (torch.isnan(l) & torch.isnan(r))


def float_lt(l, r):
    """Spark float ordering: NaN is greater than every other value."""
    return (l < r) | (torch.isnan(r) & ~torch.isnan(l))


def _literal_cache(node: Expression) -> dict:
    """The node's literal operands already on the device, by value, width
    and device: a literal is copied there once, not once a batch."""
    cache = getattr(node, "_literals", None)
    if cache is None:
        cache = node._literals = {}
    return cache


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

    def _string_cmp(self, lv, rv, batch: ColumnarBatch):
        cmp = string_compare(lv, rv, batch.capacity, batch.device,
                             _literal_cache(self))
        return self._cmp(cmp, torch.zeros((), dtype=torch.int32,
                                          device=batch.device))

    def eval(self, batch: ColumnarBatch):
        in_dtype = self.left.dtype
        lv = self.left.eval(batch)
        rv = self.right.eval(batch)
        if isinstance(lv, Scalar) and isinstance(rv, Scalar):
            if lv.is_null or rv.is_null:
                return Scalar(None, dt.BOOL)
            return Scalar(bool(self._py_cmp(lv, rv)), dt.BOOL)
        device = batch.device
        if in_dtype == dt.STRING:
            data = self._string_cmp(lv, rv, batch)
            validity = combine_validity(_str_validity(lv), _str_validity(rv))
        else:
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
        if self.left.dtype == dt.STRING:
            return {"=": l == r, "!=": l != r, "<": l < r, "<=": l <= r,
                    ">": l > r, ">=": l >= r}[self.symbol]
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

    def _string_cmp(self, lv, rv, batch: ColumnarBatch):
        return string_equal(lv, rv, batch.capacity, batch.device,
                            _literal_cache(self))


class NotEqual(BinaryComparison):
    symbol = "!="

    def _cmp(self, l, r):
        return l != r

    def _cmp_float(self, l, r):
        return ~float_eq(l, r)

    def _string_cmp(self, lv, rv, batch: ColumnarBatch):
        return ~string_equal(lv, rv, batch.capacity, batch.device,
                             _literal_cache(self))


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


class EqualNullSafe(Expression):
    """``<=>``: never NULL; NULL <=> NULL is TRUE (GpuEqualNullSafe).
    Padding rows read FALSE with valid = the row mask."""
    symbol = "<=>"

    @property
    def dtype(self):
        return dt.BOOL

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        in_dtype = self.children[0].dtype
        cap, device = batch.capacity, batch.device
        if in_dtype == dt.STRING:
            eq = string_equal(lv, rv, cap, device, _literal_cache(self))
        else:
            ld, _ = data_validity(lv, in_dtype, device)
            rd, _ = data_validity(rv, in_dtype, device)
            eq = float_eq(ld, rd) if in_dtype.is_floating else (ld == rd)
        lval = torch.as_tensor(_str_validity(lv), device=device).expand(cap)
        rval = torch.as_tensor(_str_validity(rv), device=device).expand(cap)
        data = torch.where(lval & rval, eq.expand(cap), lval == rval)
        live = batch.row_mask_raw()
        return result_column(dt.BOOL, data & live, live, cap)

    def __repr__(self):
        return f"({self.children[0]!r} <=> {self.children[1]!r})"


def _str_validity(v):
    """Validity of a string operand: a tensor, or a python bool for a
    scalar (True = always valid)."""
    return v.validity if isinstance(v, Column) else (not v.is_null)


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


class IsNaN(Expression):
    """GpuIsNan: FALSE for NULL, never NULL on live rows."""

    @property
    def dtype(self):
        return dt.BOOL

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            return Scalar(bool(v.value is not None and
                               math.isnan(v.value)), dt.BOOL)
        live = batch.row_mask_raw()
        return result_column(dt.BOOL, torch.isnan(v.data) & v.validity,
                             live, batch.capacity)


class In(Expression):
    """``child IN (values)`` with a literal list: NULL input gives NULL;
    no match and a NULL in the list gives NULL."""

    def __init__(self, child: Expression, values: List):
        super().__init__(child)
        self.values = values

    @property
    def dtype(self):
        return dt.BOOL

    def eval(self, batch: ColumnarBatch):
        child = self.children[0]
        cap, device = batch.capacity, batch.device
        v = child.eval(batch)
        has_null = any(x is None for x in self.values)
        concrete = [x for x in self.values if x is not None]
        cache = _literal_cache(self)
        match = torch.zeros(cap, dtype=torch.bool, device=device)
        if child.dtype == dt.STRING:
            for x in concrete:
                match = match | string_equal(v, Scalar(x, dt.STRING), cap,
                                             device, cache)
        else:
            vd, _ = data_validity(v, child.dtype, device)
            key = (vd.dtype, str(device))
            values = cache.get(key)
            if values is None:
                values = cache[key] = [torch.tensor(x, dtype=vd.dtype,
                                                    device=device)
                                       for x in concrete]
            for x in values:
                match = match | (vd == x).expand(cap)
        vval = v.validity if isinstance(v, Column) else torch.full(
            (cap,), not v.is_null, dtype=torch.bool, device=device)
        validity = vval & (match | (not has_null))
        return result_column(dt.BOOL, match & validity, validity, cap)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.values!r})"
