"""Arithmetic expressions: the port of spark_rapids_tpu/ops/arithmetic.py
(Add, Subtract, Multiply, Divide).

Spark null semantics: the result is NULL if any input is NULL; division by
zero is NULL (non-ANSI Spark); integral ops wrap on overflow. Analysis
inserts casts, so both sides share the result dtype here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Scalar
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)


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
