"""Math expressions: the port of spark_rapids_tpu/ops/math_ops.py (the
unary double functions, floor, ceil, pow, atan2, round).

Spark semantics: the unary functions take DOUBLE (analysis inserts the
cast); log, log10, log2 of x <= 0 and log1p of x <= -1 are NULL, sqrt of
a negative is NaN; floor and ceil of a double are int64 (NaN gives 0, the
ends saturate, as the port's float -> integral cast); round is HALF_UP.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .cast import device_cast
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)


class UnaryMath(Expression):
    """DOUBLE -> DOUBLE, elementwise; 0 where NULL (or outside the
    domain)."""
    fn: Callable = None       # torch function (columns)
    pyfn: Callable = None     # numpy twin (the host fold of a literal)
    # name of the C function the generated kernels call (stage_codegen)
    cname: str = ""

    @property
    def dtype(self) -> dt.DType:
        return dt.FLOAT64

    def _domain_validity(self, d):
        """Extra validity (None: defined everywhere)."""
        return None

    def _safe_input(self, d):
        return d

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.FLOAT64)
            x = np.float64(v.value)
            extra = self._domain_validity(x)
            if extra is not None and not bool(extra):
                return Scalar(None, dt.FLOAT64)
            with np.errstate(invalid="ignore", divide="ignore",
                             over="ignore"):
                return Scalar(float(type(self).pyfn(x)), dt.FLOAT64)
        d = v.data.to(torch.float64)
        extra = self._domain_validity(d)
        data = type(self).fn(self._safe_input(d))
        validity = v.validity if extra is None else (v.validity & extra)
        data = torch.where(validity, data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
        return result_column(dt.FLOAT64, data, validity, batch.capacity)


def _unary(name: str, fn, pyfn, cname: str,
           domain: Optional[Callable] = None,
           safe: Optional[Callable] = None) -> type:
    attrs = {"fn": staticmethod(fn), "pyfn": staticmethod(pyfn),
             "cname": cname}
    if domain is not None:
        attrs["_domain_validity"] = lambda self, d, _dom=domain: _dom(d)
    if safe is not None:
        attrs["_safe_input"] = lambda self, d, _s=safe: _s(d)
    return type(name, (UnaryMath,), attrs)


def _where1(d, cond, other):
    if isinstance(d, torch.Tensor):
        return torch.where(cond, d, torch.full((), other, dtype=d.dtype,
                                               device=d.device))
    return np.where(cond, d, other)


Sin = _unary("Sin", torch.sin, np.sin, "sin")
Cos = _unary("Cos", torch.cos, np.cos, "cos")
Tan = _unary("Tan", torch.tan, np.tan, "tan")
Asin = _unary("Asin", torch.asin, np.arcsin, "asin")
Acos = _unary("Acos", torch.acos, np.arccos, "acos")
Atan = _unary("Atan", torch.atan, np.arctan, "atan")
Sinh = _unary("Sinh", torch.sinh, np.sinh, "sinh")
Cosh = _unary("Cosh", torch.cosh, np.cosh, "cosh")
Tanh = _unary("Tanh", torch.tanh, np.tanh, "tanh")
Exp = _unary("Exp", torch.exp, np.exp, "exp")
Expm1 = _unary("Expm1", torch.expm1, np.expm1, "expm1")
Sqrt = _unary("Sqrt", torch.sqrt, np.sqrt, "sqrt")   # sqrt(<0) = NaN
Cbrt = _unary("Cbrt", lambda d: torch.sign(d) * torch.abs(d).pow(1.0 / 3),
              np.cbrt, "cbrt")
Rint = _unary("Rint", torch.round, np.rint, "rint")   # half to even
Signum = _unary("Signum", torch.sign, np.sign, "signum")
ToDegrees = _unary("ToDegrees", torch.rad2deg, np.degrees, "degrees")
ToRadians = _unary("ToRadians", torch.deg2rad, np.radians, "radians")
# Spark: log/log10/log2 of x <= 0 and log1p of x <= -1 are NULL
Log = _unary("Log", torch.log, np.log, "log", domain=lambda d: d > 0,
             safe=lambda d: _where1(d, d > 0, 1.0))
Log10 = _unary("Log10", torch.log10, np.log10, "log10",
               domain=lambda d: d > 0,
               safe=lambda d: _where1(d, d > 0, 1.0))
Log2 = _unary("Log2", torch.log2, np.log2, "log2", domain=lambda d: d > 0,
              safe=lambda d: _where1(d, d > 0, 1.0))
Log1p = _unary("Log1p", torch.log1p, np.log1p, "log1p",
               domain=lambda d: d > -1,
               safe=lambda d: _where1(d, d > -1, 0.0))


class _Rounding(Expression):
    """floor/ceil: int64 for a float child (the saturating cast), the
    child as it is otherwise."""
    fn: Callable = None
    pyfn: Callable = None

    @property
    def dtype(self) -> dt.DType:
        t = self.children[0].dtype
        return dt.INT64 if t.is_floating else t

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        src = self.children[0].dtype
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, self.dtype)
            if not src.is_floating:
                return v
            x = float(v.value)
            if math.isnan(x):
                return Scalar(0, self.dtype)
            if math.isinf(x):
                return Scalar((1 << 63) - 1 if x > 0 else -(1 << 63),
                              self.dtype)
            return Scalar(max(min(type(self).pyfn(x), (1 << 63) - 1),
                              -(1 << 63)), self.dtype)
        if not src.is_floating:
            return v
        return Column(self.dtype, device_cast(type(self).fn(v.data), src,
                                              dt.INT64), v.validity)


class Floor(_Rounding):
    """GpuFloor."""
    fn = staticmethod(torch.floor)
    pyfn = staticmethod(math.floor)


class Ceil(_Rounding):
    """GpuCeil."""
    fn = staticmethod(torch.ceil)
    pyfn = staticmethod(math.ceil)


class _BinaryMath(Expression):
    """DOUBLE x DOUBLE -> DOUBLE; 0 where NULL."""

    @property
    def dtype(self) -> dt.DType:
        return dt.FLOAT64

    def _fn(self, l, r):
        raise NotImplementedError

    def eval(self, batch: ColumnarBatch):
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        device = batch.device
        if isinstance(lv, Scalar) and isinstance(rv, Scalar):
            if lv.is_null or rv.is_null:
                return Scalar(None, dt.FLOAT64)
            with np.errstate(all="ignore"):
                return Scalar(float(self._np(np.float64(lv.value),
                                             np.float64(rv.value))),
                              dt.FLOAT64)
        ld, lval = data_validity(lv, dt.FLOAT64, device)
        rd, rval = data_validity(rv, dt.FLOAT64, device)
        data = self._fn(ld.to(torch.float64), rd.to(torch.float64))
        validity = combine_validity(lval, rval)
        if validity is not True:
            v = validity if isinstance(validity, torch.Tensor) else \
                torch.tensor(bool(validity), device=device)
            data = torch.where(v.expand(batch.capacity), data,
                               torch.zeros((), dtype=data.dtype,
                                           device=device))
        return result_column(dt.FLOAT64, data, validity, batch.capacity)


class Pow(_BinaryMath):
    """GpuPow."""

    def _fn(self, l, r):
        return torch.pow(l, r)

    def _np(self, l, r):
        return np.power(l, r)


class Atan2(_BinaryMath):
    def _fn(self, l, r):
        return torch.atan2(l, r)

    def _np(self, l, r):
        return np.arctan2(l, r)


class Round(Expression):
    """GpuRound: HALF_UP at a literal scale."""

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__(child)
        self.scale = scale

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        child_t = self.children[0].dtype
        factor = 10.0 ** self.scale
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, self.dtype)
            x = float(v.value)
            r = math.floor(abs(x) * factor + 0.5) / factor * \
                (1 if x >= 0 else -1)
            return Scalar(r if child_t.is_floating else int(r), self.dtype)
        if child_t.is_floating:
            # |x| * f + 0.5, floored, / f, the sign put back (torch.round
            # is half to even)
            # the divisor as a device tensor: PyTorch's CUDA division by a
            # Python scalar multiplies by its reciprocal, which is not the
            # reference's correctly rounded quotient
            scaled = torch.abs(v.data) * factor
            rounded = torch.floor(scaled + 0.5) / torch.full(
                (), factor, dtype=scaled.dtype, device=scaled.device)
            data = torch.where(v.data < 0, -rounded, rounded)
            return Column(self.dtype, data.to(v.data.dtype), v.validity)
        if self.scale >= 0:
            return v
        f = int(10 ** (-self.scale))
        half = f // 2
        sign = torch.where(v.data < 0, -1, 1).to(v.data.dtype)
        mag = torch.abs(v.data.to(torch.int64))
        data = (torch.div(mag + half, f, rounding_mode="floor") * f).to(
            v.data.dtype) * sign
        return Column(self.dtype, data, v.validity)
