"""Cast expression: the numeric and date casts of spark_rapids_tpu/ops/cast.py
that analysis (plan/logical._coerce) inserts.

Spark non-ANSI semantics: float -> integral truncates and saturates at the
target range (NaN -> 0); integral -> narrower integral wraps; bool ->
numeric is 0/1; numeric -> bool is x != 0; date <-> timestamp scales by
microseconds per day. Casts from or to STRING are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, storage_dtype
from .expressions import Expression

_INT_RANGE = {
    dt.INT8: (-(1 << 7), (1 << 7) - 1),
    dt.INT16: (-(1 << 15), (1 << 15) - 1),
    dt.INT32: (-(1 << 31), (1 << 31) - 1),
    dt.INT64: (-(1 << 63), (1 << 63) - 1),
}

MICROS_PER_SECOND = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SECOND


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DType):
        super().__init__(child)
        self.to = to

    @property
    def fusable(self) -> bool:  # type: ignore[override]
        """The reference's _is_device_castable: casts from or to STRING
        stay out of fused stages."""
        src = self.children[0].dtype
        return src == self.to or dt.STRING not in (src, self.to)

    @property
    def dtype(self) -> dt.DType:
        return self.to

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        src = self.children[0].dtype
        if dt.STRING in (src, self.to) and src != self.to:
            raise NotImplementedError(
                f"cast {src} -> {self.to} is not ported yet")
        if isinstance(v, Scalar):
            return _cast_scalar(v, src, self.to)
        if src == self.to:
            return v
        return Column(self.to, device_cast(v.data, src, self.to), v.validity)

    def __repr__(self):
        return f"cast({self.children[0]!r} AS {self.to})"


def device_cast(data: torch.Tensor, src: dt.DType, dst: dt.DType
                ) -> torch.Tensor:
    if src == dst:
        return data
    out_t = storage_dtype(dst)
    if dst == dt.BOOL:
        return data != 0
    if src == dt.BOOL:
        return data.to(out_t)
    if src == dt.DATE and dst == dt.TIMESTAMP:
        return data.to(torch.int64) * MICROS_PER_DAY
    if src == dt.TIMESTAMP and dst == dt.DATE:
        return torch.div(data, MICROS_PER_DAY, rounding_mode="floor").to(
            torch.int32)
    if src == dt.TIMESTAMP and dst.is_integral:
        return torch.div(data, MICROS_PER_SECOND,
                         rounding_mode="floor").to(out_t)
    if src.is_integral and dst == dt.TIMESTAMP:
        return data.to(torch.int64) * MICROS_PER_SECOND
    if src == dt.TIMESTAMP and dst.is_floating:
        # a device divisor: CUDA's division by a Python scalar multiplies
        # by its reciprocal, not the correctly rounded quotient
        return data.to(torch.float64) / torch.full(
            (), float(MICROS_PER_SECOND), dtype=torch.float64,
            device=data.device)
    if src.is_floating and dst == dt.TIMESTAMP:
        return (data * MICROS_PER_SECOND).to(torch.int64)
    if src.is_floating and dst.is_integral:
        lo, hi = _INT_RANGE[dst]
        trunc = torch.trunc(torch.where(torch.isnan(data),
                                        torch.zeros_like(data), data))
        t64 = trunc.to(torch.float64)
        big = torch.full_like(t64, hi, dtype=torch.int64)
        small = torch.full_like(t64, lo, dtype=torch.int64)
        as64 = torch.where(t64 >= float(hi), big,
                           torch.where(t64 <= float(lo), small,
                                       t64.clamp(float(lo), float(hi))
                                       .to(torch.int64)))
        return as64.to(out_t)
    # integral -> integral (wrap), integral -> float, float <-> float,
    # date <-> int
    return data.to(out_t)


def _cast_scalar(v: Scalar, src: dt.DType, dst: dt.DType) -> Scalar:
    """Host fold in numpy: the same rules as device_cast."""
    if v.is_null:
        return Scalar(None, dst)
    if src == dst:
        return v
    x = np.asarray(v.value, src.numpy_dtype)
    npdst = dst.numpy_dtype
    if dst == dt.BOOL:
        out = x != 0
    elif src == dt.BOOL:
        out = x.astype(npdst)
    elif src == dt.DATE and dst == dt.TIMESTAMP:
        out = x.astype(np.int64) * MICROS_PER_DAY
    elif src == dt.TIMESTAMP and dst == dt.DATE:
        out = np.floor_divide(x, MICROS_PER_DAY).astype(np.int32)
    elif src == dt.TIMESTAMP and dst.is_integral:
        out = np.floor_divide(x, MICROS_PER_SECOND).astype(npdst)
    elif src.is_integral and dst == dt.TIMESTAMP:
        out = x.astype(np.int64) * MICROS_PER_SECOND
    elif src == dt.TIMESTAMP and dst.is_floating:
        out = x.astype(np.float64) / MICROS_PER_SECOND
    elif src.is_floating and dst == dt.TIMESTAMP:
        out = (x * MICROS_PER_SECOND).astype(np.int64)
    elif src.is_floating and dst.is_integral:
        lo, hi = _INT_RANGE[dst]
        f = 0.0 if np.isnan(x) else float(np.trunc(x))
        out = np.asarray(lo if f <= lo else hi if f >= hi else int(f),
                         np.int64).astype(npdst)
    else:
        out = x.astype(npdst)
    return Scalar(np.asarray(out).item(), dst)
