"""Date and time expressions: the port of spark_rapids_tpu/ops/datetime.py
(year, month, day, quarter, day of week and year, last_day, hour, minute,
second, date_add/date_sub/datediff/add_months, unix_timestamp,
from_unixtime, to_date).

DATE is int32 days since 1970-01-01, TIMESTAMP int64 microseconds since
the epoch (columnar/dtypes.py). Civil dates come from Howard Hinnant's
days <-> (year, month, day) algorithms, with floor division and modulo so
that days before the epoch come out right. Each part is computed in int64
and narrowed to int32, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Scalar
from .expressions import (Expression, combine_validity, data_validity,
                          result_column)

MICROS_PER_SECOND = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SECOND


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(year, month, day) int32 from days since 1970-01-01."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) -
                _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Days since 1970-01-01 (int32) from (year, month, day)."""
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def days_of(data: torch.Tensor, in_dtype: dt.DType) -> torch.Tensor:
    """DATE days as they are; TIMESTAMP micros floored to days."""
    if in_dtype == dt.TIMESTAMP:
        return _fdiv(data, MICROS_PER_DAY).to(torch.int32)
    return data


def _host_tensor(v: Scalar, in_dtype: dt.DType) -> torch.Tensor:
    return torch.tensor([v.value], dtype=torch.int64 if in_dtype ==
                        dt.TIMESTAMP else torch.int32)


class _DatePart(Expression):
    """An int32 part of a DATE or TIMESTAMP child (0 where NULL)."""

    @property
    def dtype(self):
        return dt.INT32

    def _part(self, data: torch.Tensor, in_dtype: dt.DType) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        in_dtype = self.children[0].dtype
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, self.dtype)
            return Scalar(int(self._part(_host_tensor(v, in_dtype),
                                         in_dtype)[0]), self.dtype)
        data = self._part(v.data, in_dtype)
        data = torch.where(v.validity, data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
        return result_column(self.dtype, data, v.validity, batch.capacity)


class Year(_DatePart):
    def _part(self, data, in_dtype):
        return civil_from_days(days_of(data, in_dtype))[0]


class Month(_DatePart):
    def _part(self, data, in_dtype):
        return civil_from_days(days_of(data, in_dtype))[1]


class DayOfMonth(_DatePart):
    def _part(self, data, in_dtype):
        return civil_from_days(days_of(data, in_dtype))[2]


class Quarter(_DatePart):
    def _part(self, data, in_dtype):
        m = civil_from_days(days_of(data, in_dtype))[1]
        return _fdiv(m - 1, 3) + 1


class DayOfWeek(_DatePart):
    """Sunday = 1 .. Saturday = 7; 1970-01-01 was a Thursday."""

    def _part(self, data, in_dtype):
        days = days_of(data, in_dtype).to(torch.int64)
        return (torch.remainder(days + 4, 7) + 1).to(torch.int32)


class WeekDay(_DatePart):
    """Monday = 0 .. Sunday = 6 (Spark's weekday())."""

    def _part(self, data, in_dtype):
        days = days_of(data, in_dtype).to(torch.int64)
        return torch.remainder(days + 3, 7).to(torch.int32)


class DayOfYear(_DatePart):
    def _part(self, data, in_dtype):
        days = days_of(data, in_dtype)
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


class LastDay(_DatePart):
    """last_day(date): the month's last day, a DATE."""

    @property
    def dtype(self):
        return dt.DATE

    def _part(self, data, in_dtype):
        days = days_of(data, in_dtype)
        y, m, _ = civil_from_days(days)
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, torch.ones_like(m), m + 1)
        return days_from_civil(ny, nm, torch.ones_like(nm)) - 1


class _TimePart(_DatePart):
    """hour/minute/second of TIMESTAMP micros (floor before the epoch)."""
    _div: int
    _mod: int

    def _part(self, data, in_dtype):
        if in_dtype != dt.TIMESTAMP:
            raise TypeError(f"{type(self).__name__} takes a TIMESTAMP")
        sec = _fdiv(data, MICROS_PER_SECOND)
        return torch.remainder(_fdiv(sec, self._div),
                               self._mod).to(torch.int32)


class Hour(_TimePart):
    _div, _mod = 3600, 24


class Minute(_TimePart):
    _div, _mod = 60, 60


class Second(_TimePart):
    _div, _mod = 1, 60


class _DateBinary(Expression):
    """date op int (or date): both NULL-propagating, 0 where NULL."""

    def _compute(self, ld: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    right_type = dt.INT32

    def eval(self, batch: ColumnarBatch):
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        device = batch.device
        if isinstance(lv, Scalar) and isinstance(rv, Scalar):
            if lv.is_null or rv.is_null:
                return Scalar(None, self.dtype)
            ld = torch.tensor([lv.value], dtype=torch.int32)
            rd = torch.tensor([rv.value], dtype=torch.int32)
            return Scalar(int(self._compute(ld, rd)[0]), self.dtype)
        ld, lval = data_validity(lv, dt.DATE, device)
        rd, rval = data_validity(rv, self.right_type, device)
        data = self._compute(ld.reshape(-1), rd.reshape(-1))
        validity = combine_validity(lval, rval)
        if validity is not True:
            v = validity if isinstance(validity, torch.Tensor) else \
                torch.tensor(bool(validity), device=device)
            data = torch.where(v.expand(batch.capacity), data,
                               torch.zeros((), dtype=data.dtype,
                                           device=device))
        return result_column(self.dtype, data, validity, batch.capacity)


class DateAdd(_DateBinary):
    """date_add(date, n): DATE + n days (int32, wrapping)."""

    @property
    def dtype(self):
        return dt.DATE

    def _compute(self, ld, rd):
        return ld + rd.to(torch.int32)


class DateSub(DateAdd):
    def _compute(self, ld, rd):
        return ld - rd.to(torch.int32)


class DateDiff(_DateBinary):
    """datediff(end, start): int32 days."""
    right_type = dt.DATE

    @property
    def dtype(self):
        return dt.INT32

    def _compute(self, ld, rd):
        return ld - rd


class AddMonths(_DateBinary):
    """add_months(date, n): the day clamped to the target month's last."""

    @property
    def dtype(self):
        return dt.DATE

    def _compute(self, ld, rd):
        y, m, d = civil_from_days(ld)
        total = y.to(torch.int64) * 12 + (m - 1) + rd.to(torch.int64)
        ny = _fdiv(total, 12).to(torch.int32)
        nm = (torch.remainder(total, 12) + 1).to(torch.int32)
        nny = torch.where(nm == 12, ny + 1, ny)
        nnm = torch.where(nm == 12, torch.ones_like(nm), nm + 1)
        one = torch.ones_like(nm)
        month_len = days_from_civil(nny, nnm, one) - \
            days_from_civil(ny, nm, one)
        nd = torch.minimum(d, month_len.to(torch.int32))
        return days_from_civil(ny, nm, nd)


class _TimestampUnary(Expression):
    """A one-child conversion, 0 where NULL."""

    def _compute(self, data: torch.Tensor, in_dtype: dt.DType
                 ) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        in_dtype = self.children[0].dtype
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, self.dtype)
            return Scalar(int(self._compute(_host_tensor(v, in_dtype),
                                            in_dtype)[0]), self.dtype)
        data = self._compute(v.data, in_dtype)
        data = torch.where(v.validity, data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
        return result_column(self.dtype, data, v.validity, batch.capacity)


class UnixTimestamp(_TimestampUnary):
    """unix_timestamp(ts or date): int64 seconds (floor)."""

    @property
    def dtype(self):
        return dt.INT64

    def _compute(self, data, in_dtype):
        data = data.to(torch.int64)
        if in_dtype == dt.DATE:
            return data * (MICROS_PER_DAY // MICROS_PER_SECOND)
        return _fdiv(data, MICROS_PER_SECOND)


class FromUnixTime(_TimestampUnary):
    """from_unixtime(seconds): a TIMESTAMP (the reference's form; Spark
    formats it as a string)."""

    @property
    def dtype(self):
        return dt.TIMESTAMP

    def _compute(self, data, in_dtype):
        return data.to(torch.int64) * MICROS_PER_SECOND


class ToDate(_TimestampUnary):
    """to_date(ts): floor to the day; a DATE passes through."""

    @property
    def dtype(self):
        return dt.DATE

    def eval(self, batch: ColumnarBatch):
        if self.children[0].dtype == dt.DATE:
            return self.children[0].eval(batch)
        return super().eval(batch)

    def _compute(self, data, in_dtype):
        return _fdiv(data, MICROS_PER_DAY).to(torch.int32)
