"""pyspark.sql.functions analog: the expression constructors of the main
path, the null, math, date, string and window functions, the DISTINCT
aggregates and the array, map and generator functions, ported from
spark_rapids_tpu/api/functions.py."""

from __future__ import annotations

from typing import Any

from ..ops import arithmetic as ar
from ..ops import conditionals as co
from ..ops import datetime as dtm
from ..ops import expressions as ex
from ..ops import math_ops as mo
from ..ops import predicates as pr
from ..ops import strings as st
from ..ops.hashing import Murmur3Hash
from ..plan import logical as lp
from .column import Col, WhenChain, _unwrap


def col(name: str) -> Col:
    return Col(ex.ColumnRef(name))


def lit(value: Any) -> Col:
    return Col(ex.Literal(value))


def when(condition, value) -> WhenChain:
    return WhenChain([(_unwrap(condition), _unwrap(value))])


def _agg(op: str, c, **kw) -> Col:
    child = None if c is None else _unwrap(col(c) if isinstance(c, str) else c)
    return Col(lp.AggregateExpression(op, child, **kw))


def count(c="*") -> Col:
    if isinstance(c, str) and c == "*":
        return Col(lp.AggregateExpression("count_star", None))
    return _agg("count", c)


def sum(c) -> Col:  # noqa: A001 - pyspark parity
    return _agg("sum", c)


def avg(c) -> Col:
    return _agg("avg", c)


def min(c) -> Col:  # noqa: A001
    return _agg("min", c)


def max(c) -> Col:  # noqa: A001
    return _agg("max", c)


def first(c, ignorenulls: bool = False) -> Col:
    return _agg("first", c, ignore_nulls=ignorenulls)


def last(c, ignorenulls: bool = False) -> Col:
    return _agg("last", c, ignore_nulls=ignorenulls)


def countDistinct(c) -> Col:
    return _agg("count", c, distinct=True)


def sumDistinct(c) -> Col:
    return _agg("sum", c, distinct=True)


def hash(*cols) -> Col:  # noqa: A001 - pyspark parity
    """Spark's hash(...): Murmur3Hash of the columns, seed 42 (int32)."""
    return Col(Murmur3Hash(*[_unwrap(c) for c in cols]))


# -- nulls -----------------------------------------------------------------

def coalesce(*cols) -> Col:
    return Col(co.Coalesce(*[_unwrap(c) for c in cols]))


def isnull(c) -> Col:
    return Col(pr.IsNull(_unwrap(c)))


def isnan(c) -> Col:
    return Col(pr.IsNaN(_unwrap(c)))


def nvl(a, b) -> Col:
    return Col(co.Nvl(_unwrap(a), _unwrap(b)))


def nullif(a, b) -> Col:
    return Col(co.NullIf(_unwrap(a), _unwrap(b)))


def greatest(*cols) -> Col:
    return Col(co.Greatest(*[_unwrap(c) for c in cols]))


def least(*cols) -> Col:
    return Col(co.Least(*[_unwrap(c) for c in cols]))


# -- math ------------------------------------------------------------------

def abs(c) -> Col:  # noqa: A001
    return Col(ar.Abs(_unwrap(c)))


def sqrt(c) -> Col:
    return Col(mo.Sqrt(_unwrap(c)))


def exp(c) -> Col:
    return Col(mo.Exp(_unwrap(c)))


def log(c) -> Col:
    return Col(mo.Log(_unwrap(c)))


def pow(l, r) -> Col:  # noqa: A001
    return Col(mo.Pow(_unwrap(l), _unwrap(r)))


def floor(c) -> Col:
    return Col(mo.Floor(_unwrap(c)))


def ceil(c) -> Col:
    return Col(mo.Ceil(_unwrap(c)))


def round(c, scale: int = 0) -> Col:  # noqa: A001
    return Col(mo.Round(_unwrap(c), scale))


def sin(c) -> Col:
    return Col(mo.Sin(_unwrap(c)))


def cos(c) -> Col:
    return Col(mo.Cos(_unwrap(c)))


def tan(c) -> Col:
    return Col(mo.Tan(_unwrap(c)))


def atan2(y, x) -> Col:
    return Col(mo.Atan2(_unwrap(y), _unwrap(x)))


def pmod(l, r) -> Col:
    return Col(ar.Pmod(_unwrap(l), _unwrap(r)))


# -- dates -----------------------------------------------------------------

def year(c) -> Col:
    return Col(dtm.Year(_unwrap(c)))


def month(c) -> Col:
    return Col(dtm.Month(_unwrap(c)))


def dayofmonth(c) -> Col:
    return Col(dtm.DayOfMonth(_unwrap(c)))


def dayofweek(c) -> Col:
    return Col(dtm.DayOfWeek(_unwrap(c)))


def weekday(c) -> Col:
    return Col(dtm.WeekDay(_unwrap(c)))


def dayofyear(c) -> Col:
    return Col(dtm.DayOfYear(_unwrap(c)))


def quarter(c) -> Col:
    return Col(dtm.Quarter(_unwrap(c)))


def hour(c) -> Col:
    return Col(dtm.Hour(_unwrap(c)))


def minute(c) -> Col:
    return Col(dtm.Minute(_unwrap(c)))


def second(c) -> Col:
    return Col(dtm.Second(_unwrap(c)))


def date_add(c, days) -> Col:
    return Col(dtm.DateAdd(_unwrap(c), _unwrap(days)))


def date_sub(c, days) -> Col:
    return Col(dtm.DateSub(_unwrap(c), _unwrap(days)))


def datediff(end, start) -> Col:
    return Col(dtm.DateDiff(_unwrap(end), _unwrap(start)))


def add_months(c, months) -> Col:
    return Col(dtm.AddMonths(_unwrap(c), _unwrap(months)))


def last_day(c) -> Col:
    return Col(dtm.LastDay(_unwrap(c)))


def unix_timestamp(c) -> Col:
    return Col(dtm.UnixTimestamp(_unwrap(c)))


def from_unixtime(c) -> Col:
    return Col(dtm.FromUnixTime(_unwrap(c)))


def to_date(c) -> Col:
    return Col(dtm.ToDate(_unwrap(c)))


# -- strings ---------------------------------------------------------------

def length(c) -> Col:
    return Col(st.Length(_unwrap(c)))


def upper(c) -> Col:
    return Col(st.Upper(_unwrap(c)))


def lower(c) -> Col:
    return Col(st.Lower(_unwrap(c)))


def initcap(c) -> Col:
    return Col(st.InitCap(_unwrap(c)))


def substring(c, pos, length) -> Col:
    return Col(st.Substring(_unwrap(c), ex.Literal(pos), ex.Literal(length)))


def concat(*cols) -> Col:
    return Col(st.ConcatStr(*[_unwrap(c) for c in cols]))


def trim(c) -> Col:
    return Col(st.StringTrim(_unwrap(c)))


def ltrim(c) -> Col:
    return Col(st.StringTrimLeft(_unwrap(c)))


def rtrim(c) -> Col:
    return Col(st.StringTrimRight(_unwrap(c)))


def lpad(c, width: int, pad: str = " ") -> Col:
    return Col(st.StringLPad(_unwrap(c), width, pad))


def rpad(c, width: int, pad: str = " ") -> Col:
    return Col(st.StringRPad(_unwrap(c), width, pad))


def locate(substr: str, c, pos: int = 1) -> Col:
    return Col(st.StringLocate(ex.Literal(substr), _unwrap(c),
                               ex.Literal(pos)))


def instr(c, substr: str) -> Col:
    return Col(st.StringLocate(ex.Literal(substr), _unwrap(c),
                               ex.Literal(1)))


def replace(c, search: str, replacement: str = "") -> Col:
    return Col(st.StringReplace(_unwrap(c), search, replacement))


# -- window ----------------------------------------------------------------

def row_number() -> Col:
    from ..ops.window import RowNumber
    return Col(RowNumber())


def rank() -> Col:
    from ..ops.window import Rank
    return Col(Rank())


def dense_rank() -> Col:
    from ..ops.window import DenseRank
    return Col(DenseRank())


def lead(c, offset: int = 1, default=None) -> Col:
    from ..ops.window import Lead
    return Col(Lead(_unwrap(col(c) if isinstance(c, str) else c), offset,
                    default))


def lag(c, offset: int = 1, default=None) -> Col:
    from ..ops.window import Lag
    return Col(Lag(_unwrap(col(c) if isinstance(c, str) else c), offset,
                   default))


# -- arrays, maps and generators -----------------------------------------

def explode(c) -> Col:
    from ..ops import arrays as ar_ops
    return Col(ar_ops.Explode(_unwrap(c)))


def posexplode(c) -> Col:
    from ..ops import arrays as ar_ops
    return Col(ar_ops.Explode(_unwrap(c), pos=True))


def split(c, delimiter: str) -> Col:
    from ..ops import arrays as ar_ops
    return Col(ar_ops.StringSplit(_unwrap(c), delimiter))


def size(c) -> Col:
    from ..ops import arrays as ar_ops
    return Col(ar_ops.Size(_unwrap(c)))


def _key_literal(v) -> ex.Expression:
    import numpy as np
    if isinstance(v, np.integer):
        v = int(v)
    elif isinstance(v, np.floating):
        v = float(v)
    elif isinstance(v, np.bool_):
        v = bool(v)
    return ex.Literal(v)


def get_item(c, index) -> Col:
    """c[index]: an array's 0-based element or a map's value."""
    from ..ops import maps as mp_ops
    key = _unwrap(index) if isinstance(index, Col) else _key_literal(index)
    return Col(mp_ops.GetItem(_unwrap(c), key))


def element_at(c, key) -> Col:
    """element_at(map, key) / element_at(array, 1-based index; negative
    from the end)."""
    from ..ops import maps as mp_ops
    k = _unwrap(key) if isinstance(key, Col) else _key_literal(key)
    return Col(mp_ops.GetItem(_unwrap(c), k, one_based=True))


def create_map(*cols) -> Col:
    from ..ops import maps as mp_ops
    return Col(mp_ops.CreateMap(*[_unwrap(c) for c in cols]))


def map_keys(c) -> Col:
    from ..ops import maps as mp_ops
    return Col(mp_ops.MapKeys(_unwrap(c)))


def map_values(c) -> Col:
    from ..ops import maps as mp_ops
    return Col(mp_ops.MapValues(_unwrap(c)))
