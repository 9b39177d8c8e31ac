"""pyspark.sql.functions analog: the expression constructors of the main
path and the string functions, ported from spark_rapids_tpu/api/functions.py."""

from __future__ import annotations

from typing import Any

from ..ops import expressions as ex
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


def hash(*cols) -> Col:  # noqa: A001 - pyspark parity
    """Spark's hash(...): Murmur3Hash of the columns, seed 42 (int32)."""
    return Col(Murmur3Hash(*[_unwrap(c) for c in cols]))


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
