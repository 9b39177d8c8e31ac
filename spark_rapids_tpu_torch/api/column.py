"""Column wrapper: the operator-overloaded expression builder (pyspark
``Column``), ported from spark_rapids_tpu/api/column.py for the main-path
operators (with ``%``, unary ``-`` and ``eqNullSafe``), ``isin``, the
string predicates ``contains``, ``startswith``, ``endswith`` and ``like``,
``substr``, ``cast``, ``over`` (window functions), ``getField`` and the
``when(...).otherwise(...)`` chain."""

from __future__ import annotations

from typing import Any

from ..ops import arithmetic as ar
from ..ops import conditionals as co
from ..ops import expressions as ex
from ..ops import predicates as pr
from ..ops import strings as st
from ..plan import logical as lp


def _unwrap(v: Any) -> ex.Expression:
    if isinstance(v, Col):
        return v.expr
    if isinstance(v, ex.Expression):
        return v
    return ex.Literal(v)


class Col:
    def __init__(self, expr: ex.Expression):
        self.expr = expr

    # arithmetic
    def __add__(self, o): return Col(ar.Add(self.expr, _unwrap(o)))
    def __radd__(self, o): return Col(ar.Add(_unwrap(o), self.expr))
    def __sub__(self, o): return Col(ar.Subtract(self.expr, _unwrap(o)))
    def __rsub__(self, o): return Col(ar.Subtract(_unwrap(o), self.expr))
    def __mul__(self, o): return Col(ar.Multiply(self.expr, _unwrap(o)))
    def __rmul__(self, o): return Col(ar.Multiply(_unwrap(o), self.expr))
    def __truediv__(self, o): return Col(ar.Divide(self.expr, _unwrap(o)))
    def __rtruediv__(self, o): return Col(ar.Divide(_unwrap(o), self.expr))
    def __mod__(self, o): return Col(ar.Remainder(self.expr, _unwrap(o)))
    def __neg__(self): return Col(ar.UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, o): return Col(pr.EqualTo(self.expr, _unwrap(o)))  # type: ignore[override]
    def __ne__(self, o): return Col(pr.NotEqual(self.expr, _unwrap(o)))  # type: ignore[override]
    def __lt__(self, o): return Col(pr.LessThan(self.expr, _unwrap(o)))
    def __le__(self, o): return Col(pr.LessThanOrEqual(self.expr, _unwrap(o)))
    def __gt__(self, o): return Col(pr.GreaterThan(self.expr, _unwrap(o)))
    def __ge__(self, o): return Col(pr.GreaterThanOrEqual(self.expr, _unwrap(o)))
    def eqNullSafe(self, o): return Col(pr.EqualNullSafe(self.expr, _unwrap(o)))

    # boolean
    def __and__(self, o): return Col(pr.And(self.expr, _unwrap(o)))
    def __or__(self, o): return Col(pr.Or(self.expr, _unwrap(o)))
    def __invert__(self): return Col(pr.Not(self.expr))

    def isNull(self): return Col(pr.IsNull(self.expr))
    def isNotNull(self): return Col(pr.IsNotNull(self.expr))

    def isin(self, *values):
        vals = list(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, tuple, set)) else list(values)
        return Col(pr.In(self.expr, vals))

    # string predicates
    def contains(self, other):
        return Col(st.Contains(self.expr, _unwrap(other)))

    def startswith(self, other):
        return Col(st.StartsWith(self.expr, _unwrap(other)))

    def endswith(self, other):
        return Col(st.EndsWith(self.expr, _unwrap(other)))

    def like(self, pattern: str):
        return Col(st.Like(self.expr, pattern))

    def substr(self, start, length):
        return Col(st.Substring(self.expr, _unwrap(start), _unwrap(length)))

    def getField(self, name: str) -> "Col":
        """struct.field (GetStructField; the planner shreds it into a flat
        scan column where it can)."""
        from ..ops.structs import GetField
        return Col(GetField(self.expr, name))

    def alias(self, name: str) -> "Col":
        return Col(ex.Alias(self.expr, name))

    def cast(self, to) -> "Col":
        from ..columnar import dtypes as dt
        from ..ops.cast import Cast
        return Col(Cast(self.expr, dt.of(to)))

    def asc(self) -> lp.SortOrder:
        return lp.SortOrder(self.expr, ascending=True)

    def desc(self) -> lp.SortOrder:
        return lp.SortOrder(self.expr, ascending=False)

    def over(self, spec) -> "Col":
        """This aggregate or window function over a window spec
        (api/window.py); select and withColumn lift the result into a
        Window node."""
        from ..ops.window import WindowExpression
        return Col(WindowExpression(self.expr, spec._to_spec()))

    def when(self, condition, value):
        raise TypeError("use functions.when(cond, value).otherwise(...)")

    def otherwise(self, value):
        raise TypeError("otherwise() only valid on a when() chain")

    def __repr__(self):
        return f"Col({self.expr!r})"

    __hash__ = None  # type: ignore[assignment]


class WhenChain(Col):
    """functions.when(...).when(...).otherwise(...) builder."""

    def __init__(self, branches, else_value=None):
        self._branches = branches
        self._else = else_value
        super().__init__(co.CaseWhen(branches, else_value))

    def when(self, condition, value):
        return WhenChain(self._branches + [(_unwrap(condition),
                                            _unwrap(value))], self._else)

    def otherwise(self, value):
        return WhenChain(self._branches, _unwrap(value))
