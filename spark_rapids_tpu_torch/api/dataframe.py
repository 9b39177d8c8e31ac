"""DataFrame API (the pyspark surface over the logical plan builder), ported
from spark_rapids_tpu/api/dataframe.py for the main-path operators: filter,
select, withColumn (both with window functions; select also with one
explode or posexplode), withColumnRenamed, join, crossJoin,
groupBy().agg, groupBy().count, agg, orderBy, limit, repartition,
coalesce, collect and collect_batch."""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Union

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..ops import expressions as ex
from ..ops import predicates as pr
from ..plan import logical as lp
from .column import Col, _unwrap

ColumnOrName = Union[Col, str]


def _to_expr(c: ColumnOrName) -> ex.Expression:
    if isinstance(c, str):
        return ex.ColumnRef(c)
    return _unwrap(c)


class DataFrame:
    def __init__(self, plan: lp.LogicalPlan, session):
        self._plan = plan
        self.session = session

    @property
    def schema(self) -> dt.Schema:
        return self._analyzed().schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names()

    def _analyzed(self) -> lp.LogicalPlan:
        return lp.analyze(copy.deepcopy(self._plan))

    def _df(self, plan: lp.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.session)

    # -- transformations -------------------------------------------------
    def select(self, *cols: ColumnOrName) -> "DataFrame":
        if not cols:
            cols = tuple(self.columns)
        return self._project([_to_expr(c) for c in cols])

    def _project(self, exprs: List[ex.Expression]) -> "DataFrame":
        lifted = self._lift_generator(exprs)
        if lifted is not None:
            return lifted
        return self._project_windows(exprs)

    def _lift_generator(self, exprs: List[ex.Expression]
                        ) -> Optional["DataFrame"]:
        """explode/posexplode in a select lifts into a Generate node under
        the projection (Catalyst's ExtractGenerator): the projection reads
        its ``pos`` and ``col`` (or the alias) columns."""
        from ..ops import arrays as ar_ops

        def inner(e):
            return e.children[0] if isinstance(e, ex.Alias) else e

        gen_idx = [i for i, e in enumerate(exprs)
                   if isinstance(inner(e), ar_ops.Explode)]
        if not gen_idx:
            return None
        if len(gen_idx) > 1:
            raise ValueError("only one generator per select (Spark rule)")
        i = gen_idx[0]
        g_expr = inner(exprs[i])
        col_name = exprs[i].alias if isinstance(exprs[i], ex.Alias) \
            else "col"
        g = lp.Generate(self._plan, g_expr, col_name=col_name)
        out: List[ex.Expression] = []
        for j, e in enumerate(exprs):
            if j == i:
                if g_expr.pos:
                    out.append(ex.ColumnRef("pos"))
                out.append(ex.ColumnRef(col_name))
            else:
                out.append(e)
        return self._df(g)._project_windows(out)

    def _project_windows(self, exprs: List[ex.Expression]) -> "DataFrame":
        """A projection; its ``Col.over`` window expressions lift into a
        Window node below it (Catalyst's ExtractWindowExpressions): each
        becomes a generated column ``__w<i>`` of an lp.Window, and the
        projection references it, so windows compose inside arithmetic
        (``col("rev") * 100 / sum("rev").over(w)``)."""
        from ..ops.window import WindowExpression
        hoisted: List = []

        def repl(e):
            if isinstance(e, WindowExpression):
                name = f"__w{len(hoisted)}"
                hoisted.append((name, e))
                return ex.ColumnRef(name)
            return None

        exprs = [e.transform_down(repl) for e in exprs]
        child = lp.Window(self._plan, hoisted) if hoisted else self._plan
        return self._df(lp.Project(child, exprs))

    def filter(self, condition: Col) -> "DataFrame":
        return self._df(lp.Filter(self._plan, _unwrap(condition)))

    def withColumn(self, name: str, col: Col) -> "DataFrame":
        exprs: List[ex.Expression] = []
        replaced = False
        for c in self.columns:
            if c == name:
                exprs.append(ex.Alias(_unwrap(col), name))
                replaced = True
            else:
                exprs.append(ex.ColumnRef(c))
        if not replaced:
            exprs.append(ex.Alias(_unwrap(col), name))
        return self._project(exprs)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [ex.Alias(ex.ColumnRef(c), new) if c == old
                 else ex.ColumnRef(c) for c in self.columns]
        return self._df(lp.Project(self._plan, exprs))

    _JOIN_ALIASES = {"outer": "full", "full_outer": "full",
                     "leftouter": "left", "left_outer": "left",
                     "rightouter": "right", "right_outer": "right",
                     "leftsemi": "left_semi", "semi": "left_semi",
                     "leftanti": "left_anti", "anti": "left_anti"}

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join on a Column condition or a list of them (ANDed); ``how``
        inner, left, right, full, left_semi, left_anti or cross (and their
        aliases). Join by column names (``on="k"``) is not ported yet."""
        how = self._JOIN_ALIASES.get(how, how)
        conds = list(on) if isinstance(on, (list, tuple)) else \
            ([] if on is None else [on])
        if any(isinstance(c, str) for c in conds):
            raise NotImplementedError(
                "join on column names is not ported to the PyTorch engine "
                "yet")
        cond = None
        for c in conds:
            cond = _unwrap(c) if cond is None else pr.And(cond, _unwrap(c))
        return self._df(lp.Join(self._plan, other._plan, how, cond))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return self._df(lp.Join(self._plan, other._plan, "cross"))

    def groupBy(self, *cols: ColumnOrName) -> "GroupedData":
        return GroupedData(self, [_to_expr(c) for c in cols])

    def agg(self, *aggs: Col) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def orderBy(self, *cols, ascending: Optional[Any] = None) -> "DataFrame":
        orders = []
        for i, c in enumerate(cols):
            if isinstance(c, lp.SortOrder):
                orders.append(c)
                continue
            asc = True
            if ascending is not None:
                asc = ascending[i] if isinstance(ascending, (list, tuple)) \
                    else bool(ascending)
            orders.append(lp.SortOrder(_to_expr(c), asc))
        return self._df(lp.Sort(self._plan, orders))

    def limit(self, n: int) -> "DataFrame":
        return self._df(lp.Limit(self._plan, n))

    def repartition(self, n: int, *cols: ColumnOrName) -> "DataFrame":
        """n partitions: hashed on ``cols`` (Spark's murmur3 placement),
        round robin without them."""
        by = [_to_expr(c) for c in cols] or None
        return self._df(lp.Repartition(self._plan, n, by))

    def coalesce(self, n: int) -> "DataFrame":
        return self._df(lp.Repartition(self._plan, n))

    # -- actions ---------------------------------------------------------
    def collect_batch(self) -> ColumnarBatch:
        """Run the query; the result stays on the session's device."""
        return self.session._run(self._analyzed())

    def collect(self) -> List[tuple]:
        return self.collect_batch().rows()


class GroupedData:
    def __init__(self, df: DataFrame, grouping: List[ex.Expression]):
        self.df = df
        self.grouping = grouping

    def agg(self, *aggs: Col) -> DataFrame:
        agg_exprs = [_unwrap(a) for a in aggs]
        out: List[ex.Expression] = list(self.grouping) + agg_exprs
        return self.df._df(lp.Aggregate(self.df._plan, self.grouping, out))

    def count(self) -> DataFrame:
        """One ``count`` column a group."""
        return self.agg(Col(ex.Alias(
            lp.AggregateExpression("count_star", None), "count")))
