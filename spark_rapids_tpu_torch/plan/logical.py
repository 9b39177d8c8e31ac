"""Logical plan: the port of spark_rapids_tpu/plan/logical.py (scan, project,
filter, aggregate, join, sort, limit, repartition, window, generate) with its
analysis: name resolution and the numeric/date coercions that insert
implicit casts, and the size estimate the join strategy reads
(``stats_bytes``).

The scan's data is a :class:`HostTable` of numpy columns; the port needs no
pyarrow on the main path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.column import (Column, HostNested, column_arity,
                                utf8_lengths)
from ..ops import arithmetic as ar
from ..ops import conditionals as co
from ..ops import expressions as ex
from ..ops import math_ops as mo
from ..ops import predicates as pr
from ..ops.cast import Cast


class HostTable:
    """An immutable in-memory table: one numpy array per column, plus
    optional validity arrays (True = valid), in schema order.

    ``select`` returns a column-pruned view that shares the arrays and
    keeps ``base`` pointing at the original table: the scan's device cache
    is keyed by the base table and the kept names."""

    def __init__(self, columns: Dict[str, np.ndarray], schema: dt.Schema,
                 validity: Optional[Dict[str, np.ndarray]] = None,
                 base: Optional["HostTable"] = None):
        self.columns = columns
        self.schema = schema
        self.validity = validity or {}
        self.base = base if base is not None else self
        self._col_bytes: Dict[str, int] = {}   # nbytes per column, on base
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of different lengths: {lens}")
        self.num_rows = lens.pop() if lens else 0

    def select(self, names: Sequence[str]) -> "HostTable":
        schema = dt.Schema([self.schema[n] for n in names])
        return HostTable({n: self.columns[n] for n in names}, schema,
                         {n: v for n, v in self.validity.items()
                          if n in names}, base=self.base)

    def shredded(self, fields: Dict[str, Sequence[str]]) -> "HostTable":
        """The table with each struct column of ``fields`` replaced by the
        named fields as flat columns ``struct.field`` (each NULL where the
        struct is), on the same base table."""
        columns, validity, schema = {}, {}, []
        for f in self.schema:
            if f.name not in fields:
                columns[f.name] = self.columns[f.name]
                if f.name in self.validity:
                    validity[f.name] = self.validity[f.name]
                schema.append(f)
                continue
            arrays = self.columns[f.name].arrays
            i = 1
            for fname, ftype in f.dtype.fields:
                k = column_arity(ftype)
                sub = arrays[i:i + k]
                i += k
                if fname not in fields[f.name]:
                    continue
                name = f"{f.name}.{fname}"
                schema.append(dt.Field(name, ftype))
                if ftype.var_width:
                    columns[name] = HostNested(ftype, sub)
                else:
                    columns[name], validity[name] = sub
        return HostTable(columns, dt.Schema(schema), validity, base=self.base)

    def nbytes(self) -> int:
        """The table's bytes counted as arrow's ``Table.nbytes`` counts
        them, so that both engines pick the same join strategy: data
        (booleans as bits; strings as their UTF-8 bytes of the valid rows
        plus 4 offset bytes a row) and a validity bitmap for a column
        with NULLs."""
        return sum(self._column_nbytes(f) for f in self.schema)

    def _column_nbytes(self, f: dt.Field) -> int:
        cache = self.base._col_bytes
        if f.name not in cache:
            values = self.columns[f.name]
            n = len(values)
            v = self.validity.get(f.name)
            nulls = v is not None and not bool(np.all(v))
            if isinstance(values, HostNested):
                size = _flat_nbytes(f.dtype, values.arrays)
                nulls = False
            elif f.dtype == dt.STRING:
                lens = utf8_lengths(values)
                if v is not None:
                    lens = lens[np.asarray(v, np.bool_)]
                size = 4 * n + int(lens.sum())
            elif f.dtype == dt.BOOL:
                size = (n + 7) // 8
            else:
                size = n * f.dtype.byte_width
            cache[f.name] = size + ((n + 7) // 8 if nulls else 0)
        return cache[f.name]

    def host_arrays(self, lo: int, rows: int, capacity: int):
        """Padded host arrays of rows [lo, lo + rows) for every column."""
        out = []
        for f in self.schema:
            v = self.validity.get(f.name)
            out.append(Column.host_arrays(
                self.columns[f.name][lo:lo + rows], f.dtype,
                None if v is None else v[lo:lo + rows], capacity))
        return out


def _flat_nbytes(t: dt.DType, arrays) -> int:
    """Arrow's byte count of a column held as the device layout's flat
    arrays (unpadded): a validity bitmap where there are NULLs; a string's
    4 offset bytes a row and its bytes; an ARRAY's or a MAP's 4 offset
    bytes a row and its entries' values (plus their bitmap where one is
    NULL); a STRUCT's fields."""
    valid = np.asarray(arrays[0] if dt.is_struct(t) else arrays[1])
    n = len(valid)
    size = (n + 7) // 8 if not bool(valid.all()) else 0
    if dt.is_struct(t):
        i = 1
        for _, ft in t.fields:
            k = column_arity(ft)
            size += _flat_nbytes(ft, arrays[i:i + k])
            i += k
        return size
    if t == dt.STRING:
        return size + 4 * n + int(arrays[2][valid].sum())
    if not t.var_width:
        return size + ((n + 7) // 8 if t == dt.BOOL else n * t.byte_width)
    lens = arrays[2]
    entries = int(lens.sum())
    if dt.is_map(t):
        flags = arrays[0][:, 2::3] != 0
        per_entry = t.key.byte_width + t.element.byte_width
    else:
        flags = arrays[3]
        per_entry = t.element.byte_width
    lane = np.arange(flags.shape[1])[None, :] < lens[:, None]
    nulls = bool((lane & ~flags).any())
    return size + 4 * n + entries * per_entry + \
        ((entries + 7) // 8 if nulls else 0)


class SortOrder:
    def __init__(self, child: ex.Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.child = child
        self.ascending = ascending
        # Spark default: NULLS FIRST for asc, NULLS LAST for desc
        self.nulls_first = ascending if nulls_first is None else nulls_first

    def __repr__(self):
        return (f"{self.child!r} {'ASC' if self.ascending else 'DESC'} "
                f"NULLS {'FIRST' if self.nulls_first else 'LAST'}")


class AggregateExpression(ex.Expression):
    """Marks an aggregate call inside an Aggregate node's output list."""

    AGG_OPS = ("count", "count_star", "sum", "min", "max", "avg", "first",
               "last")

    def __init__(self, op: str, child: Optional[ex.Expression],
                 ignore_nulls: bool = True, distinct: bool = False):
        super().__init__(*([child] if child is not None else []))
        if op not in self.AGG_OPS:
            raise ValueError(f"unknown aggregate {op!r}")
        self.op = op
        self.ignore_nulls = ignore_nulls
        self.distinct = distinct

    @property
    def dtype(self) -> dt.DType:
        from ..ops.aggregates import result_dtype
        child_t = self.children[0].dtype if self.children else None
        return result_dtype(self.op, child_t)

    @property
    def nullable(self) -> bool:
        return self.op not in ("count", "count_star")

    def eval(self, batch):
        raise RuntimeError("AggregateExpression is planned, not evaluated")

    def __repr__(self):
        arg = repr(self.children[0]) if self.children else "*"
        return f"{self.op}({'DISTINCT ' if self.distinct else ''}{arg})"


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------

class LogicalPlan:
    def __init__(self, *children: "LogicalPlan"):
        self.children: List[LogicalPlan] = list(children)
        self._schema: Optional[dt.Schema] = None

    @property
    def schema(self) -> dt.Schema:
        if self._schema is None:
            self._schema = self._compute_schema()
        return self._schema

    def _compute_schema(self) -> dt.Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def expressions(self) -> List[ex.Expression]:
        return []

    def stats_bytes(self) -> int:
        """Size estimate for the join strategy: leaf sizes summed up the
        tree (a filter keeps its input's size), as the reference's."""
        if not self.children:
            return 1 << 60          # unknown leaf: never broadcast
        return sum(c.stats_bytes() for c in self.children)

    def __repr__(self):
        return self._tree_string(0)

    def _node_string(self) -> str:
        return self.name

    def _tree_string(self, depth: int) -> str:
        out = "  " * depth + self._node_string()
        for c in self.children:
            out += "\n" + c._tree_string(depth + 1)
        return out


class LocalScan(LogicalPlan):
    """In-memory table scan. The table is shared, never copied, when plans
    are copied for analysis."""

    def __init__(self, data: HostTable):
        super().__init__()
        self.data = data

    def __deepcopy__(self, memo):
        c = LocalScan(self.data)
        memo[id(self)] = c
        return c

    def _compute_schema(self) -> dt.Schema:
        return self.data.schema

    def stats_bytes(self) -> int:
        return self.data.nbytes()

    def _node_string(self):
        return f"LocalScan [{', '.join(self.schema.names())}]"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: List[ex.Expression]):
        super().__init__(child)
        self.exprs = exprs

    def expressions(self):
        return self.exprs

    def _compute_schema(self) -> dt.Schema:
        return dt.Schema([dt.Field(ex.output_name(e, i), e.dtype, e.nullable)
                          for i, e in enumerate(self.exprs)])


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: ex.Expression):
        super().__init__(child)
        self.condition = condition

    def expressions(self):
        return [self.condition]

    def _compute_schema(self) -> dt.Schema:
        return self.children[0].schema


class Aggregate(LogicalPlan):
    """Group-by aggregate; aggregate calls appear as AggregateExpression
    subtrees of ``aggregate_exprs``."""

    def __init__(self, child: LogicalPlan, grouping: List[ex.Expression],
                 aggregate_exprs: List[ex.Expression]):
        super().__init__(child)
        self.grouping = grouping
        self.aggregate_exprs = aggregate_exprs

    def expressions(self):
        return self.grouping + self.aggregate_exprs

    def _compute_schema(self) -> dt.Schema:
        return dt.Schema([dt.Field(ex.output_name(e, i), e.dtype, e.nullable)
                          for i, e in enumerate(self.aggregate_exprs)])


class Join(LogicalPlan):
    """Join of two plans on ``condition`` (None: a cross join). The output
    is the left columns then the right ones; semi and anti joins output
    the left columns only."""

    JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
                  "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan, how: str,
                 condition: Optional[ex.Expression] = None):
        super().__init__(left, right)
        if how not in self.JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}")
        self.how = how
        self.condition = condition

    def expressions(self):
        return [self.condition] if self.condition is not None else []

    def _compute_schema(self) -> dt.Schema:
        left, right = self.children[0].schema, self.children[1].schema
        if self.how in ("left_semi", "left_anti"):
            return left
        fields = list(left.fields)
        if self.how == "full":
            fields = [dt.Field(f.name, f.dtype, True) for f in fields]
        r_null = self.how in ("left", "full")
        return dt.Schema(fields + [
            dt.Field(f.name, f.dtype, True if r_null else f.nullable)
            for f in right.fields])

    def _node_string(self):
        return f"Join {self.how} on={self.condition!r}"


class Sort(LogicalPlan):
    """Global sort."""

    def __init__(self, child: LogicalPlan, orders: List[SortOrder]):
        super().__init__(child)
        self.orders = orders

    def expressions(self):
        return [o.child for o in self.orders]

    def _compute_schema(self) -> dt.Schema:
        return self.children[0].schema


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        super().__init__(child)
        self.n = n

    def _compute_schema(self) -> dt.Schema:
        return self.children[0].schema


class Repartition(LogicalPlan):
    """repartition(n[, cols]) / coalesce(n): an exchange into n
    partitions, hashed on ``by`` when given, else round robin."""

    def __init__(self, child: LogicalPlan, num_partitions: int,
                 by: Optional[List[ex.Expression]] = None):
        super().__init__(child)
        self.num_partitions = num_partitions
        self.by = by

    def expressions(self):
        return self.by or []

    def _compute_schema(self) -> dt.Schema:
        return self.children[0].schema

    def _node_string(self):
        return f"Repartition {self.num_partitions} by={self.by}"


class Window(LogicalPlan):
    """Window operator: the child's columns, then one column per window
    expression. ``window_exprs``: (name, WindowExpression) pairs."""

    def __init__(self, child: LogicalPlan, window_exprs: List[tuple]):
        super().__init__(child)
        self.window_exprs = window_exprs

    def expressions(self):
        return [w for _, w in self.window_exprs]

    def _compute_schema(self) -> dt.Schema:
        fields = list(self.children[0].schema.fields)
        for name, w in self.window_exprs:
            fields.append(dt.Field(name, w.dtype, True))
        return dt.Schema(fields)


class Generate(LogicalPlan):
    """explode/posexplode (GpuGenerateExec): the child's columns, then
    ``pos`` (posexplode) and ``col``, one row per element; a NULL or empty
    array gives no row."""

    def __init__(self, child: LogicalPlan, generator: ex.Expression,
                 col_name: str = "col", pos_name: str = "pos"):
        super().__init__(child)
        self.generator = generator          # ops.arrays.Explode
        self.col_name = col_name
        self.pos_name = pos_name

    def expressions(self):
        return [self.generator]

    def _compute_schema(self) -> dt.Schema:
        fields = list(self.children[0].schema.fields)
        if self.generator.pos:
            fields.append(dt.Field(self.pos_name, dt.INT32, False))
        fields.append(dt.Field(self.col_name, self.generator.dtype, True))
        return dt.Schema(fields)

    def _node_string(self):
        return f"Generate [{self.generator!r}]"


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

class AnalysisError(Exception):
    pass


def _resolve_expr(e: ex.Expression, schema: dt.Schema) -> ex.Expression:
    def fn(node):
        if isinstance(node, ex.ColumnRef):
            if node.col_name not in schema:
                raise AnalysisError(
                    f"cannot resolve column {node.col_name!r}; "
                    f"available: {schema.names()}")
            return node.resolve(schema)
        return None
    return e.transform(fn)


def _coerce(e: ex.Expression) -> ex.Expression:
    """Insert implicit casts for numeric binary ops and comparisons."""

    def fn(node):
        if isinstance(node, (ar.BinaryArithmetic, pr.BinaryComparison,
                             pr.EqualNullSafe)):
            l, r = node.children
            lt, rt = l.dtype, r.dtype
            if lt == rt:
                if isinstance(node, ar.Divide) and lt.is_integral:
                    return node.with_children([Cast(l, dt.FLOAT64),
                                               Cast(r, dt.FLOAT64)])
                return None
            if lt == dt.NULLTYPE:
                return node.with_children([Cast(l, rt), r])
            if rt == dt.NULLTYPE:
                return node.with_children([l, Cast(r, lt)])
            if lt.is_numeric and rt.is_numeric or \
                    {lt, rt} <= {dt.BOOL, *dt.NUMERIC_TYPES}:
                target = dt.promote(lt if lt != dt.BOOL else dt.INT8,
                                    rt if rt != dt.BOOL else dt.INT8)
                if isinstance(node, ar.Divide):
                    target = dt.FLOAT64
                nl = l if lt == target else Cast(l, target)
                nr = r if rt == target else Cast(r, target)
                return node.with_children([nl, nr])
            if (lt in (dt.DATE, dt.TIMESTAMP) and rt.is_integral) or \
                    (rt in (dt.DATE, dt.TIMESTAMP) and lt.is_integral):
                # int literal vs date/timestamp: reinterpret the int side
                target = lt if lt in (dt.DATE, dt.TIMESTAMP) else rt
                nl = l if lt == target else Cast(l, target)
                nr = r if rt == target else Cast(r, target)
                return node.with_children([nl, nr])
            raise AnalysisError(f"cannot coerce {lt} vs {rt} in {node!r}")
        if isinstance(node, mo.UnaryMath):
            c = node.children[0]
            if c.dtype != dt.FLOAT64:
                return node.with_children([Cast(c, dt.FLOAT64)])
            return None
        if isinstance(node, AggregateExpression) and node.children:
            c = node.children[0]
            if node.op in ("sum", "avg") and c.dtype == dt.BOOL:
                return node.with_children([Cast(c, dt.INT32)])
        if isinstance(node, (co.If, co.CaseWhen, co.Coalesce, co.Least,
                             co.Greatest)):
            return _coerce_branches(node)
        return None

    return e.transform(fn)


def _coerce_branches(node):
    """Cast the value branches of If/CaseWhen (every argument of
    Coalesce, Least and Greatest) to one result type."""
    n = len(node.children)
    if isinstance(node, co.If):
        positions = [1, 2]
    elif not isinstance(node, co.CaseWhen):
        positions = list(range(n))
    else:
        positions = [2 * i + 1 for i in range(node.num_branches)]
        if node.has_else:
            positions.append(n - 1)
    dts = [node.children[i].dtype for i in positions
           if node.children[i].dtype != dt.NULLTYPE]
    if not dts:
        return None
    target = dts[0]
    for t in dts[1:]:
        if t != target:
            target = dt.promote(target, t)
    children = list(node.children)
    changed = False
    for i in positions:
        if children[i].dtype != target:
            children[i] = Cast(children[i], target)
            changed = True
    return node.with_children(children) if changed else None


def analyze(plan: LogicalPlan) -> LogicalPlan:
    """Bottom-up resolve and coerce, in place."""
    for c in plan.children:
        analyze(c)
    child_schema = plan.children[0].schema if plan.children else None

    def ra(e):
        e = _resolve_expr(e, child_schema) if child_schema else e
        return _coerce(e)

    if isinstance(plan, Project):
        plan.exprs = [ra(e) for e in plan.exprs]
    elif isinstance(plan, Filter):
        plan.condition = ra(plan.condition)
        if plan.condition.dtype != dt.BOOL:
            raise AnalysisError(
                f"filter condition must be boolean, got "
                f"{plan.condition.dtype}")
    elif isinstance(plan, Aggregate):
        # computed grouping keys are matched BY IDENTITY in the result
        # projection: an output subtree that is a grouping member must
        # resolve to the same object the grouping list resolves to
        old_grouping = list(plan.grouping)
        plan.grouping = [ra(e) for e in plan.grouping]
        ident = {id(o): n for o, n in zip(old_grouping, plan.grouping)}
        plan.aggregate_exprs = [
            ra(e.transform_down(lambda n: ident.get(id(n))))
            for e in plan.aggregate_exprs]
    elif isinstance(plan, Join):
        if plan.condition is not None:
            left, right = plan.children[0].schema, plan.children[1].schema
            merged = dt.Schema(list(left.fields) + list(right.fields))
            plan.condition = _coerce(_resolve_expr(plan.condition, merged))
            if plan.condition.dtype != dt.BOOL:
                raise AnalysisError(
                    f"join condition must be boolean, got "
                    f"{plan.condition.dtype}")
    elif isinstance(plan, Sort):
        plan.orders = [SortOrder(ra(o.child), o.ascending, o.nulls_first)
                       for o in plan.orders]
    elif isinstance(plan, Repartition) and plan.by:
        plan.by = [ra(e) for e in plan.by]
    elif isinstance(plan, Window):
        plan.window_exprs = [(n, w.resolve_refs(child_schema))
                             for n, w in plan.window_exprs]
    elif isinstance(plan, Generate):
        plan.generator = ra(plan.generator)
    plan._schema = None
    return plan

