"""Expression tree base classes: the port of spark_rapids_tpu/ops/expressions.py.

``eval(batch)`` returns a :class:`Column` or a :class:`Scalar`, as in the
reference (expressions.py:37). Evaluation is eager: one torch op per node
on the batch's device. A stage's expressions also compile into one
generated kernel (plan/stage_codegen.py); ``fusable`` and
``side_effect_free`` are the reference's flags that decide, at plan time,
which operators may join a fused stage.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Union

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, storage_dtype

ColumnOrScalar = Union[Column, Scalar]


class Expression:
    """Base expression. Subclasses set ``children`` and implement
    ``dtype``/``eval``. ``fusable``: may join a fused stage (the
    reference's flag; a string cast or a host string expression is not);
    ``side_effect_free``: False for expressions with per-batch state."""

    fusable = True
    side_effect_free = True

    def __init__(self, *children: "Expression"):
        self.children: List[Expression] = list(children)

    @property
    def dtype(self) -> dt.DType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children) if self.children \
            else True

    def eval(self, batch: ColumnarBatch) -> ColumnOrScalar:
        raise NotImplementedError

    # -- tree utilities --------------------------------------------------
    def transform(self, fn) -> "Expression":
        """Bottom-up transform returning a new tree."""
        new_children = [c.transform(fn) for c in self.children]
        node = self
        if any(a is not b for a, b in zip(new_children, self.children)):
            node = self.with_children(new_children)
        replaced = fn(node)
        return node if replaced is None else replaced

    def transform_down(self, fn) -> "Expression":
        """Top-down transform: ``fn`` sees each original node before its
        children are rewritten (needed where ``fn`` matches by identity)."""
        replaced = fn(self)
        if replaced is not None:
            return replaced
        new_children = [c.transform_down(fn) for c in self.children]
        if any(a is not b for a, b in zip(new_children, self.children)):
            return self.with_children(new_children)
        return self

    def with_children(self, children: List["Expression"]) -> "Expression":
        node = copy.copy(self)
        node.children = children
        return node

    def collect(self, pred) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def tree_fusable(self) -> bool:
        return self.fusable and all(c.tree_fusable() for c in self.children)

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__}({args})"


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[dt.DType] = None):
        super().__init__()
        if dtype is None:
            if isinstance(value, bool):
                dtype = dt.BOOL
            elif isinstance(value, int):
                dtype = dt.INT64
            elif isinstance(value, float):
                dtype = dt.FLOAT64
            elif isinstance(value, str):
                dtype = dt.STRING
            elif value is None:
                dtype = dt.NULLTYPE
            else:
                raise TypeError(f"cannot infer literal type for {value!r}")
        self._dtype = dtype
        self.value = value

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval(self, batch: ColumnarBatch) -> Scalar:
        return Scalar(self.value, self._dtype)

    def __repr__(self):
        return f"Literal({self.value!r})"


class ColumnRef(Expression):
    """Name-based column reference (before binding)."""

    def __init__(self, col_name: str):
        super().__init__()
        self.col_name = col_name
        self._resolved: Optional[dt.Field] = None

    def resolve(self, schema: dt.Schema) -> "ColumnRef":
        self._resolved = schema[self.col_name]
        return self

    @property
    def dtype(self) -> dt.DType:
        if self._resolved is None:
            raise RuntimeError(f"unresolved column {self.col_name!r}")
        return self._resolved.dtype

    @property
    def nullable(self) -> bool:
        return self._resolved.nullable if self._resolved else True

    def eval(self, batch: ColumnarBatch) -> Column:
        return batch.column(self.col_name)

    def __repr__(self):
        return f"col({self.col_name!r})"


class BoundReference(Expression):
    """Ordinal-bound input reference."""

    def __init__(self, ordinal: int, dtype: dt.DType, nullable: bool = True,
                 col_name: str = ""):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable
        self.col_name = col_name

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval(self, batch: ColumnarBatch) -> Column:
        return batch.columns[self.ordinal]

    def __repr__(self):
        return f"input[{self.ordinal}, {self._dtype}]"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        super().__init__(child)
        self.alias = alias

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> dt.DType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, batch: ColumnarBatch) -> ColumnOrScalar:
        return self.child.eval(batch)

    def __repr__(self):
        return f"{self.child!r} AS {self.alias}"


def output_name(expr: Expression, idx: int) -> str:
    if isinstance(expr, Alias):
        return expr.alias
    if isinstance(expr, ColumnRef):
        return expr.col_name
    if isinstance(expr, BoundReference) and expr.col_name:
        return expr.col_name
    return f"col{idx}"


# ---------------------------------------------------------------------------
# Eval helpers shared by the concrete expression modules
# ---------------------------------------------------------------------------

def materialize(value: ColumnOrScalar, batch: ColumnarBatch) -> Column:
    """Scalar -> broadcast Column at the batch's capacity."""
    if isinstance(value, Scalar):
        return Column.from_scalar(value, batch.num_rows_raw, batch.capacity,
                                  batch.device)
    return value


def data_validity(value: ColumnOrScalar, dtype: dt.DType, device):
    """(data, validity) pair usable in torch broadcasting. A scalar becomes
    a 0-d tensor plus a python bool validity (True = always valid)."""
    if isinstance(value, Scalar):
        st = storage_dtype(dtype)
        if value.is_null:
            return torch.zeros((), dtype=st, device=device), False
        return torch.tensor(value.value, dtype=st, device=device), True
    return value.data, value.validity


def combine_validity(*vs):
    """AND of validities where python ``True`` means always valid."""
    cols = [v for v in vs if v is not True]
    if any(v is False for v in cols):
        return False
    if not cols:
        return True
    out = cols[0]
    for v in cols[1:]:
        out = out & v
    return out


def result_column(dtype: dt.DType, data: torch.Tensor, validity,
                  capacity: int, lengths=None) -> Column:
    device = data.device
    if validity is True:
        validity = torch.ones(capacity, dtype=torch.bool, device=device)
    elif validity is False:
        validity = torch.zeros(capacity, dtype=torch.bool, device=device)
    if data.dim() == 0 or (dtype != dt.STRING and data.shape[0] != capacity):
        data = data.expand(capacity).contiguous()
    return Column(dtype, data, validity, lengths)
