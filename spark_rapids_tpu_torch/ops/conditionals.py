"""Conditional expressions: the port of If and CaseWhen from
spark_rapids_tpu/ops/conditionals.py.

Both branches are evaluated over the whole batch and selected by mask, as
in the reference. Coalesce, NullIf, Greatest and Least are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .expressions import Expression, materialize


def _select(mask: torch.Tensor, a: Column, b: Column, dtype: dt.DType,
            capacity: int) -> Column:
    """Row-wise select between two materialized columns of one dtype."""
    mask = mask.expand(capacity)
    validity = torch.where(mask, a.validity, b.validity)
    if dtype == dt.STRING:
        w = max(a.data.shape[1], b.data.shape[1])
        ad = torch.nn.functional.pad(a.data, (0, w - a.data.shape[1]))
        bd = torch.nn.functional.pad(b.data, (0, w - b.data.shape[1]))
        data = torch.where(mask[:, None], ad, bd)
        lengths = torch.where(mask, a.lengths, b.lengths)
        return Column(dtype, data, validity, lengths)
    return Column(dtype, torch.where(mask, a.data, b.data), validity)


def _bool_mask(v, capacity: int, device) -> torch.Tensor:
    """Predicate value -> taken mask (a NULL predicate is not taken)."""
    if isinstance(v, Scalar):
        taken = bool(v.value) if not v.is_null else False
        return torch.full((capacity,), taken, dtype=torch.bool,
                          device=device)
    return v.data & v.validity


class If(Expression):
    """children = [predicate, true value, false value]."""

    @property
    def dtype(self) -> dt.DType:
        return self.children[1].dtype

    def eval(self, batch: ColumnarBatch):
        pred = self.children[0].eval(batch)
        tv = self.children[1].eval(batch)
        fv = self.children[2].eval(batch)
        if isinstance(pred, Scalar) and isinstance(tv, Scalar) and \
                isinstance(fv, Scalar):
            taken = bool(pred.value) if not pred.is_null else False
            return tv if taken else fv
        mask = _bool_mask(pred, batch.capacity, batch.device)
        return _select(mask, materialize(tv, batch), materialize(fv, batch),
                       self.dtype, batch.capacity)


class CaseWhen(Expression):
    """children = [cond1, val1, cond2, val2, ..., (else)]; the first
    branch whose condition holds wins."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        flat: List[Expression] = []
        for c, v in branches:
            flat.extend([c, v])
        if else_value is not None:
            flat.append(else_value)
        super().__init__(*flat)
        self.num_branches = len(branches)
        self.has_else = else_value is not None

    @property
    def dtype(self) -> dt.DType:
        return self.children[1].dtype

    def eval(self, batch: ColumnarBatch):
        cap = batch.capacity
        if self.has_else:
            result = materialize(self.children[-1].eval(batch), batch)
        else:
            result = Column.full_null(self.dtype, cap, batch.device)
        # last branch first, so the first matching branch wins
        for i in reversed(range(self.num_branches)):
            cond = self.children[2 * i].eval(batch)
            val = materialize(self.children[2 * i + 1].eval(batch), batch)
            mask = _bool_mask(cond, cap, batch.device)
            result = _select(mask, val, result, self.dtype, cap)
        return result
