"""Conditional expressions: the port of spark_rapids_tpu/ops/conditionals.py
(If, CaseWhen, Coalesce, Nvl, NullIf, Greatest, Least).

Every branch is evaluated over the whole batch and selected by mask, as
in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar
from .expressions import Expression, data_validity, materialize


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


class Coalesce(Expression):
    """GpuCoalesce: the first non-NULL argument."""

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return all(c.nullable for c in self.children)

    def eval(self, batch: ColumnarBatch):
        cap = batch.capacity
        result = Column.full_null(self.dtype, cap, batch.device)
        decided = torch.zeros(cap, dtype=torch.bool, device=batch.device)
        for child in self.children:
            v = materialize(child.eval(batch), batch)
            take = (~decided) & v.validity
            result = _select(take, v, result, self.dtype, cap)
            decided = decided | v.validity
        return result


class Nvl(Coalesce):
    """ifnull/nvl: two-argument coalesce."""


class NullIf(Expression):
    """nullif(a, b): NULL where a = b (Spark's NaN equality), else a."""

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, batch: ColumnarBatch):
        from .predicates import float_eq
        from .strings_util import string_equal
        cap, device = batch.capacity, batch.device
        a = materialize(self.children[0].eval(batch), batch)
        bv = self.children[1].eval(batch)
        if isinstance(bv, Column):
            bvalid = bv.validity
        else:
            bvalid = torch.full((cap,), not bv.is_null, dtype=torch.bool,
                                device=device)
        if self.dtype == dt.STRING:
            eq = string_equal(a, bv, cap, device)
        else:
            bd, _ = data_validity(bv, self.dtype, device)
            eq = float_eq(a.data, bd) if self.dtype.is_floating \
                else (a.data == bd)
        eq_mask = eq.expand(cap) & bvalid & a.validity
        validity = a.validity & ~eq_mask
        if self.dtype == dt.STRING:
            return Column(self.dtype, a.data, validity, a.lengths)
        return Column(self.dtype, torch.where(
            validity, a.data, torch.zeros((), dtype=a.data.dtype,
                                          device=device)), validity)


class _MinMaxN(Expression):
    """Least/Greatest: NULLs skipped, NULL only when every input is; NaN
    is the largest value (Spark's ordering)."""

    _take_greater: bool

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return all(c.nullable for c in self.children)

    def eval(self, batch: ColumnarBatch):
        from .predicates import float_lt
        from .strings_util import string_compare
        cap = batch.capacity
        result = Column.full_null(self.dtype, cap, batch.device)
        for child in self.children:
            v = materialize(child.eval(batch), batch)
            if self.dtype == dt.STRING:
                cmp = string_compare(v, result, cap, batch.device)
                better = cmp > 0 if self._take_greater else cmp < 0
            elif self.dtype.is_floating:
                better = float_lt(result.data, v.data) \
                    if self._take_greater else float_lt(v.data, result.data)
            else:
                better = v.data > result.data if self._take_greater \
                    else v.data < result.data
            take = v.validity & (~result.validity | better)
            result = _select(take, v, result, self.dtype, cap)
        return result


class Greatest(_MinMaxN):
    _take_greater = True


class Least(_MinMaxN):
    _take_greater = False
