"""STRUCT field access: the port of spark_rapids_tpu/ops/structs.py.

The planner shreds every field a scan's struct column is read through into
a flat scan column (plan/overrides._shred_struct_columns); a ``GetField``
left to run reads the device StructColumn's child, masked by the struct's
validity. A view: no kernel."""

from __future__ import annotations

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, StructColumn
from .expressions import Expression, materialize


class GetField(Expression):
    """struct.field (GetStructField)."""

    fusable = False          # the reference's flag: an eager child view

    def __init__(self, child: Expression, field: str):
        super().__init__(child)
        self.field = field

    @property
    def dtype(self) -> dt.DType:
        child_t = self.children[0].dtype
        if not dt.is_struct(child_t):
            raise TypeError(f"getField on non-struct {child_t}")
        for n, t in child_t.fields:
            if n == self.field:
                return t
        raise TypeError(f"no field {self.field!r} in {child_t}")

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, batch: ColumnarBatch):
        col = materialize(self.children[0].eval(batch), batch)
        if not isinstance(col, StructColumn):
            raise RuntimeError("GetField reached a non-struct column")
        child = col.field(self.field)
        valid = child.validity & col.validity
        if isinstance(child, StructColumn):
            return StructColumn(child.dtype, child.children, valid)
        return Column(child.dtype, child.data, valid, child.lengths,
                      child.elem_validity)

    def __repr__(self):
        return f"{self.children[0]!r}.{self.field}"
