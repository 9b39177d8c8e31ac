"""The numpy form of a batch, shared with the JAX package.

``batch_from_numpy`` takes the numpy form of a JAX ``ColumnarBatch``
(its field names and type names plus ``[np.asarray(a) for a in
b.flat_arrays()]``) and builds the port's batch from it, so both engines
compute on identical inputs; ``batch_to_numpy`` goes back. The layouts are
the same array for array, so this is a copy, not a conversion. Nothing of
the JAX package is imported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from . import dtypes as dt
from .batch import ColumnarBatch

Fields = Union[dt.Schema, Sequence[Tuple[str, Union[str, dt.DType]]]]


def _schema(fields: Fields) -> dt.Schema:
    if isinstance(fields, dt.Schema):
        return fields
    return dt.Schema([dt.Field(name, dt.of(t)) for name, t in fields])


def batch_from_numpy(fields: Fields, flat_arrays: Sequence[np.ndarray],
                     num_rows: int, device="cpu") -> ColumnarBatch:
    """Port batch from (fields, flat numpy arrays, row count)."""
    tensors = [torch.from_numpy(np.array(a, copy=True)).to(device)
               for a in flat_arrays]
    return ColumnarBatch.from_flat_arrays(_schema(fields), tensors,
                                          int(num_rows))


def batch_to_numpy(batch: ColumnarBatch
                   ) -> Tuple[List[Tuple[str, str]], List[np.ndarray], int]:
    """(fields as (name, type name), flat numpy arrays, row count)."""
    fields = [(f.name, f.dtype.name) for f in batch.schema]
    arrays = [a.cpu().numpy() for a in batch.flat_arrays()]
    return fields, arrays, batch.num_rows
