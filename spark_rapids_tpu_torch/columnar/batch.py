"""ColumnarBatch over torch tensors: the port of spark_rapids_tpu/columnar/batch.py.

All columns share one power-of-two capacity; rows beyond ``num_rows`` are
zeroed, invalid padding. The row count may stay on the device as a 0-d
tensor until a host consumer reads ``num_rows``.

The scan upload (:meth:`ColumnarBatch.upload`) packs every column's padded
host arrays into one pinned host buffer and moves it with one
``non_blocking`` copy, then carves the device arrays out as views. It
stands in for the JAX package's packed staging upload (batch.py
``_pack_staging`` / ``_upload_packed``). Nested columns ride the same
buffer (the reference uploads them apart): their flat arrays are plain
host arrays like any other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes as dt
from .column import Column, bucket, build_column, torch_dtype


class ColumnarBatch:
    __slots__ = ("schema", "columns", "_num_rows")

    def __init__(self, schema: dt.Schema, columns: List[Column], num_rows):
        if len(schema) != len(columns):
            raise ValueError("schema/column arity mismatch")
        caps = {c.capacity for c in columns}
        if len(caps) > 1:
            raise ValueError(f"mixed capacities in batch: {caps}")
        self.schema = schema
        self.columns = columns
        if isinstance(num_rows, (int, np.integer)):
            self._num_rows = int(num_rows)
        else:
            self._num_rows = num_rows      # 0-d device tensor

    # -- shape -----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        """Host row count; reads a device-resident count once."""
        nr = self._num_rows
        if isinstance(nr, int):
            return nr
        nr = int(nr.item())
        self._num_rows = nr
        return nr

    @property
    def num_rows_raw(self):
        """The count as it is now (int or 0-d tensor): never syncs."""
        return self._num_rows

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket(self.num_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def device_size_bytes(self) -> int:
        return sum(c.device_size_bytes() for c in self.columns)

    def row_mask_raw(self) -> torch.Tensor:
        """row_mask from the count as it is: never syncs."""
        return torch.arange(self.capacity, device=self.device) < \
            self._num_rows

    def column(self, name_or_idx) -> Column:
        if isinstance(name_or_idx, int):
            return self.columns[name_or_idx]
        return self.columns[self.schema.index_of(name_or_idx)]

    # -- flat array form -------------------------------------------------
    def flat_arrays(self) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        for c in self.columns:
            out.extend(c.arrays())
        return out

    @staticmethod
    def from_flat_arrays(schema: dt.Schema, arrays: Sequence[torch.Tensor],
                         num_rows) -> "ColumnarBatch":
        cols: List[Column] = []
        i = 0
        for f in schema:
            c, i = build_column(f.dtype, arrays, i)
            cols.append(c)
        return ColumnarBatch(schema, cols, num_rows)

    # -- construction ----------------------------------------------------
    @staticmethod
    def upload(schema: dt.Schema,
               hosts: Sequence[Tuple[dt.DType, List[np.ndarray]]],
               num_rows: int, device) -> "ColumnarBatch":
        """Padded host arrays -> device batch. On a CUDA device: one pinned
        staging buffer, one non_blocking copy, then typed views of it."""
        device = torch.device(device)
        if device.type != "cuda":
            cols = [build_column(dtype, [
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrs])[0] for dtype, arrs in hosts]
            return ColumnarBatch(schema, cols, num_rows)
        spec = []
        pos = 0
        for _dtype, arrs in hosts:
            for a in arrs:
                spec.append((a, pos))
                pos += (a.nbytes + 15) & ~15       # 16-byte aligned segments
        staging = torch.empty(pos, dtype=torch.uint8, pin_memory=True)
        host_view = staging.numpy()
        for a, off in spec:
            host_view[off:off + a.nbytes] = np.ascontiguousarray(a).view(
                np.uint8).reshape(-1)
        dev = staging.to(device, non_blocking=True)
        cols: List[Column] = []
        k = 0
        for dtype, arrs in hosts:
            tensors = []
            for a in arrs:
                _a, off = spec[k]
                k += 1
                seg = dev[off:off + a.nbytes]
                tensors.append(seg.view(torch_dtype(a.dtype)).view(a.shape))
            cols.append(build_column(dtype, tensors)[0])
        return ColumnarBatch(schema, cols, num_rows)

    @staticmethod
    def from_numpy_dict(data: Dict[str, Any], schema: dt.Schema, device,
                        capacity: Optional[int] = None) -> "ColumnarBatch":
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity or bucket(n)
        hosts = [Column.host_arrays(data[f.name], f.dtype, capacity=cap)
                 for f in schema]
        return ColumnarBatch.upload(schema, hosts, n, device)

    @staticmethod
    def empty(schema: dt.Schema, device, capacity: int = 128
              ) -> "ColumnarBatch":
        cols = [Column.full_null(f.dtype, capacity, device) for f in schema]
        return ColumnarBatch(schema, cols, 0)

    # -- host extraction -------------------------------------------------
    def fetch_to_host(self) -> "ColumnarBatch":
        """Every column on the host in one device -> host copy: the arrays
        of the first bucket(num_rows) rows are packed into one byte tensor
        on the device and copied once."""
        n = self.num_rows
        if not self.columns or self.device.type == "cpu":
            return self
        m = min(bucket(max(n, 1)), self.capacity)
        flat = [a[:m].contiguous() for a in self.flat_arrays()]
        packed = torch.cat([a.view(torch.uint8).reshape(-1) for a in flat])
        host = packed.cpu()
        out = []
        pos = 0
        for a in flat:
            nbytes = a.numel() * a.element_size()
            out.append(host[pos:pos + nbytes].view(a.dtype).view(a.shape))
            pos += nbytes
        return ColumnarBatch.from_flat_arrays(self.schema, out, n)

    def rows(self) -> List[tuple]:
        host = self.fetch_to_host()
        cols = [c.to_pylist(host.num_rows) for c in host.columns]
        return list(zip(*cols)) if cols else [()] * host.num_rows

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows_raw}, "
                f"cap={self.capacity}, schema={self.schema})")


def resolve_counts(batches: Sequence[ColumnarBatch]) -> None:
    """Read every device-resident row count in one device -> host copy."""
    lazy = [b for b in batches if not isinstance(b.num_rows_raw, int)]
    if not lazy:
        return
    vals = torch.stack([b.num_rows_raw.reshape(()).to(torch.int64)
                        for b in lazy]).cpu().tolist()
    for b, v in zip(lazy, vals):
        b._num_rows = int(v)
