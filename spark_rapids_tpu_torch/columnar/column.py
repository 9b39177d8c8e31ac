"""Device columns over torch tensors: the port of spark_rapids_tpu/columnar/column.py.

The layout is the JAX package's, array for array, so every kernel can be
compared with its reference:

* a column's capacity is a power of two from :func:`bucket` (minimum 128);
  the batch carries the logical row count;
* NULLs are a bool validity tensor (True = valid); padding rows are invalid
  and their data zeroed;
* strings are ``uint8[cap, W]`` byte matrices, ``W`` from
  :func:`string_width_bucket` (minimum 8), plus ``int32[cap]`` lengths.

Construction goes from numpy (including ``<U``/``S``/object string arrays)
with no pyarrow. Every tensor is allocated with an explicit device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes as dt

MIN_CAPACITY = 128
MIN_STRING_WIDTH = 8

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(npdt) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(npdt)]


def storage_dtype(t: dt.DType) -> torch.dtype:
    """Torch storage dtype of a column of SQL type ``t`` (uint8 for strings)."""
    return torch.uint8 if t == dt.STRING else torch_dtype(t.numpy_dtype)


def bucket(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def string_width_bucket(max_len: int) -> int:
    return bucket(max_len, MIN_STRING_WIDTH)


@dataclass(frozen=True)
class Scalar:
    """Device-free scalar value paired with its SQL type."""
    value: Any                      # python value; None = null scalar
    dtype: dt.DType

    @property
    def is_null(self) -> bool:
        return self.value is None


def encode_strings(values: np.ndarray, validity: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy strings -> (bytes uint8[n, m], lengths int32[n], valid bool[n]).

    ``<U`` arrays of ASCII text and ``S`` arrays convert without a python
    loop; object arrays (None = NULL) and non-ASCII text encode per element
    as UTF-8. ``m`` is the longest string's byte length."""
    values = np.asarray(values)
    n = len(values)
    mat = None
    if values.dtype.kind == "U" and n:
        chars = values.dtype.itemsize // 4
        codes = np.ascontiguousarray(values).view(np.uint32).reshape(n, chars)
        if int(codes.max(initial=0)) < 128:
            mat = codes.astype(np.uint8)
    elif values.dtype.kind == "S" and n:
        mat = np.ascontiguousarray(values).view(np.uint8).reshape(
            n, values.dtype.itemsize)
    if mat is not None:
        nz = mat != 0
        lens = np.where(nz.any(axis=1),
                        mat.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
        valid = np.ones(n, np.bool_) if validity is None else \
            np.asarray(validity, np.bool_)
        lens = np.where(valid, lens, 0).astype(np.int32)
        mat = np.where(valid[:, None], mat, 0).astype(np.uint8)
        width = int(lens.max(initial=0))
        return np.ascontiguousarray(mat[:, :width]), lens, valid
    encoded = []
    valid = np.ones(n, np.bool_) if validity is None else \
        np.asarray(validity, np.bool_).copy()
    for i, v in enumerate(values.tolist() if n else []):
        if v is None or not valid[i]:
            valid[i] = False
            encoded.append(b"")
        elif isinstance(v, bytes):
            encoded.append(v)
        else:
            encoded.append(str(v).encode("utf-8"))
    width = max((len(b) for b in encoded), default=0)
    mat = np.zeros((n, width), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, b in enumerate(encoded):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return mat, lens, valid


def utf8_lengths(values: np.ndarray) -> np.ndarray:
    """The UTF-8 byte length of each string (None: 0), without building
    the byte matrix :func:`encode_strings` builds."""
    values = np.asarray(values)
    if values.dtype.kind == "U" and len(values):
        codes = np.ascontiguousarray(values).view(np.uint32)
        if int(codes.max(initial=0)) < 128:
            return np.char.str_len(values).astype(np.int64)
    if values.dtype.kind == "S":
        return np.char.str_len(values).astype(np.int64)
    return np.array([0 if v is None else len(
        v if isinstance(v, bytes) else str(v).encode("utf-8"))
        for v in values.tolist()], np.int64)


def _is_string_array(values: np.ndarray) -> bool:
    return values.dtype.kind in ("U", "S", "O")


class Column:
    """A device column: storage tensors sized to a capacity >= the batch's
    row count.

    numeric/bool/date/timestamp: ``data[cap]`` of the type's storage dtype
    string:                      ``data[cap, W] uint8`` + ``lengths[cap] int32``
    Both carry ``validity[cap] bool``.
    """

    __slots__ = ("dtype", "data", "validity", "lengths")

    def __init__(self, dtype: dt.DType, data: torch.Tensor,
                 validity: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        if dtype.var_width:
            if dtype != dt.STRING:
                raise NotImplementedError(
                    f"{dtype} columns are not ported yet")
            if lengths is None or data.dim() != 2:
                raise ValueError("string column needs lengths + 2D data")
        elif data.dim() != 1:
            raise ValueError(
                f"fixed-width column must be 1D, got {data.dim()}D")
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.lengths = lengths

    # -- shape -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def device_size_bytes(self) -> int:
        total = self.data.numel() * self.data.element_size()
        total += self.validity.numel()
        if self.lengths is not None:
            total += self.lengths.numel() * 4
        return int(total)

    def arrays(self) -> List[torch.Tensor]:
        out = [self.data, self.validity]
        if self.lengths is not None:
            out.append(self.lengths)
        return out

    # -- construction ----------------------------------------------------
    @staticmethod
    def host_arrays(values, dtype: Optional[dt.DType] = None,
                    validity: Optional[np.ndarray] = None,
                    capacity: Optional[int] = None,
                    width: Optional[int] = None
                    ) -> Tuple[dt.DType, List[np.ndarray]]:
        """numpy values -> (dtype, padded host arrays [data, validity(,
        lengths)]) in the device layout, with no device work."""
        values = np.asarray(values)
        n = len(values)
        if dtype is None:
            dtype = dt.STRING if _is_string_array(values) else \
                dt.of(values.dtype)
        cap = capacity or bucket(n)
        if dtype == dt.STRING:
            mat, lens, valid = encode_strings(values, validity)
            w = width or string_width_bucket(mat.shape[1])
            if mat.shape[1] > w:
                raise ValueError(
                    f"string of {mat.shape[1]} bytes exceeds width {w}")
            data = np.zeros((cap, w), np.uint8)
            data[:n, :mat.shape[1]] = mat
            lens_full = np.zeros(cap, np.int32)
            lens_full[:n] = lens
            valid_full = np.zeros(cap, np.bool_)
            valid_full[:n] = valid
            return dt.STRING, [data, valid_full, lens_full]
        if dtype.var_width:
            raise NotImplementedError(f"{dtype} columns are not ported yet")
        valid = np.ones(n, np.bool_) if validity is None else \
            np.asarray(validity, np.bool_)
        storage = np.zeros(cap, dtype.numpy_dtype)
        v = values.astype(dtype.numpy_dtype, copy=False)
        storage[:n] = np.where(valid, v, np.zeros((), dtype.numpy_dtype)) \
            if n else v
        valid_full = np.zeros(cap, np.bool_)
        valid_full[:n] = valid
        return dtype, [storage, valid_full]

    @staticmethod
    def from_numpy(values, dtype: Optional[dt.DType] = None,
                   validity: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None, device="cpu",
                   width: Optional[int] = None) -> "Column":
        dtype, arrays = Column.host_arrays(values, dtype, validity, capacity,
                                           width)
        return Column(dtype, *[torch.from_numpy(a).to(device)
                               for a in arrays])

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: dt.DType,
                    capacity: Optional[int] = None, device="cpu",
                    width: Optional[int] = None) -> "Column":
        """Host values (None = NULL) -> a column on ``device``: the upload
        of a host pass's result (the reference's Column.from_pylist for
        strings and fixed-width types)."""
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        if dtype == dt.STRING:
            vals = np.empty(len(values), dtype=object)
            vals[:] = list(values)
            return Column.from_numpy(vals, dt.STRING, valid, capacity,
                                     device, width)
        vals = np.array([v if v is not None else 0 for v in values],
                        dtype=dtype.numpy_dtype)
        return Column.from_numpy(vals, dtype, valid, capacity, device)

    @staticmethod
    def full_null(dtype: dt.DType, capacity: int, device,
                  width: int = MIN_STRING_WIDTH) -> "Column":
        valid = torch.zeros(capacity, dtype=torch.bool, device=device)
        if dtype == dt.STRING:
            return Column(dtype, torch.zeros((capacity, width),
                                             dtype=torch.uint8, device=device),
                          valid, torch.zeros(capacity, dtype=torch.int32,
                                             device=device))
        if dtype == dt.NULLTYPE:
            dtype = dt.BOOL
        return Column(dtype, torch.zeros(capacity, dtype=storage_dtype(dtype),
                                         device=device), valid)

    @staticmethod
    def from_scalar(scalar: Scalar, num_rows, capacity: int,
                    device) -> "Column":
        """Broadcast a scalar over the first ``num_rows`` rows (an int or a
        0-d device tensor)."""
        if scalar.is_null:
            return Column.full_null(scalar.dtype, capacity, device)
        valid = torch.arange(capacity, device=device) < num_rows
        if scalar.dtype == dt.STRING:
            b = scalar.value.encode("utf-8") if isinstance(
                scalar.value, str) else bytes(scalar.value)
            w = string_width_bucket(len(b))
            row = torch.zeros(w, dtype=torch.uint8, device=device)
            if b:
                row[:len(b)] = torch.frombuffer(bytearray(b),
                                                dtype=torch.uint8).to(device)
            data = torch.where(valid[:, None], row.expand(capacity, w),
                               torch.zeros((), dtype=torch.uint8,
                                           device=device))
            lengths = torch.where(valid, len(b), 0).to(torch.int32)
            return Column(dt.STRING, data, valid, lengths)
        st = storage_dtype(scalar.dtype)
        data = torch.full((capacity,), scalar.value, dtype=st, device=device)
        data = torch.where(valid, data, torch.zeros((), dtype=st,
                                                    device=device))
        return Column(scalar.dtype, data, valid)

    # -- host extraction -------------------------------------------------
    def to_pylist(self, num_rows: int) -> List[Any]:
        valid = self.validity[:num_rows].cpu().numpy()
        if self.dtype == dt.STRING:
            mat = self.data[:num_rows].cpu().numpy()
            lens = self.lengths[:num_rows].cpu().numpy()
            return [bytes(mat[i, :lens[i]]).decode("utf-8", errors="replace")
                    if valid[i] else None for i in range(num_rows)]
        data = self.data[:num_rows].cpu().numpy()
        if self.dtype == dt.BOOL:
            return [bool(v) if ok else None for v, ok in zip(data, valid)]
        if self.dtype.is_integral or self.dtype in (dt.DATE, dt.TIMESTAMP):
            return [int(v) if ok else None for v, ok in zip(data, valid)]
        return [float(v) if ok else None for v, ok in zip(data, valid)]

    def __repr__(self):
        extra = f", width={self.data.shape[1]}" if self.dtype.var_width else ""
        return f"Column({self.dtype}, cap={self.capacity}{extra})"


def column_arity(t: dt.DType) -> int:
    """Number of flat storage arrays a column of type ``t`` contributes."""
    return 3 if t.var_width else 2


def build_column(t: dt.DType, arrays: Sequence[Any], i: int = 0):
    """(column, next index): rebuild one column from the flat-array form
    starting at ``arrays[i]`` (inverse of ``Column.arrays()``)."""
    if t.var_width:
        return Column(t, arrays[i], arrays[i + 1], arrays[i + 2]), i + 3
    return Column(t, arrays[i], arrays[i + 1]), i + 2
