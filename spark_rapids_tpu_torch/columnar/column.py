"""Device columns over torch tensors: the port of spark_rapids_tpu/columnar/column.py.

The layout is the JAX package's, array for array, so every kernel can be
compared with its reference:

* a column's capacity is a power of two from :func:`bucket` (minimum 128);
  the batch carries the logical row count;
* NULLs are a bool validity tensor (True = valid); padding rows are invalid
  and their data zeroed;
* strings are ``uint8[cap, W]`` byte matrices, ``W`` from
  :func:`string_width_bucket` (minimum 8), plus ``int32[cap]`` lengths;
* ARRAY<primitive> is an element matrix ``data[cap, W]`` of the element's
  dtype, ``int32[cap]`` lengths and an element validity ``bool[cap, W]``;
  MAP<K, V> of primitives is one ``int64[cap, 3W]`` matrix of interleaved
  ``[key bits, value bits, value valid]`` lanes plus the entry counts;
  STRUCT is a :class:`StructColumn`: a validity and one column a field.
  A nested type with no device layout (a string key or element) raises
  NotImplementedError: it needs the host engine (ROADMAP A6).

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


def _bits_from_values(vals, dtype: dt.DType) -> np.ndarray:
    """Logical values -> int64 bit patterns for the MAP layout: integral,
    bool, date and timestamp store the int64 value; floats store the
    float64 bit pattern (f32 widens exactly)."""
    if dtype.is_floating:
        return np.asarray(vals, np.float64).view(np.int64)
    return np.asarray([int(v) for v in vals], np.int64)


def _values_from_bits(bits: np.ndarray, dtype: dt.DType) -> np.ndarray:
    if dtype.is_floating:
        return bits.view(np.float64).astype(dtype.numpy_dtype)
    return bits.astype(dtype.numpy_dtype)


def device_capable(t: dt.DType) -> bool:
    """Types with a device layout: primitives and strings, ARRAY and MAP
    of primitives, STRUCT of such fields (the reference's type gate)."""
    if dt.is_struct(t):
        return all(device_capable(ft) for _, ft in t.fields)
    if dt.is_array(t) or dt.is_map(t):
        return t.numpy_dtype is not None
    return True


def check_device_capable(t: dt.DType) -> None:
    if not device_capable(t):
        raise NotImplementedError(
            f"{t} has no device layout: its values need the host engine "
            "(ROADMAP A6), which the PyTorch engine does not have yet")


def is_nested(t: dt.DType) -> bool:
    return dt.is_array(t) or dt.is_map(t) or dt.is_struct(t)


class HostNested:
    """A nested (or pre-encoded string) column's rows on the host in the
    device layout: the flat arrays :meth:`Column.arrays` holds, ``n`` rows
    each and no padding. A scan slices rows and pads them to a batch's
    capacity without converting python values again."""

    def __init__(self, dtype: dt.DType, arrays: Sequence[np.ndarray]):
        self.dtype = dtype
        self.arrays = list(arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, rows: slice) -> "HostNested":
        return HostNested(self.dtype, [a[rows] for a in self.arrays])

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: dt.DType,
                    width: Optional[int] = None) -> "HostNested":
        """Python values (lists for ARRAY, dicts or (key, value) pairs for
        MAP, dicts for STRUCT; None = NULL) in the device layout."""
        check_device_capable(dtype)
        values = list(values)
        n = len(values)
        valid = np.array([v is not None for v in values], np.bool_)
        if dt.is_struct(dtype):
            arrays = [valid]
            for fname, ftype in dtype.fields:
                fvals = [None if v is None else
                         (v.get(fname) if isinstance(v, dict)
                          else getattr(v, fname)) for v in values]
                arrays.extend(_host_child(fvals, ftype))
            return HostNested(dtype, arrays)
        if dt.is_map(dtype):
            dicts = [dict(v) if v is not None else None for v in values]
            lens = np.array([len(d) if d is not None else 0 for d in dicts],
                            np.int32)
            w = width or bucket(int(lens.max(initial=0)), 4)
            mat = np.zeros((n, 3 * w), np.int64)
            rows, lanes = _entry_slots(lens)
            ks = [k for d in dicts if d is not None for k in d]
            vs = [x for d in dicts if d is not None for x in d.values()]
            vv = np.array([x is not None for x in vs], np.bool_)
            if ks:
                mat[rows, 3 * lanes] = _bits_from_values(ks, dtype.key)
                mat[rows, 3 * lanes + 1] = np.where(vv, _bits_from_values(
                    [x if x is not None else 0 for x in vs], dtype.element),
                    0)
                mat[rows, 3 * lanes + 2] = vv
            return HostNested(dtype, [mat, valid, lens])
        # ARRAY<primitive>
        lens = np.array([len(v) if v is not None else 0 for v in values],
                        np.int32)
        w = width or bucket(int(lens.max(initial=0)), 4)
        mat = np.zeros((n, w), dtype.numpy_dtype)
        evalid = np.zeros((n, w), np.bool_)
        rows, lanes = _entry_slots(lens)
        flat = [e for v in values if v is not None for e in v]
        ev = np.array([e is not None for e in flat], np.bool_)
        if flat:
            mat[rows, lanes] = np.asarray(
                [e if e is not None else 0 for e in flat], dtype.numpy_dtype)
            evalid[rows, lanes] = ev
        return HostNested(dtype, [mat, valid, lens, evalid])


def _entry_slots(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row, lane) of every entry of rows holding ``lens`` entries."""
    rows = np.repeat(np.arange(len(lens)), lens)
    starts = np.cumsum(lens) - lens
    lanes = np.arange(int(lens.sum())) - np.repeat(starts, lens)
    return rows, lanes


def _host_child(values: List[Any], t: dt.DType) -> List[np.ndarray]:
    """A struct field's unpadded flat arrays from its python values."""
    if is_nested(t):
        return HostNested.from_pylist(values, t).arrays
    valid = np.array([v is not None for v in values], np.bool_)
    if t == dt.STRING:
        vals = np.empty(len(values), dtype=object)
        vals[:] = values
        mat, lens, valid = encode_strings(vals, valid)
        w = string_width_bucket(mat.shape[1])
        return [np.pad(mat, ((0, 0), (0, w - mat.shape[1]))), valid, lens]
    return [np.array([v if v is not None else 0 for v in values],
                     t.numpy_dtype), valid]


def _pad_rows(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


class Column:
    """A device column: storage tensors sized to a capacity >= the batch's
    row count.

    numeric/bool/date/timestamp: ``data[cap]`` of the type's storage dtype
    string:                      ``data[cap, W] uint8`` + ``lengths[cap] int32``
    array:                       ``data[cap, W]`` + ``lengths`` +
                                 ``elem_validity[cap, W] bool``
    map:                         ``data[cap, 3W] int64`` + ``lengths``
    All carry ``validity[cap] bool``.
    """

    __slots__ = ("dtype", "data", "validity", "lengths", "elem_validity")

    def __init__(self, dtype: dt.DType, data: torch.Tensor,
                 validity: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                 elem_validity: Optional[torch.Tensor] = None):
        if dtype.var_width:
            if dt.is_struct(dtype):
                raise TypeError("a STRUCT column is a StructColumn")
            check_device_capable(dtype)
            if lengths is None or data.dim() != 2:
                raise ValueError(f"{dtype} column needs lengths + 2D data")
            if dt.is_array(dtype) and elem_validity is None:
                raise ValueError("an ARRAY column needs its element validity")
        elif data.dim() != 1:
            raise ValueError(
                f"fixed-width column must be 1D, got {data.dim()}D")
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.lengths = lengths
        self.elem_validity = elem_validity

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
        if self.elem_validity is not None:
            total += self.elem_validity.numel()
        return int(total)

    def arrays(self) -> List[torch.Tensor]:
        out = [self.data, self.validity]
        if self.lengths is not None:
            out.append(self.lengths)
        if self.elem_validity is not None:
            out.append(self.elem_validity)
        return out

    # -- construction ----------------------------------------------------
    @staticmethod
    def host_arrays(values, dtype: Optional[dt.DType] = None,
                    validity: Optional[np.ndarray] = None,
                    capacity: Optional[int] = None,
                    width: Optional[int] = None
                    ) -> Tuple[dt.DType, List[np.ndarray]]:
        """numpy values -> (dtype, padded host arrays [data, validity(,
        lengths)]) in the device layout, with no device work. A
        :class:`HostNested` (a nested column, or a string column already
        encoded) is padded to the capacity as it is."""
        if dtype is not None and is_nested(dtype) and \
                not isinstance(values, HostNested):
            values = HostNested.from_pylist(values, dtype, width)
        if isinstance(values, HostNested):
            cap = capacity or bucket(len(values))
            return values.dtype, [_pad_rows(a, cap) for a in values.arrays]
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
        check_device_capable(dtype)
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
        of a host pass's result, or a nested column built from python
        lists and dicts (the reference's Column.from_pylist; a STRUCT
        gives a :class:`StructColumn`)."""
        if is_nested(dtype):
            host = HostNested.from_pylist(values, dtype, width)
            _t, arrays = Column.host_arrays(host, dtype, capacity=capacity)
            return build_column(dtype, [torch.from_numpy(a).to(device)
                                        for a in arrays])[0]
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
        if dt.is_struct(dtype):
            return StructColumn(dtype, [Column.full_null(t, capacity, device)
                                        for _, t in dtype.fields], valid)
        if dtype.var_width:
            check_device_capable(dtype)
            w = 3 * width if dt.is_map(dtype) else width
            return Column(dtype, torch.zeros((capacity, w),
                                             dtype=storage_dtype(dtype),
                                             device=device),
                          valid, torch.zeros(capacity, dtype=torch.int32,
                                             device=device),
                          torch.zeros((capacity, width), dtype=torch.bool,
                                      device=device)
                          if dt.is_array(dtype) else None)
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
        if dt.is_map(self.dtype):
            mat = self.data[:num_rows].cpu().numpy()
            lens = self.lengths[:num_rows].cpu().numpy()
            kt, vt = self.dtype.key, self.dtype.element
            out: List[Any] = []
            for i in range(num_rows):
                if not valid[i]:
                    out.append(None)
                    continue
                ln = int(lens[i])
                ks = _values_from_bits(mat[i, 0:3 * ln:3], kt)
                vs = _values_from_bits(mat[i, 1:3 * ln + 1:3], vt)
                vv = mat[i, 2:3 * ln + 2:3] != 0
                out.append({_py(kt, k): (_py(vt, v) if ok else None)
                            for k, v, ok in zip(ks, vs, vv)})
            return out
        if dt.is_array(self.dtype):
            mat = self.data[:num_rows].cpu().numpy()
            lens = self.lengths[:num_rows].cpu().numpy()
            ev = self.elem_validity[:num_rows].cpu().numpy()
            elem = self.dtype.element
            return [[_py(elem, x) if ev[i, j] else None
                     for j, x in enumerate(mat[i, :lens[i]])]
                    if valid[i] else None for i in range(num_rows)]
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


def _py(t: dt.DType, v):
    """A numpy scalar of type ``t`` as the python value collect returns."""
    if t == dt.BOOL:
        return bool(v)
    if t.is_floating:
        return float(v)
    return int(v)


class StructColumn(Column):
    """Device STRUCT layout: a struct-level validity and one column per
    field (children are NULL where the struct is). Row-reordering kernels
    (gather, concat) recurse into the children; the flat-array form is
    ``[validity, *children's arrays]``, with an arity that is a function of
    the type (:func:`column_arity`)."""

    __slots__ = ("children",)

    def __init__(self, dtype: dt.DType, children: List[Column],
                 validity: torch.Tensor):
        self.dtype = dtype
        self.children = list(children)
        self.validity = validity
        self.data = None
        self.lengths = None
        self.elem_validity = None

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def field(self, name: str) -> Column:
        return self.children[[n for n, _ in self.dtype.fields].index(name)]

    def device_size_bytes(self) -> int:
        return int(self.validity.numel()) + \
            sum(c.device_size_bytes() for c in self.children)

    def arrays(self) -> List[torch.Tensor]:
        out = [self.validity]
        for c in self.children:
            out.extend(c.arrays())
        return out

    def to_pylist(self, num_rows: int) -> List[Any]:
        valid = self.validity[:num_rows].cpu().numpy()
        kids = [c.to_pylist(num_rows) for c in self.children]
        names = [n for n, _ in self.dtype.fields]
        return [dict(zip(names, vals)) if ok else None
                for ok, vals in zip(valid, zip(*kids))]

    def __repr__(self):
        return f"StructColumn({self.dtype}, cap={self.capacity})"


def column_arity(t: dt.DType) -> int:
    """Number of flat storage arrays a column of type ``t`` contributes: a
    function of the type alone."""
    if dt.is_struct(t):
        return 1 + sum(column_arity(ft) for _, ft in t.fields)
    if dt.is_array(t):
        return 4                      # data, validity, lengths, elem valid
    return 3 if t.var_width else 2


def build_column(t: dt.DType, arrays: Sequence[Any], i: int = 0):
    """(column, next index): rebuild one column from the flat-array form
    starting at ``arrays[i]`` (inverse of ``Column.arrays()``)."""
    if dt.is_struct(t):
        validity = arrays[i]
        i += 1
        children = []
        for _, ft in t.fields:
            c, i = build_column(ft, arrays, i)
            children.append(c)
        return StructColumn(t, children, validity), i
    if dt.is_array(t):
        return Column(t, *arrays[i:i + 4]), i + 4
    if t.var_width:
        return Column(t, arrays[i], arrays[i + 1], arrays[i + 2]), i + 3
    return Column(t, arrays[i], arrays[i + 1]), i + 2
