"""MAP expressions: the port of spark_rapids_tpu/ops/maps.py.

A MAP<K, V> column of primitives is one ``int64[cap, 3W]`` matrix of
interleaved ``[key bits, value bits, value valid]`` lanes plus per-row
entry counts (columnar/column.py): integral, boolean, date and timestamp
values are stored as their int64 value, floats as the float64 bit
pattern. Two hand-written CUDA kernels live here, each with a plain
PyTorch twin that computes the same result:

* K27 :func:`map_lookup` (csrc/map_lookup.cu, twin
  :func:`_map_lookup_torch`): map[key] for a scalar or a column key.
* K28 :func:`map_build` (csrc/map_build.cu, twin :func:`_map_build_torch`):
  create_map over P key/value columns, LAST_WIN deduplication.

A wrapper runs its twin only for tensors on the CPU. For a CUDA tensor it
launches its kernel or raises. ``MapKeys``, ``MapValues`` and
:func:`_halves` are strided views and a ``where``: torch ops, data
movement. None of them is fusable, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, bucket, storage_dtype
from .expressions import Expression, materialize

# type codes of csrc/map_lookup.cu
_TYPE_CODE = {dt.BOOL: 0, dt.INT8: 1, dt.INT16: 2, dt.INT32: 3, dt.DATE: 3,
              dt.INT64: 4, dt.TIMESTAMP: 4, dt.FLOAT32: 5, dt.FLOAT64: 6}


def _from_bits(bits: torch.Tensor, t: dt.DType) -> torch.Tensor:
    """Stored int64 lanes -> values of type ``t`` (the reference's
    _from_bits): float64 bits, narrowed for float32; integers narrowed
    with wraparound; booleans != 0."""
    if t.is_floating:
        f = bits.contiguous().view(torch.float64)
        return f.to(torch.float32) if t == dt.FLOAT32 else f
    return bits.to(storage_dtype(t))


def _halves(col: Column):
    """(keys [cap, W] of the key type, values [cap, W] of the value type,
    value validity [cap, W], W): strided views of the entry lanes."""
    w = col.data.shape[1] // 3
    kt, vt = col.dtype.key, col.dtype.element
    return (_from_bits(col.data[:, 0:3 * w:3], kt),
            _from_bits(col.data[:, 1:3 * w:3], vt),
            col.data[:, 2:3 * w:3] != 0, w)


# ---------------------------------------------------------------------------
# K27: lookup
# ---------------------------------------------------------------------------

def map_lookup(m: Column, key, cmp_float: bool) -> Column:
    """K27: map[key] per row, ``key`` a non-NULL Scalar or a Column; keys
    compare in float64 when ``cmp_float`` (either side floating), else in
    int64. NULL where the map or the key is NULL, the key is absent or its
    value is NULL."""
    device = m.device
    if device.type == "cpu":
        return _map_lookup_torch(m, key, cmp_float)
    if device.type != "cuda":
        raise RuntimeError(f"map_lookup: unsupported device {device}")
    n, w3 = m.data.shape
    kt, vt = m.dtype.key, m.dtype.element
    if m.data.dtype != torch.int64 or not m.data.is_contiguous() or \
            not m.lengths.is_contiguous() or not m.validity.is_contiguous():
        raise ValueError("map_lookup: a contiguous int64 MAP matrix")
    scalar_i, scalar_f = 0, 0.0
    key_ptr = valid_ptr = None
    lookup_type = 0
    if isinstance(key, Scalar):
        if key.is_null:
            raise ValueError("map_lookup: a NULL key gives a NULL column")
        if cmp_float:
            scalar_f = float(key.value)
        else:
            scalar_i = int(key.value)
    else:
        if key.data.shape != (n,) or key.device != device or \
                not key.data.is_contiguous() or \
                not key.validity.is_contiguous():
            raise ValueError("map_lookup: the key column must be [n] on "
                             "the map's device")
        key_ptr, valid_ptr = key.data.data_ptr(), key.validity.data_ptr()
        lookup_type = _TYPE_CODE[key.dtype]
    out = torch.empty(n, dtype=storage_dtype(vt), device=device)
    out_valid = torch.empty(n, dtype=torch.bool, device=device)
    lib = native.library("map_lookup")
    rc = lib.map_lookup(m.data.data_ptr(), m.lengths.data_ptr(),
                        m.validity.data_ptr(), n, w3 // 3, _TYPE_CODE[kt],
                        key_ptr, valid_ptr, lookup_type, scalar_i, scalar_f,
                        int(bool(cmp_float)), _TYPE_CODE[vt],
                        out.data_ptr(), out_valid.data_ptr(),
                        native.stream_ptr(device))
    native.check(rc, "map_lookup")
    native.bump("map_lookup")
    return Column(vt, out, out_valid)


def _map_lookup_torch(m: Column, key, cmp_float: bool) -> Column:
    """Plain PyTorch twin of K27: one compare over the W key lanes and an
    argmax (the reference's own)."""
    keys, vals, vvalid, w = _halves(m)
    cap = m.capacity
    cmp_t = torch.float64 if cmp_float else torch.int64
    ck = keys.to(cmp_t)
    if isinstance(key, Scalar):
        k = torch.full((cap, 1), key.value, dtype=cmp_t, device=m.device)
        kvalid = torch.ones(cap, dtype=torch.bool, device=m.device)
    else:
        k = key.data.to(cmp_t)[:, None]
        kvalid = key.validity
    lane_ok = torch.arange(w, device=m.device)[None, :] < m.lengths[:, None]
    match = (ck == k) & lane_ok
    found = match.any(dim=1)
    idx = match.to(torch.int8).argmax(dim=1)[:, None]
    data = vals.gather(1, idx)[:, 0]
    ok = m.validity & kvalid & found & vvalid.gather(1, idx)[:, 0]
    return Column(m.dtype.element, torch.where(
        ok, data, torch.zeros((), dtype=data.dtype, device=m.device)), ok)


# ---------------------------------------------------------------------------
# K28: build
# ---------------------------------------------------------------------------

def _check_pair_column(c: Column, n: int, device) -> None:
    if c.dtype.is_floating or c.dtype.var_width:
        raise ValueError(f"map_build takes integral or boolean keys and "
                         f"values, not {c.dtype}")
    if c.data.shape != (n,) or c.device != device or \
            not c.data.is_contiguous() or not c.validity.is_contiguous():
        raise ValueError("map_build: key and value columns must be [n] on "
                         "one device")


def map_build(keys: Sequence[Column], values: Sequence[Column],
              live: torch.Tensor, map_type: dt.DType) -> Column:
    """K28: one map a row from P (key, value) columns (integral or
    boolean). A NULL key or a dead row gives a NULL map; a duplicate key
    keeps its first position and its last value."""
    device = live.device
    if device.type == "cpu":
        return _map_build_torch(keys, values, live, map_type)
    if device.type != "cuda":
        raise RuntimeError(f"map_build: unsupported device {device}")
    n = live.shape[0]
    p = len(keys)
    lib = native.library("map_build")
    if p != len(values) or not 1 <= p <= lib.map_build_max_pairs():
        raise ValueError(f"map_build takes 1 to "
                         f"{lib.map_build_max_pairs()} key/value pairs")
    for c in list(keys) + list(values):
        _check_pair_column(c, n, device)
    w = bucket(p, 4)
    mat = torch.empty((n, 3 * w), dtype=torch.int64, device=device)
    lens = torch.empty(n, dtype=torch.int32, device=device)
    valid = torch.empty(n, dtype=torch.bool, device=device)
    rc = lib.map_build(
        native.pointers([c.data.data_ptr() for c in keys]),
        native.pointers([c.validity.data_ptr() for c in keys]),
        native.ints([c.data.element_size() for c in keys]),
        native.pointers([c.data.data_ptr() for c in values]),
        native.pointers([c.validity.data_ptr() for c in values]),
        native.ints([c.data.element_size() for c in values]),
        p, live.contiguous().data_ptr(), n, w, mat.data_ptr(),
        lens.data_ptr(), valid.data_ptr(), native.stream_ptr(device))
    native.check(rc, "map_build")
    native.bump("map_build")
    return Column(map_type, mat, valid, lens)


def _map_build_torch(keys: Sequence[Column], values: Sequence[Column],
                     live: torch.Tensor, map_type: dt.DType) -> Column:
    """Plain PyTorch twin of K28: the reference's [cap, P, P] compare, a
    stable sort of the kept entries to the front."""
    p = len(keys)
    device = live.device
    cap = live.shape[0]
    kmat = torch.stack([k.data.to(torch.int64) for k in keys], dim=1)
    vvalid = torch.stack([v.validity for v in values], dim=1)
    vmat = torch.where(vvalid, torch.stack(
        [v.data.to(torch.int64) for v in values], dim=1), 0)
    same = kmat[:, :, None] == kmat[:, None, :]
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool,
                                    device=device), diagonal=-1)[None]
    keep = ~(same & earlier).any(dim=2)
    last_j = torch.where(same, torch.arange(p, device=device)[None, None, :],
                         -1).max(dim=2).values
    vmat = vmat.gather(1, last_j)
    vvalid = vvalid.gather(1, last_j)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    kc, vc, vvc = kmat.gather(1, order), vmat.gather(1, order), \
        vvalid.gather(1, order)
    n_kept = keep.sum(dim=1).to(torch.int32)
    kept_lane = torch.arange(p, device=device)[None, :] < n_kept[:, None]
    valid = live & torch.stack([k.validity for k in keys], dim=1).all(dim=1)
    w = bucket(p, 4)
    mat = torch.zeros((cap, 3 * w), dtype=torch.int64, device=device)
    mat[:, 0:3 * p:3] = torch.where(kept_lane, kc, 0)
    mat[:, 1:3 * p + 1:3] = torch.where(kept_lane, vc, 0)
    mat[:, 2:3 * p + 2:3] = (vvc & kept_lane).to(torch.int64)
    mat = torch.where(valid[:, None], mat, 0)
    return Column(map_type, mat, valid, torch.where(valid, n_kept, 0))


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...): duplicate keys keep the LAST entry
    (spark.sql.mapKeyDedupPolicy=LAST_WIN); a NULL key gives a NULL map
    where Spark raises (a deliberate difference kept from the
    reference)."""

    fusable = False

    def __init__(self, *kv: Expression):
        if not kv or len(kv) % 2:
            raise ValueError("map() needs key/value pairs")
        super().__init__(*kv)

    @property
    def dtype(self):
        return dt.MAP(self.children[0].dtype, self.children[1].dtype)

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        cols = [materialize(c.eval(batch), batch) for c in self.children]
        return map_build(cols[0::2], cols[1::2], batch.row_mask_raw(),
                         self.dtype)


class GetMapValue(Expression):
    """map[key] / element_at(map, key): NULL where the key is absent."""

    fusable = False

    def __init__(self, child: Expression, key: Expression):
        super().__init__(child, key)

    @property
    def dtype(self):
        return self.children[0].dtype.element

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        kt = self.children[0].dtype.key
        key_t = self.children[1].dtype
        if key_t.var_width or key_t.numpy_dtype is None or \
                kt.numpy_dtype is None:
            raise TypeError(f"map key lookup type {key_t} incompatible with "
                            f"map<{kt},...>")
        m = materialize(self.children[0].eval(batch), batch)
        key = self.children[1].eval(batch)
        if isinstance(key, Scalar) and key.is_null:
            return Column.full_null(self.dtype, m.capacity, m.device)
        return map_lookup(m, key, kt.is_floating or key_t.is_floating)


class GetItem(Expression):
    """col[x] / element_at(col, x): a MAP lookup or an ARRAY index, chosen
    by the resolved type. ``one_based`` is element_at's array indexing;
    maps ignore it."""

    def __init__(self, child: Expression, key: Expression,
                 one_based: bool = False):
        super().__init__(child, key)
        self.one_based = one_based

    @property
    def fusable(self):  # type: ignore[override]
        # the reference's flag: only the map lookup is eager-only
        try:
            return not dt.is_map(self.children[0].dtype)
        except Exception:
            return False

    @property
    def dtype(self):
        return self.children[0].dtype.element

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        from .arrays import GetArrayItem
        child, key = self.children
        if dt.is_map(child.dtype):
            return GetMapValue(child, key).eval(batch)
        return GetArrayItem(child, key,
                            one_based=self.one_based).eval(batch)


def _as_array(m: Column, plane, t: dt.DType, ok_extra=None) -> Column:
    w = plane.shape[1]
    lane_ok = torch.arange(w, device=m.device)[None, :] < m.lengths[:, None]
    ok = lane_ok & m.validity[:, None]
    if ok_extra is not None:
        ok = ok & ok_extra
    data = torch.where(ok, plane, torch.zeros((), dtype=plane.dtype,
                                              device=m.device))
    return Column(dt.ARRAY(t), data.contiguous(), m.validity,
                  torch.where(m.validity, m.lengths, 0), ok)


class MapKeys(Expression):
    """map_keys(m) -> array<K>."""

    fusable = False

    @property
    def dtype(self):
        return dt.ARRAY(self.children[0].dtype.key)

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        m = materialize(self.children[0].eval(batch), batch)
        keys, _vals, _vv, _w = _halves(m)
        return _as_array(m, keys, m.dtype.key)


class MapValues(Expression):
    """map_values(m) -> array<V>; a NULL value is a NULL element."""

    fusable = False

    @property
    def dtype(self):
        return dt.ARRAY(self.children[0].dtype.element)

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        m = materialize(self.children[0].eval(batch), batch)
        _keys, vals, vv, _w = _halves(m)
        return _as_array(m, vals, m.dtype.element, vv)

