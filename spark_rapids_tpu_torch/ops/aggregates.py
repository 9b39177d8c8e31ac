"""Group-by and reduction aggregates over torch tensors: the port of
spark_rapids_tpu/ops/aggregates.py.

Five hand-written CUDA kernels live here, each with a plain PyTorch twin:

* K1 :func:`masked_reduce` (csrc/masked_reduce.cu, twin
  :func:`_masked_reduce_torch`): the grouping-free reduce of
  :func:`reduce_aggregate`;
* K4 :func:`segment_reduce` (csrc/segment_reduce.cu, twin
  :func:`_segment_reduce_torch`): the per-group reduce over runs of sorted
  segment ids, the sort route's reduce;
* K8 :func:`dense_key_stats` (csrc/dense_stats.cu, twin
  :func:`_dense_key_stats_torch`): the key span, usable count and float
  absmax that decide the dense route;
* K9 :func:`slot_features` (csrc/slot_aggregate.cu, twin
  :func:`_slot_features_torch`): per-slot counts, sums, extremes and row
  picks for at most 4096 slots in any row order, behind
  :func:`groupby_dense`, :func:`segment_aggregate_matmul` and
  :func:`segment_aggregate` with few segments;
* K10 :func:`singleword_rank` (csrc/singleword_rank.cu, twin
  :func:`_singleword_rank_torch`): each row's group in
  :func:`groupby_singleword`.

Group-by has the reference's routes, picked by
:func:`groupby_aggregate_fast`: the dense route (K8, then K9 over the slots
key - min) for one integral key of small span, and the sort route: K2
orders the rows by the keys (kernels.sort_indices), K3 finds the groups
(kernels.segment_bounds), then K4 reduces each aggregate column, or K9
when the groups are few and every aggregate is a count or a float sum.
String MIN/MAX rank the rows with K2 and take the least or greatest rank
per group; string FIRST/LAST take the least or greatest row index. SQL
NULL semantics: aggregates skip NULL inputs; an all-NULL (or empty) group
gives NULL for sum/min/max/avg and 0 for count.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.column import Column, bucket, storage_dtype
from . import kernels as K


class AggSpec(NamedTuple):
    """One aggregation over one input column (None input = COUNT(*))."""
    op: str                      # count/count_star/sum/min/max/avg/first/last
    column: Optional[Column]
    ignore_nulls: bool = True    # for first/last


_OPS = {"count_star": 0, "count": 1, "sum": 2, "avg": 3, "min": 4, "max": 5,
        "first": 6, "last": 7}
_DCODES = {torch.bool: 0, torch.int8: 0, torch.int16: 1, torch.int32: 2,
           torch.int64: 3, torch.float32: 4, torch.float64: 5}
REDUCE_SLOTS = 128                 # MIN_CAPACITY bucket of a reduce result
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _sum_dtype(in_dtype: dt.DType) -> dt.DType:
    """Spark widens SUM: integral -> bigint, floating -> double."""
    if in_dtype.is_integral or in_dtype == dt.BOOL:
        return dt.INT64
    return dt.FLOAT64


def result_dtype(op: str, in_dtype: Optional[dt.DType]) -> dt.DType:
    if op in ("count", "count_star"):
        return dt.INT64
    if op == "sum":
        return _sum_dtype(in_dtype)
    if op == "avg":
        return dt.FLOAT64
    return in_dtype  # min/max/first/last preserve type


def _check_spec(spec: AggSpec) -> None:
    """What K1 and K4 take: fixed-width values (strings only for COUNT,
    which reads the validity)."""
    if spec.op not in _OPS:
        raise ValueError(f"unknown aggregate op {spec.op!r}")
    if spec.op == "count_star":
        return
    if spec.column is None:
        raise ValueError(f"{spec.op} needs an input column")
    if spec.column.dtype == dt.STRING and spec.op != "count":
        raise TypeError(
            f"{spec.op} over strings does not reduce in K1/K4: "
            "segment_aggregate and reduce_aggregate rank the strings first")


def _out_dtype(spec: AggSpec) -> dt.DType:
    return result_dtype(spec.op, spec.column.dtype
                        if spec.column is not None else None)


def _kernel_inputs(spec: AggSpec, live: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(data, validity, storage code) handed to K1/K4. COUNT(*) reads no
    column: the live mask stands in for both arrays."""
    if spec.op == "count_star":
        return live, live, 0
    col = spec.column
    if col.dtype == dt.STRING:        # COUNT reads only the validity
        return col.validity, col.validity, 0
    data = col.data
    if spec.op == "sum" and _out_dtype(spec).is_floating and \
            not data.dtype.is_floating_point:
        data = data.to(torch.float64)  # SUM(date) is a double sum
    return data, col.validity, _DCODES[data.dtype]


def _check_rows(device, n: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device or not t.is_contiguous() or t.shape[0] != n:
            raise ValueError(
                f"aggregate input {tuple(t.shape)} on {t.device} does not "
                f"match {n} contiguous rows on {device}")


def _mask_to(col: Column, mask: torch.Tensor) -> Column:
    validity = col.validity & mask
    zero = torch.zeros((), dtype=col.data.dtype, device=col.device)
    if col.dtype == dt.STRING:
        return Column(col.dtype, torch.where(mask[:, None], col.data, zero),
                      validity, torch.where(mask, col.lengths, 0).to(
                          torch.int32))
    return Column(col.dtype, torch.where(validity, col.data, zero), validity)


def _live_mask(capacity: int, num_rows, live_mask: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """Rows i < num_rows (every row for None) and live_mask[i]."""
    if num_rows is None:
        live = torch.ones(capacity, dtype=torch.bool, device=device)
    else:
        live = torch.arange(capacity, device=device) < num_rows
    return live if live_mask is None else live & live_mask


def _row_bound(num_rows, capacity: int, device):
    """(n, int32[1] count or None) a kernel takes for "rows i < num_rows":
    a host count becomes the loop bound, a device count is read there."""
    if num_rows is None:
        return capacity, None
    if isinstance(num_rows, torch.Tensor):
        return capacity, num_rows.reshape(1).to(device=device,
                                                dtype=torch.int32)
    return max(0, min(int(num_rows), capacity)), None


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _check_mask(mask: Optional[torch.Tensor], capacity: int, device,
                what: str) -> None:
    if mask is not None and (mask.dtype != torch.bool or
                             mask.shape != (capacity,) or
                             mask.device != device or
                             not mask.is_contiguous()):
        raise ValueError(f"{what}: the live mask must be a contiguous "
                         f"bool[{capacity}] on {device}")


# ---------------------------------------------------------------------------
# K1: masked reduce
# ---------------------------------------------------------------------------

def masked_reduce(spec: AggSpec, live: torch.Tensor,
                  out_slots: int = REDUCE_SLOTS) -> Column:
    """reduce_aggregate of one spec: its value at slot 0 of an
    ``out_slots``-slot column (count: always valid; others NULL when no row
    contributes)."""
    _check_spec(spec)
    device = live.device
    if device.type == "cpu":
        return _masked_reduce_torch(spec, live, out_slots)
    if device.type != "cuda":
        raise RuntimeError(f"masked_reduce: unsupported device {device}")
    if live.dtype != torch.bool:
        raise TypeError("live mask must be torch.bool")
    data, valid, dcode = _kernel_inputs(spec, live)
    n = live.shape[0]
    _check_rows(device, n, data, valid, live)
    out_t = _out_dtype(spec)
    out = torch.empty(out_slots, dtype=storage_dtype(out_t), device=device)
    out_valid = torch.empty(out_slots, dtype=torch.bool, device=device)
    lib = native.library("masked_reduce")
    scratch = torch.empty(int(lib.masked_reduce_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    rc = lib.masked_reduce(_OPS[spec.op], dcode, data.data_ptr(),
                           valid.data_ptr(), live.data_ptr(), n,
                           int(spec.ignore_nulls), scratch.data_ptr(),
                           out.data_ptr(), out_valid.data_ptr(), out_slots,
                           native.stream_ptr(device))
    native.check(rc, "masked_reduce")
    native.bump("masked_reduce")
    return Column(out_t, out, out_valid)


def masked_reduce_parts(n: int) -> int:
    """Blocks of K1's launch 1 over ``n`` rows: the partials its fold takes
    (the generated K20 writes as many)."""
    return int(native.library("masked_reduce").masked_reduce_num_parts(n))


def masked_reduce_fold(op: str, dcode: int, in_dtype: Optional[dt.DType],
                       parts: torch.Tensor, nparts: int,
                       data: Optional[torch.Tensor],
                       valid: Optional[torch.Tensor], out_slots: int,
                       device) -> Column:
    """K1's launch 2 alone: ``nparts`` partials (32 bytes each, written by
    the generated K20) into slot 0 of an ``out_slots``-slot column, as
    masked_reduce writes it. ``data``/``valid``: the input column, read by
    FIRST/LAST only."""
    if device.type != "cuda":
        raise RuntimeError(f"masked_reduce_fold: unsupported device {device}")
    if parts.numel() < nparts * 32:
        raise ValueError("masked_reduce_fold: too few partials")
    out_t = result_dtype(op, in_dtype)
    out = torch.empty(out_slots, dtype=storage_dtype(out_t), device=device)
    out_valid = torch.empty(out_slots, dtype=torch.bool, device=device)
    lib = native.library("masked_reduce")
    ptr = parts.data_ptr()
    rc = lib.masked_reduce_fold(
        _OPS[op], dcode, data.data_ptr() if data is not None else ptr,
        valid.data_ptr() if valid is not None else ptr, ptr, nparts,
        out.data_ptr(), out_valid.data_ptr(), out_slots,
        native.stream_ptr(device))
    native.check(rc, "masked_reduce_fold")
    native.bump("masked_reduce_fold")
    return Column(out_t, out, out_valid)


def _one_slot(value: torch.Tensor, valid: torch.Tensor, out_t: dt.DType,
              out_slots: int) -> Column:
    device = value.device
    st = storage_dtype(out_t)
    data = torch.zeros(out_slots, dtype=st, device=device)
    validity = torch.zeros(out_slots, dtype=torch.bool, device=device)
    data[0] = torch.where(valid, value.to(st), torch.zeros((), dtype=st,
                                                           device=device))
    validity[0] = valid
    return Column(out_t, data, validity)


def _masked_reduce_torch(spec: AggSpec, live: torch.Tensor,
                         out_slots: int = REDUCE_SLOTS) -> Column:
    """Plain PyTorch twin of K1 (reduce_aggregate's semantics)."""
    _check_spec(spec)
    device = live.device
    op = spec.op
    out_t = _out_dtype(spec)
    true = torch.ones((), dtype=torch.bool, device=device)
    if op == "count_star":
        return _one_slot(live.sum(), true, out_t, out_slots)
    col = spec.column
    contrib = live & col.validity
    if op == "count":
        return _one_slot(contrib.sum(), true, out_t, out_slots)
    has = contrib.any()
    if op in ("first", "last"):
        pick = contrib if spec.ignore_nulls else live
        idx = torch.arange(live.shape[0], device=device)
        if op == "first":
            win = torch.where(pick, idx, live.shape[0]).min()
        else:
            win = torch.where(pick, idx, -1).max()
        got = pick.any()
        win = win.clamp(0, live.shape[0] - 1)
        return _one_slot(col.data[win], got & col.validity[win], out_t,
                         out_slots)
    if op == "sum":
        st = storage_dtype(out_t)
        d = torch.where(contrib, col.data.to(st), torch.zeros((), dtype=st,
                                                              device=device))
        return _one_slot(d.sum(), has, out_t, out_slots)
    if op == "avg":
        d = torch.where(contrib, col.data.to(torch.float64), 0.0)
        c = contrib.sum().to(torch.float64)
        return _one_slot(d.sum() / torch.clamp(c, min=1.0), has, out_t,
                         out_slots)
    # min / max
    if col.dtype.is_floating:
        d = col.data.to(torch.float64)
        is_nan = torch.isnan(d) & contrib
        non_nan = contrib & ~is_nan
        fill = float("inf") if op == "min" else float("-inf")
        v = torch.where(non_nan, d, fill)
        if op == "min":
            r = torch.where(non_nan.any(), v.min(), float("nan"))
        else:
            r = torch.where(is_nan.any(), float("nan"), v.max())
        return _one_slot(r, has, out_t, out_slots)
    d = col.data.to(torch.int64)
    info = torch.iinfo(torch.int64)
    if op == "min":
        r = torch.where(contrib, d, info.max).min()
    else:
        r = torch.where(contrib, d, info.min).max()
    return _one_slot(r, has, out_t, out_slots)


# ---------------------------------------------------------------------------
# K4: segment reduce
# ---------------------------------------------------------------------------

def segment_reduce(spec: AggSpec, seg_ids: torch.Tensor, live: torch.Tensor,
                   num_segments: int) -> Column:
    """segment_aggregate of one spec over rows sorted by group: slot g
    reduces the live rows with ``seg_ids == g`` (ids nondecreasing over the
    live rows); slots no live row reaches are zeroed and invalid."""
    _check_spec(spec)
    device = live.device
    if device.type == "cpu":
        return _segment_reduce_torch(spec, seg_ids, live, num_segments)
    if device.type != "cuda":
        raise RuntimeError(f"segment_reduce: unsupported device {device}")
    if live.dtype != torch.bool or seg_ids.dtype != torch.int32:
        raise TypeError("segment_reduce needs a bool live mask and int32 ids")
    data, valid, dcode = _kernel_inputs(spec, live)
    n = live.shape[0]
    _check_rows(device, n, data, valid, live, seg_ids)
    out_t = _out_dtype(spec)
    kb = int(num_segments)
    out = torch.empty(kb, dtype=storage_dtype(out_t), device=device)
    out_valid = torch.empty(kb, dtype=torch.bool, device=device)
    lib = native.library("segment_reduce")
    scratch = torch.empty(int(lib.segment_reduce_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    rc = lib.segment_reduce(_OPS[spec.op], dcode, data.data_ptr(),
                            valid.data_ptr(), seg_ids.data_ptr(),
                            live.data_ptr(), n, int(spec.ignore_nulls), kb,
                            out.data_ptr(), out_valid.data_ptr(),
                            scratch.data_ptr(), native.stream_ptr(device))
    native.check(rc, "segment_reduce")
    native.bump("segment_reduce")
    return Column(out_t, out, out_valid)


def _segment_reduce_torch(spec: AggSpec, seg_ids: torch.Tensor,
                          live: torch.Tensor, num_segments: int) -> Column:
    """Plain PyTorch twin of K4: scatter reductions, as segment_aggregate
    computes them (ids outside [0, num_segments) are dropped)."""
    _check_spec(spec)
    device = live.device
    ns = int(num_segments)
    ids = seg_ids.to(torch.int64)
    inr = (ids >= 0) & (ids < ns)

    def seg_sum(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(ns, dtype=vals.dtype, device=device)
        return out.index_add_(0, ids[inr], vals[inr])

    def seg_ext(vals: torch.Tensor, fill, reduce: str) -> torch.Tensor:
        out = torch.full((ns,), fill, dtype=vals.dtype, device=device)
        return out.scatter_reduce_(0, ids[inr], vals[inr], reduce,
                                   include_self=True)

    op = spec.op
    out_t = _out_dtype(spec)
    live_any = seg_sum(live.to(torch.int64)) > 0
    if op == "count_star":
        return Column(out_t, seg_sum(live.to(torch.int64)), live_any)
    col = spec.column
    contrib = live & col.validity
    if op == "count":
        return Column(out_t, seg_sum(contrib.to(torch.int64)), live_any)
    has = seg_sum(contrib.to(torch.int64)) > 0
    st = storage_dtype(out_t)
    zero = torch.zeros((), dtype=st, device=device)
    if op in ("first", "last"):
        pick = contrib if spec.ignore_nulls else live
        cap = live.shape[0]
        idx = torch.arange(cap, device=device)
        if op == "first":
            win = seg_ext(torch.where(pick, idx, cap), cap, "amin")
        else:
            win = seg_ext(torch.where(pick, idx, -1), -1, "amax")
        got = seg_sum(pick.to(torch.int64)) > 0
        win = win.clamp(0, cap - 1)
        return Column(out_t, torch.where(got, col.data[win], zero),
                      got & col.validity[win])
    if op == "sum":
        d = torch.where(contrib, col.data.to(st), zero)
        return Column(out_t, torch.where(has, seg_sum(d), zero), has)
    if op == "avg":
        s = seg_sum(torch.where(contrib, col.data.to(torch.float64), 0.0))
        c = seg_sum(contrib.to(torch.float64))
        return Column(out_t, torch.where(has, s / torch.clamp(c, min=1.0),
                                         0.0), has)
    if col.dtype.is_floating:
        d = col.data.to(torch.float64)
        is_nan = torch.isnan(d) & contrib
        seg_nan = seg_sum(is_nan.to(torch.int64)) > 0
        seg_non_nan = seg_sum((contrib & ~is_nan).to(torch.int64)) > 0
        fill = float("inf") if op == "min" else float("-inf")
        red = seg_ext(torch.where(contrib & ~is_nan, d, fill), fill,
                      "amin" if op == "min" else "amax")
        if op == "min":
            r = torch.where(seg_non_nan, red, float("nan"))
        else:
            r = torch.where(seg_nan, float("nan"), red)
        return Column(out_t, torch.where(has, r, 0.0).to(st), has)
    d = col.data.to(torch.int64)
    info = torch.iinfo(torch.int64)
    if op == "min":
        red = seg_ext(torch.where(contrib, d, info.max), info.max, "amin")
    else:
        red = seg_ext(torch.where(contrib, d, info.min), info.min, "amax")
    return Column(out_t, torch.where(has, red, 0).to(st), has)


# ---------------------------------------------------------------------------
# K8: dense-route statistics
# ---------------------------------------------------------------------------

DENSE_MAX_SLOTS = 4096
MATMUL_MAX_GROUPS = 4096
# The reference's gate for its hi/lo f32 split (|v| * 2^17 rows must stay
# finite in f32). K9 sums natively in f64 and does not need it; the
# dispatch keeps it so both engines pick the same route.
F32_SAFE_ABSMAX = 1e33
_KEY_TYPES = (dt.INT8, dt.INT16, dt.INT32, dt.INT64, dt.BOOL, dt.DATE,
              dt.TIMESTAMP)


def dense_supported_key(col: Column) -> bool:
    return dense_key_type(col.dtype)


def dense_key_type(t: dt.DType) -> bool:
    """Whether a key of type ``t`` can take the dense route."""
    return t in _KEY_TYPES


def _key_dcode(col: Column) -> int:
    if col.dtype not in _KEY_TYPES:
        raise TypeError(f"{col.dtype} is not a dense-route key type")
    return _DCODES[col.data.dtype]


def dense_key_stats(key_col: Column, num_rows,
                    extra_mask: Optional[torch.Tensor] = None,
                    float_cols: Sequence[Column] = ()):
    """(rmin, decision): ``rmin`` a 0-d int64 device tensor, the least
    usable key (0 when none); ``decision`` f64 ``[span, n_usable,
    *absmax_per_float_col]``, one vector for one host read. Usable: live
    (``i < num_rows`` and ``extra_mask``) with a non-NULL key; absmax over
    the live, valid, non-NaN values of each column. K8 on the card."""
    device = key_col.device
    if device.type == "cpu":
        return _dense_key_stats_torch(key_col, num_rows, extra_mask,
                                      float_cols)
    if device.type != "cuda":
        raise RuntimeError(f"dense_key_stats: unsupported device {device}")
    cap = key_col.capacity
    dcode = _key_dcode(key_col)
    _check_rows(device, cap, key_col.data, key_col.validity,
                *[t for c in float_cols for t in (c.data, c.validity)])
    _check_mask(extra_mask, cap, device, "dense_key_stats")
    for c in float_cols:
        if c.data.dtype not in (torch.float32, torch.float64):
            raise TypeError("dense_key_stats: float columns are f32 or f64")
    n, nrows = _row_bound(num_rows, cap, device)
    # a column that several specs read (SUM and AVG of one value) is read
    # once; ``which`` maps each float_cols entry to its distinct column
    distinct = {}
    for c in float_cols:
        distinct.setdefault((c.data.data_ptr(), c.validity.data_ptr()), c)
    slots = list(distinct)
    which = [slots.index((c.data.data_ptr(), c.validity.data_ptr()))
             for c in float_cols]
    cols_d = list(distinct.values())
    lib = native.library("dense_stats")
    per_call = int(lib.dense_stats_max_float_cols())
    groups = [cols_d[i:i + per_call]
              for i in range(0, len(cols_d), per_call)] or [[]]
    rmin = torch.empty(1, dtype=torch.int64, device=device)
    parts = []
    for gi, cols in enumerate(groups):
        dec = torch.empty(2 + len(cols), dtype=torch.float64, device=device)
        scratch = torch.empty(int(lib.dense_stats_scratch_bytes(n, len(cols))),
                              dtype=torch.uint8, device=device)
        rc = lib.dense_stats(
            dcode, key_col.data.data_ptr(), key_col.validity.data_ptr(),
            _ptr(extra_mask), _ptr(nrows), n,
            native.pointers([c.data.data_ptr() for c in cols]),
            native.pointers([c.validity.data_ptr() for c in cols]),
            native.ints([int(c.data.dtype == torch.float64) for c in cols]),
            len(cols), scratch.data_ptr(), rmin.data_ptr(), dec.data_ptr(),
            native.stream_ptr(device))
        native.check(rc, "dense_stats")
        native.bump("dense_stats")
        parts.append(dec if gi == 0 else dec[2:])
    decision = parts[0] if len(parts) == 1 else torch.cat(parts)
    if len(cols_d) != len(float_cols):
        pick = torch.tensor([0, 1] + [2 + w for w in which], device=device)
        decision = decision[pick]
    return rmin.reshape(()), decision


def _dense_key_stats_torch(key_col: Column, num_rows,
                           extra_mask: Optional[torch.Tensor] = None,
                           float_cols: Sequence[Column] = ()):
    """Plain PyTorch twin of K8 (dense_key_stats' own formulas)."""
    device = key_col.device
    live = _live_mask(key_col.capacity, num_rows, extra_mask, device)
    usable = live & key_col.validity
    k = key_col.data.to(torch.int64)
    rmin = torch.where(usable, k, _I64_MAX).min()
    rmax = torch.where(usable, k, _I64_MIN).max()
    nu = usable.sum()
    span = torch.where(nu > 0, rmax.to(torch.float64) -
                       rmin.to(torch.float64), 0.0)
    rmin = torch.where(nu > 0, rmin, 0)
    parts = [span, nu.to(torch.float64)]
    for c in float_cols:
        ok = live & c.validity & ~torch.isnan(c.data)
        a = torch.where(ok, c.data.abs(), 0.0)
        parts.append(a.max().to(torch.float64))
    return rmin, torch.stack(parts)


# ---------------------------------------------------------------------------
# K9: slot aggregate features
# ---------------------------------------------------------------------------

_FEATURE_KINDS = {"occ": 0, "cnt": 1, "isum": 2, "nan": 3, "imin": 4,
                  "imax": 5, "fmin": 6, "fmax": 7, "first": 8, "last": 9,
                  "fsum": 10}
# identity of the min-like and max-like integer features
_FEATURE_IDENTITY = {"imin": _I64_MAX, "fmin": _I64_MAX, "first": _I64_MAX,
                     "imax": _I64_MIN, "fmax": _I64_MIN, "last": _I64_MIN}
_SMEM_WORDS = 232448 // 8      # 8-byte words of shared memory a block can use
_MAX_FEATURES = 16


class SlotFeature(NamedTuple):
    """One per-slot quantity K9 computes (csrc/slot_aggregate.cu names
    them): ``data`` is None for occ, cnt and first/last; ``valid`` None
    means every live row (occ, and first/last that do not skip NULLs)."""
    kind: str
    data: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


class _Features:
    """The features a group of specs needs, each once (the reference's
    feature planning, groupby_dense add_feats)."""

    def __init__(self):
        self.items: List[SlotFeature] = []
        self._index = {}

    def add(self, kind: str, data: Optional[torch.Tensor] = None,
            valid: Optional[torch.Tensor] = None) -> int:
        key = (kind, None if data is None else id(data),
               None if valid is None else id(valid))
        if key not in self._index:
            self._index[key] = len(self.items)
            self.items.append(SlotFeature(kind, data, valid))
        return self._index[key]


def _order_bits(d: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 image of f64 values (-0.0 below +0.0); its
    own inverse."""
    b = d.view(torch.int64)
    return torch.where(b >= 0, b, b ^ _I64_MAX)


def _from_order_bits(e: torch.Tensor) -> torch.Tensor:
    return torch.where(e >= 0, e, e ^ _I64_MAX).view(torch.float64)


def _slot_ids_torch(src, live: torch.Tensor, K_slots: int):
    """(slot per row, rows that count): key mode clips to [0, K) with NULL
    keys and dead rows in the last slot; ids mode drops ids outside it."""
    if src[0] == "key":
        _, key, kvalid, rmin = src
        d = (key.to(torch.int64) - rmin).to(torch.int32)
        seg = torch.where(live & kvalid, d, K_slots - 1)
        seg = torch.where(live, seg, K_slots - 1).clamp(0, K_slots - 1)
        return seg.to(torch.int64), live
    ids = src[1].to(torch.int64)
    return ids, live & (ids >= 0) & (ids < K_slots)


def _slot_features_torch(feats: Sequence[SlotFeature], src,
                         live: torch.Tensor, K_slots: int
                         ) -> List[torch.Tensor]:
    """Plain PyTorch twin of K9: index_add_ and scatter_reduce_ over the
    rows that count (f64 sums in row order)."""
    device = live.device
    seg, keep = _slot_ids_torch(src, live, K_slots)
    idx = seg[keep]
    rows = torch.arange(live.shape[0], device=device)[keep]
    outs = []
    for f in feats:
        v = f.valid[keep] if f.valid is not None else \
            torch.ones_like(idx, dtype=torch.bool)
        if f.kind == "fsum":
            d = torch.where(v, f.data[keep].to(torch.float64), 0.0)
            outs.append(torch.zeros(K_slots, dtype=torch.float64,
                                    device=device).index_add_(0, idx, d))
            continue
        if f.kind in ("occ", "cnt", "isum", "nan"):
            if f.kind == "isum":
                x = torch.where(v, f.data[keep].to(torch.int64), 0)
            elif f.kind == "nan":
                x = (v & torch.isnan(f.data[keep].to(torch.float64))).to(
                    torch.int64)
            else:
                x = v.to(torch.int64)
            outs.append(torch.zeros(K_slots, dtype=torch.int64,
                                    device=device).index_add_(0, idx, x))
            continue
        fill = _FEATURE_IDENTITY[f.kind]
        if f.kind in ("first", "last"):
            x = rows
        elif f.kind in ("fmin", "fmax"):
            d = f.data[keep].to(torch.float64)
            v = v & ~torch.isnan(d)
            x = _order_bits(torch.where(v, d, 0.0))
        else:
            x = f.data[keep].to(torch.int64)
        reduce = "amin" if fill == _I64_MAX else "amax"
        out = torch.full((K_slots,), fill, dtype=torch.int64, device=device)
        outs.append(out.scatter_reduce_(0, idx, torch.where(v, x, fill),
                                        reduce, include_self=True))
    return outs


def _launch_fits(n_features: int, K_slots: int) -> bool:
    """One K9 block holds an 8-byte accumulator per slot and feature
    (csrc/slot_aggregate.cu)."""
    return n_features <= _MAX_FEATURES and \
        n_features * K_slots <= _SMEM_WORDS


def _slot_launches(feats: Sequence[SlotFeature], K_slots: int
                   ) -> List[List[int]]:
    """Feature indices per launch, int features first, packed in order."""
    order = [i for i, f in enumerate(feats) if f.kind != "fsum"] + \
        [i for i, f in enumerate(feats) if f.kind == "fsum"]
    launches: List[List[int]] = []
    cur: List[int] = []
    for i in order:
        if _launch_fits(len(cur) + 1, K_slots):
            cur.append(i)
            continue
        if not cur:
            raise ValueError(f"K9: one feature does not fit {K_slots} slots")
        launches.append(cur)
        cur = [i]
    if cur:
        launches.append(cur)
    return launches


def slot_features(feats: Sequence[SlotFeature], src, K_slots: int,
                  num_rows=None, live_mask: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """Each feature per slot: int64[K_slots] (f64 for fsum). ``src`` is
    ``("key", key_data, key_validity, rmin)`` (slot = key - rmin, NULL keys
    last) or ``("ids", int32 slot ids)``; rows count when ``i < num_rows``
    (all for None) and ``live_mask[i]``. K9 on the card, split over
    launches when the accumulators do not fit one block."""
    device = src[1].device
    cap = src[1].shape[0]
    if device.type == "cpu":
        return _slot_features_torch(
            feats, src, _live_mask(cap, num_rows, live_mask, device),
            K_slots)
    if device.type != "cuda":
        raise RuntimeError(f"slot_features: unsupported device {device}")
    _check_mask(live_mask, cap, device, "slot_features")
    if src[0] == "key":
        _, key, kvalid, rmin = src
        dcode = _DCODES[key.dtype]
        if key.dtype.is_floating_point:
            raise TypeError("slot_features: the key is integral")
        rmin = rmin.reshape(1).to(device=device, dtype=torch.int64)
        _check_rows(device, cap, key, kvalid)
        key_args = (key.data_ptr(), kvalid.data_ptr(), rmin.data_ptr(),
                    dcode, None)
    else:
        ids = src[1]
        if ids.dtype != torch.int32:
            raise TypeError("slot_features: slot ids are int32")
        _check_rows(device, cap, ids)
        key_args = (None, None, None, 0, ids.data_ptr())
    for f in feats:
        _check_rows(device, cap, *[t for t in (f.data, f.valid)
                                   if t is not None])
    n, nrows = _row_bound(num_rows, cap, device)
    lib = native.library("slot_aggregate")
    outs: List[Optional[torch.Tensor]] = [None] * len(feats)
    for launch in _slot_launches(feats, K_slots):
        group = [feats[i] for i in launch]
        n_f = sum(f.kind == "fsum" for f in group)
        n_i = len(group) - n_f
        out_i = torch.empty((max(n_i, 1), K_slots), dtype=torch.int64,
                            device=device)
        out_f = torch.empty((max(n_f, 1), K_slots), dtype=torch.float64,
                            device=device)
        scratch = torch.empty(
            int(lib.slot_aggregate_scratch_bytes(n, n_i, n_f, K_slots)),
            dtype=torch.uint8, device=device)
        rc = lib.slot_aggregate(
            *key_args, _ptr(live_mask), _ptr(nrows), n, K_slots,
            native.pointers([_ptr(f.data) for f in group]),
            native.pointers([_ptr(f.valid) for f in group]),
            native.ints([_FEATURE_KINDS[f.kind] for f in group]),
            native.ints([_DCODES[f.data.dtype] if f.data is not None else 0
                         for f in group]),
            n_i, n_f, scratch.data_ptr(), out_i.data_ptr(),
            out_f.data_ptr(), native.stream_ptr(device))
        native.check(rc, "slot_aggregate")
        native.bump("slot_aggregate")
        ii = ff = 0
        for i, f in zip(launch, group):
            if f.kind == "fsum":
                outs[i] = out_f[ff]
                ff += 1
            else:
                outs[i] = out_i[ii]
                ii += 1
    return outs


def _plan_spec(feats: _Features, spec: AggSpec) -> tuple:
    """The features one spec needs, and how _assemble reads them."""
    op, col = spec.op, spec.column
    if op not in _OPS:
        raise ValueError(f"unknown aggregate op {op!r}")
    if op == "count_star":
        return ("count_star",)
    if col is None:
        raise ValueError(f"{op} needs an input column")
    if op == "count":
        return ("count", feats.add("cnt", valid=col.validity))
    if op in ("first", "last"):
        pick = col.validity if spec.ignore_nulls else None
        return ("pick", feats.add(op, valid=pick))
    if col.dtype == dt.STRING:
        raise TypeError(f"{op} over strings has no slot feature")
    cnt = feats.add("cnt", valid=col.validity)
    if op == "sum" and _sum_dtype(col.dtype) == dt.INT64:
        return ("isum", feats.add("isum", col.data, col.validity), cnt)
    if op in ("sum", "avg"):
        return (op, feats.add("fsum", col.data, col.validity), cnt)
    if col.dtype.is_floating:
        return ("fext", feats.add("f" + op, col.data, col.validity), cnt,
                feats.add("nan", col.data, col.validity))
    return ("iext", feats.add("i" + op, col.data, col.validity), cnt)


def _assemble(spec: AggSpec, plan: tuple, outs: Sequence[torch.Tensor],
              occ: Optional[int], K_slots: int,
              counts_valid: bool) -> Column:
    """One spec's K_slots-slot column from the slot features, with
    segment_aggregate's semantics (``counts_valid``: counts valid in every
    slot, as segment_aggregate_matmul gives them)."""
    kind = plan[0]
    device = outs[0].device
    if kind in ("count_star", "count"):
        data = outs[occ] if kind == "count_star" else outs[plan[1]]
        valid = torch.ones(K_slots, dtype=torch.bool, device=device) \
            if counts_valid else outs[occ] > 0
        return Column(dt.INT64, data, valid)
    col = spec.column
    if kind == "pick":
        idx = outs[plan[1]]
        has = idx != _FEATURE_IDENTITY[spec.op]
        return K.gather_column(col, idx.clamp(0, col.capacity - 1),
                               out_valid=has)
    has = outs[plan[2]] > 0
    if kind == "isum":
        return Column(dt.INT64, torch.where(has, outs[plan[1]], 0), has)
    if kind in ("sum", "avg"):
        s = outs[plan[1]]
        if kind == "avg":
            s = s / torch.clamp(outs[plan[2]].to(torch.float64), min=1.0)
        return Column(dt.FLOAT64, torch.where(has, s, 0.0), has)
    st = storage_dtype(col.dtype)
    if kind == "fext":
        val = _from_order_bits(outs[plan[1]])
        n_nan = outs[plan[3]]
        nan = torch.full((), float("nan"), dtype=torch.float64, device=device)
        if spec.op == "min":      # NaN only when every value is NaN
            r = torch.where(outs[plan[2]] - n_nan > 0, val, nan)
        else:                     # NaN when any value is
            r = torch.where(n_nan > 0, nan, val)
        return Column(col.dtype, torch.where(has, r, 0.0).to(st), has)
    red = outs[plan[1]]
    if col.dtype == dt.BOOL:
        return Column(dt.BOOL, (red > 0) & has, has)
    return Column(col.dtype, torch.where(has, red, 0).to(st), has)


def _slot_aggregate(specs: Sequence[AggSpec], src, K_slots: int,
                    counts_valid: bool, num_rows=None,
                    live_mask: Optional[torch.Tensor] = None,
                    need_occ: bool = True
                    ) -> Tuple[List[Column], Optional[torch.Tensor]]:
    """(one K_slots-slot column per spec, occupancy or None): every spec
    from one K9 call."""
    feats = _Features()
    occ = feats.add("occ") if need_occ or any(
        s.op == "count_star" for s in specs) else None
    plans = [_plan_spec(feats, s) for s in specs]
    outs = slot_features(feats.items, src, K_slots, num_rows, live_mask)
    cols = [_assemble(s, p, outs, occ, K_slots, counts_valid)
            for s, p in zip(specs, plans)]
    return cols, (outs[occ] if occ is not None else None)


# ---------------------------------------------------------------------------
# K10: single-word rank
# ---------------------------------------------------------------------------

def singleword_rank(key_col: Column, uniq: torch.Tensor, num_rows,
                    live_mask: Optional[torch.Tensor], null_slot: int,
                    dead_slot: int) -> torch.Tensor:
    """int32 group id per row: for a live row with a non-NULL key the
    number of ``uniq`` (sorted distinct int64 keys, at most 4096) below
    its key, ``null_slot`` for a live NULL key, ``dead_slot`` for a dead
    row. K10 on the card."""
    device = key_col.device
    if device.type == "cpu":
        return _singleword_rank_torch(key_col, uniq, num_rows, live_mask,
                                      null_slot, dead_slot)
    if device.type != "cuda":
        raise RuntimeError(f"singleword_rank: unsupported device {device}")
    cap = key_col.capacity
    dcode = _key_dcode(key_col)
    _check_rows(device, cap, key_col.data, key_col.validity)
    _check_mask(live_mask, cap, device, "singleword_rank")
    if uniq.dtype != torch.int64 or uniq.device != device or \
            uniq.dim() != 1 or uniq.shape[0] > MATMUL_MAX_GROUPS:
        raise ValueError("singleword_rank: uniq must be int64[<= 4096] on "
                         "the device")
    uniq = uniq.contiguous()
    n, nrows = _row_bound(num_rows, cap, device)
    out = torch.empty(cap, dtype=torch.int32, device=device)
    if n < cap:                           # rows past the bound are dead
        out[n:] = dead_slot
    rc = native.library("singleword_rank").singleword_rank(
        dcode, key_col.data.data_ptr(), key_col.validity.data_ptr(),
        _ptr(live_mask), _ptr(nrows), n, uniq.data_ptr(), uniq.shape[0],
        null_slot, dead_slot, out.data_ptr(), native.stream_ptr(device))
    native.check(rc, "singleword_rank")
    native.bump("singleword_rank")
    return out


def _singleword_rank_torch(key_col: Column, uniq: torch.Tensor, num_rows,
                           live_mask: Optional[torch.Tensor], null_slot: int,
                           dead_slot: int) -> torch.Tensor:
    """Plain PyTorch twin of K10: the reference's compare-reduce, sum over
    g of [uniq_g < key], in chunks of rows."""
    device = key_col.device
    live = _live_mask(key_col.capacity, num_rows, live_mask, device)
    k = key_col.data.to(torch.int64)
    below = torch.cat([(k[i:i + (1 << 16), None] > uniq[None, :]).sum(1)
                       for i in range(0, k.shape[0], 1 << 16)])
    r = torch.where(key_col.validity, below, null_slot)
    return torch.where(live, r, dead_slot).to(torch.int32)


# ---------------------------------------------------------------------------
# The JAX package's entry points
# ---------------------------------------------------------------------------

def segment_aggregate(spec: AggSpec, seg_ids: torch.Tensor, live: torch.Tensor,
                      capacity: int,
                      num_segments: Optional[int] = None) -> Column:
    """Update-phase aggregation to ``num_segments`` slots (default
    ``capacity``): slot g reduces the live rows with ``seg_ids == g``; ids
    outside the slots are dropped. The ids may come in any order: up to
    DENSE_MAX_SLOTS slots K9 takes them as they are; above it the live
    rows are stable-sorted by id first, and K4 reduces the runs."""
    ns = capacity if num_segments is None else num_segments
    col = spec.column
    if col is not None and col.dtype == dt.STRING and \
            spec.op in ("min", "max", "first", "last"):
        return _string_segment_aggregate(spec, seg_ids, live, capacity, ns)
    if ns <= DENSE_MAX_SLOTS:
        return _slot_aggregate([spec], ("ids", seg_ids), ns, False,
                               live_mask=live)[0][0]
    ids = seg_ids.to(torch.int64)
    use = live & (ids >= 0) & (ids < ns)
    # stable: rows of one id keep their order, so FIRST/LAST hold
    order = torch.sort(torch.where(use, ids, ns), stable=True).indices
    if col is not None:
        spec = spec._replace(column=Column(col.dtype, col.data[order],
                                           col.validity[order]))
    return segment_reduce(spec, seg_ids[order], use[order], ns)


def _sorted_segment_aggregate(spec: AggSpec, seg_ids: torch.Tensor,
                              live: torch.Tensor, num_segments: int
                              ) -> Column:
    """The sort route's reduce: ids nondecreasing over the live rows, K4
    (strings through their ranks)."""
    col = spec.column
    if col is not None and col.dtype == dt.STRING and \
            spec.op in ("min", "max", "first", "last"):
        return _string_segment_aggregate(spec, seg_ids, live, col.capacity,
                                         num_segments)
    return segment_reduce(spec, seg_ids, live, num_segments)


def _string_segment_aggregate(spec: AggSpec, seg_ids: torch.Tensor,
                              live: torch.Tensor, capacity: int,
                              num_segments: int) -> Column:
    """String MIN/MAX (the reference's _string_ordinal_minmax) and
    FIRST/LAST: an int32 per row, reduced per group, picks the winning row,
    whose bytes are gathered. MIN/MAX reduce each row's rank in string
    order (K2 sorts every row; ties keep row order); FIRST/LAST reduce the
    row index."""
    col = spec.column
    cap = col.capacity
    device = col.device
    contrib = live & col.validity
    if spec.op in ("min", "max"):
        order = K.sort_indices([K.SortKey(col)], cap, cap)
        rank = torch.empty(cap, dtype=torch.int32, device=device)
        rank.scatter_(0, order, torch.arange(cap, dtype=torch.int32,
                                             device=device))
        agg = segment_aggregate(
            AggSpec(spec.op, Column(dt.INT32, rank, contrib)), seg_ids,
            live, capacity, num_segments)
        win = order[agg.data.to(torch.int64).clamp(0, cap - 1)]
    else:
        pick = contrib if spec.ignore_nulls else live
        rows = Column(dt.INT64, torch.arange(cap, device=device), pick)
        agg = segment_aggregate(
            AggSpec("min" if spec.op == "first" else "max", rows), seg_ids,
            live, capacity, num_segments)
        win = agg.data.clamp(0, cap - 1)
    return K.gather_column(col, win, out_valid=agg.validity)


def _matmul_supported(spec: AggSpec) -> bool:
    if spec.op in ("count", "count_star"):
        return True
    return spec.op in ("sum", "avg") and spec.column is not None and \
        spec.column.dtype.is_floating


def segment_aggregate_matmul(spec: AggSpec, seg_ids: torch.Tensor,
                             live: torch.Tensor, K_slots: int) -> Column:
    """The reference's MXU one-hot reduction to K slots: counts (valid in
    every slot) and float sums and averages, ids in any order (ids outside
    the slots are dropped). K9 on the card, in native f64."""
    if not _matmul_supported(spec):
        raise ValueError(f"matmul path does not support {spec.op}")
    cols, _occ = _slot_aggregate([spec], ("ids", seg_ids), K_slots, True,
                                 live_mask=live, need_occ=False)
    return cols[0]


def dense_op_supported(op: str, t: Optional[dt.DType]) -> bool:
    """Whether the dense route computes ``op`` over a column of type ``t``
    (None for COUNT(*)); the plan asks it before any column exists."""
    if op in ("count", "count_star"):
        return True
    if t is None:
        return False
    if op in ("sum", "avg"):
        return t.is_integral or t == dt.BOOL or t.is_floating
    if op in ("min", "max"):
        return t != dt.STRING
    return op in ("first", "last")


def _dense_spec_supported(spec: AggSpec) -> bool:
    return dense_op_supported(
        spec.op, spec.column.dtype if spec.column is not None else None)


def groupby_dense(key_col: Column, specs: Sequence[AggSpec], num_rows,
                  K_slots: int, rmin,
                  extra_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[List[Column], List[Column], torch.Tensor]:
    """Dense-range group-by: (key columns, aggregate columns, device group
    count) at ``K_slots`` capacity, occupied slots compacted to the front
    in key order with the NULL-key group last. Caller contract: every live
    non-NULL key has ``0 <= key - rmin <= K_slots - 2`` (slot K_slots - 1
    is the NULL group's), and the specs are the dense route's
    (_dense_spec_supported). ``rmin`` may be a device scalar. K9 computes
    every spec in one pass (split over launches only when the accumulators
    do not fit a block); K5 compacts the slots."""
    device = key_col.device
    rmin = torch.as_tensor(rmin, dtype=torch.int64, device=device).reshape(())
    src = ("key", key_col.data, key_col.validity, rmin)
    slot_aggs, occupancy = _slot_aggregate(specs, src, K_slots, False,
                                           num_rows, extra_mask)
    present = occupancy > 0
    slot_ids = torch.arange(K_slots, dtype=torch.int64, device=device)
    key_valid = present & (slot_ids != K_slots - 1)
    key_data_i = rmin + slot_ids
    if key_col.dtype == dt.BOOL:
        key_data = (key_data_i != 0) & key_valid
    else:
        key_data = torch.where(key_valid, key_data_i, 0).to(
            key_col.data.dtype)
    perm, n_groups = K.compaction_indices(present)
    group_live = torch.arange(K_slots, device=device) < n_groups
    out_key = K.gather_column(Column(key_col.dtype, key_data, key_valid),
                              perm, out_valid=group_live)
    out_aggs = [K.gather_column(c, perm, out_valid=group_live)
                for c in slot_aggs]
    return [out_key], out_aggs, n_groups


# -- single-word route --------------------------------------------------------

def _singleword_supported(col: Column) -> bool:
    return col.dtype != dt.STRING and not col.dtype.is_floating


def _encode_single_word(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 order-preserving key, usable mask). The reference encodes into
    uint64 with NULL and padding as the two largest words; torch has no
    uint64 arithmetic, so the port keeps the signed value itself (its order
    is the key's) and tracks NULL and padding by masks, which also keeps
    INT64_MAX and INT64_MAX - 1 apart from them."""
    if not _singleword_supported(col):
        raise TypeError(f"{col.dtype} is not a single-word key")
    return col.data.to(torch.int64), col.validity


def _decode_single_word(enc: torch.Tensor, dtype: dt.DType) -> torch.Tensor:
    if dtype == dt.BOOL:
        return enc != 0
    return enc.to(storage_dtype(dtype))


def groupby_singleword(key_col: Column, specs: Sequence[AggSpec],
                       num_rows, capacity: int,
                       extra_mask: Optional[torch.Tensor] = None
                       ) -> Optional[Tuple[List[Column], List[Column], int]]:
    """Group-by on one fixed-width integral key: sort the key values
    (``torch.sort``), read the distinct count once, rank every row among the
    distinct keys (K10) and reduce with K9. None when the group bucket
    exceeds MATMUL_MAX_GROUPS. NULL keys form one group after the others."""
    device = key_col.device
    live = _live_mask(capacity, num_rows, extra_mask, device)
    enc, usable = _encode_single_word(key_col)
    use = live & usable
    filled = torch.where(use, enc, _I64_MAX)
    srt = torch.sort(filled).values
    # the first n_use sorted values are the usable keys, whatever ties
    # INT64_MAX keys make with the filler
    n_use = use.sum()
    prev = torch.cat([srt[:1] ^ 1, srt[:-1]])
    starts = (srt != prev) & (torch.arange(capacity, device=device) < n_use)
    n_keys, has_null = torch.stack(
        [starts.sum(), (live & ~usable).any().to(torch.int64)]).tolist()
    n_groups = n_keys + has_null
    if n_groups == 0:
        return [], [], 0
    Kb = bucket(n_groups, 128)
    if Kb > MATMUL_MAX_GROUPS:
        return None
    perm, _count = K.compaction_indices(starts)
    uniq = srt[perm[:Kb]]
    seg_ids = singleword_rank(key_col, uniq[:n_keys], num_rows, extra_mask,
                              n_keys, min(n_groups, Kb - 1))
    group_live = torch.arange(Kb, device=device) < n_groups
    key_valid = torch.arange(Kb, device=device) < n_keys
    key_data = _decode_single_word(torch.where(key_valid, uniq, 0),
                                   key_col.dtype)
    if key_col.dtype == dt.BOOL:
        key_data = key_data & key_valid
    out_keys = [Column(key_col.dtype, key_data, key_valid)]
    out_aggs = [_mask_to(segment_aggregate_matmul(s, seg_ids, live, Kb),
                         group_live) for s in specs]
    return out_keys, out_aggs, n_groups


# -- whole group-by entry points -----------------------------------------------

def groupby_aggregate(key_cols: Sequence[Column], specs: Sequence[AggSpec],
                      num_rows, capacity: int,
                      live_mask: Optional[torch.Tensor] = None,
                      shrink: bool = False
                      ) -> Tuple[List[Column], List[Column], object]:
    """Sort-based group-by: (group key columns, aggregate columns, group
    count). K2 sorts, K3 finds the groups, K4 reduces each spec. Outputs
    have ``capacity`` slots with groups first and the count stays on the
    device, as in the reference; ``shrink`` reads the count and sizes the
    outputs to ``bucket(n_groups)``."""
    route = _sort_route(key_cols, num_rows, capacity, live_mask)
    n_groups = route.n_groups
    kb = capacity
    if shrink:
        n_groups = int(n_groups.item())
        kb = min(bucket(max(n_groups, 1)), capacity)
    return _finish_sort(route, specs, n_groups, kb, use_mm=False)


class _SortRoute(NamedTuple):
    order: torch.Tensor          # the stable key order
    sorted_keys: List[Column]
    seg_ids: torch.Tensor        # group id per sorted row
    n_groups: torch.Tensor       # device count
    first_row: torch.Tensor      # sorted row of each group's first row
    live: torch.Tensor           # sorted rows that are live
    capacity: int


def _sort_route(key_cols: Sequence[Column], num_rows, capacity: int,
                live_mask: Optional[torch.Tensor]) -> _SortRoute:
    device = key_cols[0].device
    n_live = live_mask.sum() if live_mask is not None else num_rows
    order = K.sort_indices([K.SortKey(c) for c in key_cols], num_rows,
                           capacity, live_mask=live_mask)
    sorted_keys = [K.gather_column(c, order) for c in key_cols]
    _starts, seg_ids, n_groups, first_row = K.segment_bounds(
        sorted_keys, n_live, capacity)
    live = torch.arange(capacity, device=device) < n_live
    return _SortRoute(order, sorted_keys, seg_ids, n_groups, first_row, live,
                      capacity)


def _finish_sort(route: _SortRoute, specs: Sequence[AggSpec], n_groups,
                 kb: int, use_mm: bool):
    """Keys and aggregates at ``kb`` slots: K9 (use_mm) or K4 per spec."""
    device = route.live.device
    group_live = torch.arange(kb, device=device) < n_groups
    out_keys = [K.gather_column(c, route.first_row[:kb], out_valid=group_live)
                for c in route.sorted_keys]
    out_aggs: List[Column] = []
    for spec in specs:
        s = spec
        if spec.column is not None:
            s = spec._replace(column=K.gather_column(spec.column,
                                                     route.order))
        if use_mm:
            agg = segment_aggregate_matmul(s, route.seg_ids, route.live, kb)
        else:
            agg = _sorted_segment_aggregate(s, route.seg_ids, route.live, kb)
        out_aggs.append(_mask_to(agg, group_live))
    return out_keys, out_aggs, n_groups


class FastToken(NamedTuple):
    """What groupby_fast_dispatch leaves for groupby_fast_finish."""
    route: str                   # "dense" or "sort"
    key_cols: List[Column]
    specs: List[AggSpec]
    num_rows: object
    capacity: int
    allow_matmul: bool
    dense_state: Optional[dict]
    live_mask: Optional[torch.Tensor]
    float_cols: List[Column]
    rmin: Optional[torch.Tensor] = None        # dense
    sort: Optional[_SortRoute] = None          # sort
    f32_safe: Optional[bool] = None            # sort: known before the read


def _float_absmax(float_cols: Sequence[Column], live: torch.Tensor
                  ) -> List[torch.Tensor]:
    return [torch.where(live & c.validity & ~torch.isnan(c.data),
                        c.data.abs(), 0.0).max().to(torch.float64)
            for c in float_cols]


def groupby_fast_dispatch(key_cols: Sequence[Column],
                          specs: Sequence[AggSpec], num_rows, capacity: int,
                          allow_matmul: bool = True,
                          dense_state: Optional[dict] = None,
                          live_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[FastToken, torch.Tensor]:
    """The device half of groupby_aggregate_fast: (token, f64 stats vector
    to read on the host). Dense candidates run K8 (stats ``[span,
    n_usable, absmax...]``); the rest run the sort and group finding (stats
    ``[n_groups, absmax...]``, absmax only when a read must decide the
    f32-safe gate)."""
    float_cols = [s.column for s in specs
                  if s.op in ("sum", "avg") and s.column is not None
                  and s.column.dtype.is_floating]
    tok = FastToken("dense", list(key_cols), list(specs), num_rows, capacity,
                    allow_matmul, dense_state, live_mask, float_cols)
    if (allow_matmul and len(key_cols) == 1
            and (dense_state is None or dense_state.get("enabled", True))
            and dense_supported_key(key_cols[0])
            and all(_dense_spec_supported(s) for s in specs)):
        rmin, decision = dense_key_stats(key_cols[0], num_rows, live_mask,
                                         float_cols)
        return tok._replace(rmin=rmin), decision
    return _sort_dispatch(tok, None)


def _sort_dispatch(tok: FastToken, f32_safe: Optional[bool]
                   ) -> Tuple[FastToken, torch.Tensor]:
    route = _sort_route(tok.key_cols, tok.num_rows, tok.capacity,
                        tok.live_mask)
    parts = [route.n_groups.to(torch.float64)]
    if f32_safe is None and tok.allow_matmul and tok.float_cols:
        # the f32-safe gate rides the group-count read, as in the reference
        live = _live_mask(tok.capacity, tok.num_rows, tok.live_mask,
                          route.live.device)
        parts += _float_absmax(tok.float_cols, live)
    return tok._replace(route="sort", sort=route, f32_safe=f32_safe), \
        torch.stack(parts)


def groupby_fast_finish(tok: FastToken, stats, shrink: bool = False):
    """The host half: (keys, aggregates, group count) from the read
    ``stats``. The dense route returns ``K_slots``-slot outputs and a
    device count; the sort route a host count, at ``capacity`` slots or,
    with ``shrink``, at ``bucket(n_groups)``. A dense candidate whose span
    or values rule the route out falls to the sort route (one more read),
    and a span too wide turns ``dense_state["enabled"]`` off for good."""
    if tok.route == "dense":
        span, absmaxes = float(stats[0]), stats[2:]
        f32_safe = bool(all(a <= F32_SAFE_ABSMAX for a in absmaxes))
        if span + 2 <= DENSE_MAX_SLOTS and f32_safe:
            Kb = bucket(int(span) + 2, 128)
            return groupby_dense(tok.key_cols[0], tok.specs, tok.num_rows,
                                 Kb, tok.rmin, extra_mask=tok.live_mask)
        if span + 2 > DENSE_MAX_SLOTS and tok.dense_state is not None:
            tok.dense_state["enabled"] = False
        tok, dev = _sort_dispatch(tok, f32_safe)
        stats = dev.cpu().numpy()
    n_groups = int(stats[0])
    f32_safe = tok.f32_safe
    if f32_safe is None and len(stats) > 1:
        f32_safe = bool(all(a <= F32_SAFE_ABSMAX for a in stats[1:]))
    Kb = bucket(max(n_groups, 1))
    use_mm = (tok.allow_matmul and Kb <= MATMUL_MAX_GROUPS and
              f32_safe is not False and
              all(_matmul_supported(s) for s in tok.specs))
    kb = Kb if use_mm or shrink else tok.capacity
    return _finish_sort(tok.sort, tok.specs, n_groups,
                        min(kb, tok.capacity), use_mm)


def groupby_aggregate_fast(key_cols: Sequence[Column],
                           specs: Sequence[AggSpec], num_rows,
                           capacity: int, allow_matmul: bool = True,
                           dense_state: Optional[dict] = None,
                           live_mask: Optional[torch.Tensor] = None,
                           shrink: bool = False
                           ) -> Tuple[List[Column], List[Column], int]:
    """Eager group-by with the reference's dispatch: the dense route when
    one integral key spans at most DENSE_MAX_SLOTS - 2 values and the float
    values are f32-safe (one stats read), else the sort route with its
    group-count read, reducing through K9 when the group bucket is at most
    MATMUL_MAX_GROUPS and every spec is a count or a float sum or average,
    through K4 otherwise. ``dense_state`` is the caller's memo: once a span
    rules the dense route out, later calls skip its stats pass. Returns a
    host group count. ``live_mask`` folds a filter in without compacting
    (the reference's fused phase passes it as ``extra_mask``)."""
    tok, stats = groupby_fast_dispatch(key_cols, specs, num_rows, capacity,
                                       allow_matmul, dense_state, live_mask)
    out_keys, out_aggs, n_groups = groupby_fast_finish(
        tok, stats.cpu().numpy(), shrink)
    return out_keys, out_aggs, int(n_groups)


def reduce_aggregate(specs: Sequence[AggSpec], num_rows, capacity: int,
                     live_mask: Optional[torch.Tensor] = None,
                     device=None) -> List[Column]:
    """Grouping-free reduction: one row at slot 0 of 128-slot columns (K1
    per spec; string MIN/MAX/FIRST/LAST as one segment, padded).
    ``live_mask`` replaces the prefix row mask."""
    if live_mask is None:
        if device is None:
            device = next(s.column.device for s in specs
                          if s.column is not None)
        live_mask = torch.arange(capacity, device=device) < num_rows
    out = []
    for spec in specs:
        col = spec.column
        if col is None or col.dtype != dt.STRING or spec.op == "count":
            out.append(masked_reduce(spec, live_mask))
            continue
        seg = torch.zeros(capacity, dtype=torch.int32, device=col.device)
        agg = _string_segment_aggregate(spec, seg, live_mask, capacity, 1)
        pad = REDUCE_SLOTS - 1
        one = torch.arange(REDUCE_SLOTS, device=col.device) < 1
        agg = Column(agg.dtype,
                     torch.nn.functional.pad(agg.data, (0, 0, 0, pad)),
                     torch.nn.functional.pad(agg.validity, (0, pad)),
                     torch.nn.functional.pad(agg.lengths, (0, pad)))
        out.append(_mask_to(agg, one))
    return out
