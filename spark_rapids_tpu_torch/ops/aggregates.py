"""Group-by and reduction aggregates over torch tensors: the port of
spark_rapids_tpu/ops/aggregates.py.

Two hand-written CUDA kernels live here, each with a plain PyTorch twin:

* K1 :func:`masked_reduce` (csrc/masked_reduce.cu, twin
  :func:`_masked_reduce_torch`): the grouping-free reduce of
  :func:`reduce_aggregate`;
* K4 :func:`segment_reduce` (csrc/segment_reduce.cu, twin
  :func:`_segment_reduce_torch`): the per-group reduce over runs of sorted
  segment ids behind :func:`segment_aggregate`, :func:`groupby_aggregate`
  and :func:`segment_aggregate_matmul`.

Group-by is sort based, as in the reference: K2 orders the rows by the keys
(kernels.sort_indices), K3 finds the groups (kernels.segment_bounds), K4
reduces each aggregate column. SQL NULL semantics: aggregates skip NULL
inputs; an all-NULL (or empty) group gives NULL for sum/min/max/avg and 0
for count. String MIN/MAX, FIRST and LAST are not ported yet and raise.
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
    if spec.op not in _OPS:
        raise ValueError(f"unknown aggregate op {spec.op!r}")
    if spec.op == "count_star":
        return
    if spec.column is None:
        raise ValueError(f"{spec.op} needs an input column")
    if spec.column.dtype == dt.STRING and spec.op != "count":
        raise NotImplementedError(
            f"{spec.op} over strings is not ported yet")


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
# The JAX package's entry points
# ---------------------------------------------------------------------------

def segment_aggregate(spec: AggSpec, seg_ids: torch.Tensor, live: torch.Tensor,
                      capacity: int,
                      num_segments: Optional[int] = None) -> Column:
    """Update-phase aggregation to ``num_segments`` slots (default
    ``capacity``) over rows sorted by group (K4)."""
    ns = capacity if num_segments is None else num_segments
    return segment_reduce(spec, seg_ids, live, ns)


def segment_aggregate_matmul(spec: AggSpec, seg_ids: torch.Tensor,
                             live: torch.Tensor, K: int) -> Column:
    """The reference's MXU one-hot form (counts and float sum/avg into K
    slots, counts always valid), computed by K4 on the card."""
    op = spec.op
    if not (op in ("count", "count_star") or
            (op in ("sum", "avg") and spec.column is not None and
             spec.column.dtype.is_floating)):
        raise ValueError(f"matmul path does not support {op}")
    agg = segment_reduce(spec, seg_ids, live, K)
    if op in ("count", "count_star"):
        return Column(agg.dtype, agg.data,
                      torch.ones(K, dtype=torch.bool, device=live.device))
    return agg


def groupby_aggregate(key_cols: Sequence[Column], specs: Sequence[AggSpec],
                      num_rows, capacity: int,
                      live_mask: Optional[torch.Tensor] = None,
                      shrink: bool = False
                      ) -> Tuple[List[Column], List[Column], object]:
    """Sort-based group-by: (group key columns, aggregate columns, group
    count). K2 sorts, K3 finds the groups, K4 reduces each spec. Outputs
    have ``capacity`` slots with groups first and the count stays on the
    device, as in the reference; ``shrink`` reads the count and sizes the
    outputs to ``bucket(n_groups)`` (what the aggregate exec keeps)."""
    device = key_cols[0].device
    n_live = live_mask.sum() if live_mask is not None else num_rows
    order = K.sort_indices([K.SortKey(c) for c in key_cols], num_rows,
                           capacity, live_mask=live_mask)
    sorted_keys = [K.gather_column(c, order) for c in key_cols]
    _starts, seg_ids, n_groups, first_row = K.segment_bounds(
        sorted_keys, n_live, capacity)
    kb = capacity
    if shrink:
        n_groups = int(n_groups.item())
        kb = min(bucket(max(n_groups, 1)), capacity)
    live = torch.arange(capacity, device=device) < n_live
    group_live = torch.arange(kb, device=device) < n_groups
    kidx = first_row[:kb]
    out_keys = [K.gather_column(c, kidx, out_valid=group_live)
                for c in sorted_keys]
    out_aggs: List[Column] = []
    for spec in specs:
        s = spec
        if spec.column is not None:
            s = spec._replace(column=K.gather_column(spec.column, order))
        agg = segment_reduce(s, seg_ids, live, kb)
        out_aggs.append(_mask_to(agg, group_live))
    return out_keys, out_aggs, n_groups


def reduce_aggregate(specs: Sequence[AggSpec], num_rows, capacity: int,
                     live_mask: Optional[torch.Tensor] = None,
                     device=None) -> List[Column]:
    """Grouping-free reduction: one row at slot 0 of 128-slot columns (K1
    per spec). ``live_mask`` replaces the prefix row mask."""
    if live_mask is None:
        if device is None:
            device = next(s.column.device for s in specs
                          if s.column is not None)
        live_mask = torch.arange(capacity, device=device) < num_rows
    return [masked_reduce(spec, live_mask) for spec in specs]
