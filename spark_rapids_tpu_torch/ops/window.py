"""Window functions: the port of spark_rapids_tpu/ops/window.py (B15).

The expression classes (frames, specs, ranking and offset functions, the
window expression) are the reference's. Over a batch sorted by (partition
keys, order keys), with K3 (ops/kernels.py:segment_bounds) giving each
row's segment and each segment's first row, four hand-written CUDA kernels
compute the functions, each with a plain PyTorch twin:

* K21 :func:`window_rank` (csrc/window_rank.cu): row_number, rank and
  dense_rank; its offset mode :func:`window_offset` gives lead/lag's
  source rows (the gather stays ``gather_column``).
* K22 :func:`segmented_scan` (csrc/segmented_scan.cu): UNBOUNDED
  PRECEDING..CURRENT ROW count(*), count, sum, avg, min and max, and the
  running count of valid values. A true segmented scan: a segment's float
  sum is taken over its own rows (the reference subtracts two prefixes of
  the whole batch).
* K23 :func:`frame_bounds` (csrc/frame_bounds.cu): each row's [lo, hi] of a
  bounded ROWS frame or of a RANGE frame over one ascending key of at most
  32 bits.
* K24 :func:`frame_aggregate` (csrc/frame_aggregate.cu): the aggregates over
  those frames, from K22's running sums and counts (and, for a float sum,
  its running count of NaN and infinities) and a two-level min/max table.

Whole-partition aggregates are K4 plus a gather (:func:`whole_partition_agg`).
MIN and MAX follow Spark's order: NaN is the largest value.

A wrapper runs its twin only for tensors on the CPU. For a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.column import Column, Scalar, storage_dtype
from . import aggregates as A
from . import kernels as K
from .expressions import Expression

UNBOUNDED = None
_LOW63 = (1 << 63) - 1
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
# order key of every NaN (the canonical NaN's bits)
_NAN_KEY = 0x7FF8000000000000
# RANGE frame order keys: at most 32-bit storage (the reference's scope)
RANGE_KEY_TYPES = (dt.INT8, dt.INT16, dt.INT32, dt.DATE)
# ops the running and bounded frames take (first/last: whole partition only)
FRAME_OPS = ("count", "count_star", "sum", "avg", "min", "max")


@dataclass
class WindowFrame:
    """Frame [lower, upper] relative to the current row; None = unbounded.

    ``is_range=False``: ROWS frame, offsets are row positions.
    ``is_range=True``: RANGE frame, offsets are in order-key units over one
    ascending order key of at most 32 bits."""
    lower: Optional[int] = UNBOUNDED    # None = UNBOUNDED PRECEDING
    upper: Optional[int] = 0            # 0 = CURRENT ROW
    is_range: bool = False

    @property
    def is_unbounded_to_current(self) -> bool:
        return self.lower is None and self.upper == 0 and not self.is_range

    @property
    def is_whole_partition(self) -> bool:
        return self.lower is None and self.upper is None


class WindowSpec:
    def __init__(self, partition_by: List[Expression],
                 order_by: Optional[List] = None,
                 frame: Optional[WindowFrame] = None):
        self.partition_by = partition_by
        self.order_by = order_by or []
        self.frame = frame

    def resolve(self, schema: dt.Schema) -> "WindowSpec":
        from ..plan.logical import SortOrder, _resolve_expr
        self.partition_by = [_resolve_expr(e, schema)
                             for e in self.partition_by]
        self.order_by = [SortOrder(_resolve_expr(o.child, schema),
                                   o.ascending, o.nulls_first)
                         for o in self.order_by]
        return self

    def key_expressions(self) -> List[Expression]:
        """The partition and order keys (not children of the window
        expression, so a plan walk over expressions misses them)."""
        return list(self.partition_by) + [o.child for o in self.order_by]


class WindowFunction(Expression):
    """Marker base for ranking/offset window functions."""

    def eval(self, batch):
        raise RuntimeError(f"{type(self).__name__} is planned by "
                           "TpuWindowExec")


class RowNumber(WindowFunction):
    @property
    def dtype(self):
        return dt.INT32

    @property
    def nullable(self):
        return False


class Rank(RowNumber):
    pass


class DenseRank(RowNumber):
    pass


class Lead(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__(child)
        self.offset = offset
        self.default = default

    @property
    def dtype(self):
        return self.children[0].dtype


class Lag(Lead):
    pass


class WindowExpression(Expression):
    """A window function or aggregate evaluated over a WindowSpec."""

    def __init__(self, function: Expression, spec: WindowSpec):
        super().__init__(function)
        self.spec = spec

    @property
    def function(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self):
        return self.function.dtype

    def resolve_refs(self, schema: dt.Schema) -> "WindowExpression":
        from ..plan.logical import _resolve_expr
        self.children = [_resolve_expr(self.function, schema)]
        self.spec.resolve(schema)
        return self

    def eval(self, batch):
        raise RuntimeError("WindowExpression is planned by TpuWindowExec")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _live(n_live, capacity: int, device) -> torch.Tensor:
    return torch.arange(capacity, device=device) < n_live


def _check_ids(device, capacity: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.int32 or \
                t.shape != (capacity,) or not t.is_contiguous():
            raise ValueError(f"window kernel index arrays must be contiguous "
                             f"int32[{capacity}] on {device}")


def _check_values(col: Column, capacity: int, device) -> None:
    if col.dtype == dt.STRING:
        raise TypeError("window frames aggregate fixed-width values only "
                        "(count reads the validity)")
    for t in (col.data, col.validity):
        if t.device != device or t.shape != (capacity,) or \
                not t.is_contiguous():
            raise ValueError(f"window kernel values must be contiguous "
                             f"[{capacity}] on {device}")
    if col.validity.dtype != torch.bool:
        raise TypeError("validity must be torch.bool")


def _seg_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    start = torch.ones_like(seg_ids, dtype=torch.bool)
    start[1:] = seg_ids[1:] != seg_ids[:-1]
    return start


def _seg_first_torch(seg_ids: torch.Tensor) -> torch.Tensor:
    """Each row's segment start row (ids nondecreasing)."""
    idx = torch.arange(seg_ids.shape[0], device=seg_ids.device)
    return torch.cummax(torch.where(_seg_starts(seg_ids), idx, 0), 0).values


def order_keys(data: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is Spark's order of the values: the
    integer itself; a float's bits mapped to -inf < -0.0 < 0.0 < inf < NaN,
    every NaN one key (csrc/window_common.cuh order_key)."""
    if not data.dtype.is_floating_point:
        return data.to(torch.int64)
    b = data.to(torch.float64).view(torch.int64)
    k = torch.where(b >= 0, b, b ^ _LOW63)
    return torch.where(torch.isnan(data), _NAN_KEY, k)


def from_order_keys(keys: torch.Tensor, dtype: dt.DType) -> torch.Tensor:
    st = storage_dtype(dtype)
    if not st.is_floating_point:
        return keys.to(st)
    b = torch.where(keys >= 0, keys, keys ^ _LOW63)
    return b.view(torch.float64).to(st)


def _value_dcode(op: str, col: Optional[Column]) -> Tuple[Optional[torch.Tensor], int]:
    """(data, storage code) a kernel reads: SUM/AVG of a date or timestamp
    is a double sum (ops/aggregates.py _kernel_inputs)."""
    if col is None or op in ("count", "count_star"):
        return None, 0
    data = col.data
    if op in ("sum", "avg") and not data.dtype.is_floating_point and \
            A.result_dtype("sum", col.dtype).is_floating:
        data = data.to(torch.float64)
    if data.dtype == torch.bool:
        raise TypeError(f"window {op} over booleans is not supported")
    return data.contiguous(), A._DCODES[data.dtype]


def _check_op(op: str, col: Optional[Column]) -> None:
    if op not in FRAME_OPS:
        raise NotImplementedError(
            f"window aggregate {op} runs over a whole partition only (the "
            "reference's running and bounded frames take count, sum, avg, "
            "min and max)")
    if op != "count_star" and col is None:
        raise ValueError(f"window {op} needs an input column")


def _out_dtype(op: str, col: Optional[Column]) -> dt.DType:
    return A.result_dtype(op, col.dtype if col is not None else None)


# ---------------------------------------------------------------------------
# K21: ranks and the offset mode
# ---------------------------------------------------------------------------

_RANK_KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2}


def window_rank(kind: str, seg_ids: torch.Tensor, seg_first: torch.Tensor,
                n_live, peer_ids: Optional[torch.Tensor] = None,
                peer_first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[cap] row_number, rank or dense_rank of a sorted batch (0 on dead
    rows). ``seg_ids``/``seg_first``: K3's group ids and group first rows
    over the partition keys; ``peer_ids``/``peer_first`` the same over
    partition + order keys (rank and dense_rank)."""
    device = seg_ids.device
    cap = seg_ids.shape[0]
    if kind != "row_number" and (peer_ids is None or peer_first is None):
        raise ValueError(f"{kind} needs the peer groups")
    if device.type == "cpu":
        return _window_rank_torch(kind, seg_ids, seg_first, n_live,
                                  peer_ids, peer_first)
    if device.type != "cuda":
        raise RuntimeError(f"window_rank: unsupported device {device}")
    peers = () if kind == "row_number" else (peer_ids, peer_first)
    _check_ids(device, cap, seg_ids, seg_first, *peers)
    out = torch.empty(cap, dtype=torch.int32, device=device)
    n_t = K._count_tensor(n_live, device)
    lib = native.library("window_rank")
    rc = lib.window_rank(_RANK_KINDS[kind], seg_ids.data_ptr(),
                         seg_first.data_ptr(),
                         A._ptr(peer_ids if peers else None),
                         A._ptr(peer_first if peers else None),
                         n_t.data_ptr(), cap, out.data_ptr(),
                         native.stream_ptr(device))
    native.check(rc, "window_rank")
    native.bump("window_rank")
    return out


def _window_rank_torch(kind, seg_ids, seg_first, n_live, peer_ids,
                       peer_first) -> torch.Tensor:
    """Plain PyTorch twin of K21's rank modes."""
    cap = seg_ids.shape[0]
    idx = torch.arange(cap, device=seg_ids.device)
    first = seg_first.to(torch.int64)[seg_ids.to(torch.int64)]
    if kind == "row_number":
        r = idx - first + 1
    elif kind == "rank":
        r = peer_first.to(torch.int64)[peer_ids.to(torch.int64)] - first + 1
    else:
        r = peer_ids.to(torch.int64) - peer_ids.to(torch.int64)[first] + 1
    return torch.where(idx < n_live, r, 0).to(torch.int32)


def window_offset(seg_ids: torch.Tensor, n_live, offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src int64[cap], same bool[cap]): row i + ``offset`` clamped into the
    capacity, and whether it is a live row of i's segment (i live)."""
    device = seg_ids.device
    cap = seg_ids.shape[0]
    if device.type == "cpu":
        return _window_offset_torch(seg_ids, n_live, offset)
    if device.type != "cuda":
        raise RuntimeError(f"window_offset: unsupported device {device}")
    _check_ids(device, cap, seg_ids)
    src = torch.empty(cap, dtype=torch.int64, device=device)
    same = torch.empty(cap, dtype=torch.bool, device=device)
    n_t = K._count_tensor(n_live, device)
    lib = native.library("window_rank")
    rc = lib.window_offset(seg_ids.data_ptr(), n_t.data_ptr(), cap,
                           int(offset), src.data_ptr(), same.data_ptr(),
                           native.stream_ptr(device))
    native.check(rc, "window_offset")
    native.bump("window_offset")
    return src, same


def _window_offset_torch(seg_ids, n_live, offset):
    """Plain PyTorch twin of K21's offset mode."""
    cap = seg_ids.shape[0]
    idx = torch.arange(cap, device=seg_ids.device)
    j = idx + int(offset)
    src = j.clamp(0, cap - 1)
    same = (idx < n_live) & (j >= 0) & (j < n_live) & \
        (seg_ids[src] == seg_ids)
    return src, same


def shift_in_segment(col: Column, seg_ids: torch.Tensor, offset: int,
                     default, n_live) -> Column:
    """lead(+offset)/lag(-offset) of a sorted column within segments; a row
    whose source is outside its segment gets ``default`` (NULL for None).
    K21's offset mode, then ``gather_column``."""
    src, same = window_offset(seg_ids, n_live, offset)
    out = K.gather_column(col, src, out_valid=same)
    if default is None:
        return out
    cap = col.capacity
    fill = ~same
    if col.dtype == dt.STRING:
        dcol = Column.from_scalar(Scalar(default, col.dtype), cap, cap,
                                  col.device)
        w = max(out.data.shape[1], dcol.data.shape[1])
        a = torch.nn.functional.pad(out.data, (0, w - out.data.shape[1]))
        b = torch.nn.functional.pad(dcol.data, (0, w - dcol.data.shape[1]))
        return Column(col.dtype, torch.where(fill[:, None], b, a),
                      out.validity | fill,
                      torch.where(fill, dcol.lengths, out.lengths))
    dval = torch.tensor(default, dtype=out.data.dtype, device=col.device)
    return Column(col.dtype, torch.where(fill, dval, out.data),
                  out.validity | fill)


# ---------------------------------------------------------------------------
# K22: segmented scan
# ---------------------------------------------------------------------------

def segmented_scan(op: str, col: Optional[Column], seg_ids: torch.Tensor,
                   n_live) -> Tuple[Column, torch.Tensor]:
    """(running aggregate, running count int64[cap]) of a batch sorted by
    segment: row i aggregates the contributing rows of its segment up to
    and including i (count(*): live rows; the others: live rows whose value
    is valid). Sum, avg, min and max are NULL until the first valid value;
    dead rows are zero and NULL."""
    out, count, _nf = _scan(op, col, seg_ids, n_live, False)
    return out, count


def _scan(op: str, col: Optional[Column], seg_ids: torch.Tensor, n_live,
          nonfinite: bool
          ) -> Tuple[Column, torch.Tensor, Optional[torch.Tensor]]:
    """:func:`segmented_scan`; with ``nonfinite`` (a float sum) the sum
    skips NaN and infinities, and a third result holds their running packed
    count (csrc/segmented_scan.cu: NaN 1 + 2^32, +inf 2^32, -inf 1)."""
    _check_op(op, col)
    device = seg_ids.device
    cap = seg_ids.shape[0]
    if nonfinite and (op != "sum" or not col.data.dtype.is_floating_point):
        raise ValueError("only a float sum counts its NaN and infinities")
    if device.type == "cpu":
        return _segmented_scan_torch(op, col, seg_ids, n_live, nonfinite)
    if device.type != "cuda":
        raise RuntimeError(f"segmented_scan: unsupported device {device}")
    _check_ids(device, cap, seg_ids)
    _check_input(op, col, cap, device)
    data, dcode = _value_dcode(op, col)
    out_t = _out_dtype(op, col)
    out = torch.empty(cap, dtype=storage_dtype(out_t), device=device)
    out_valid = torch.empty(cap, dtype=torch.bool, device=device)
    count = torch.empty(cap, dtype=torch.int64, device=device)
    nf = torch.empty(cap, dtype=torch.int64, device=device) \
        if nonfinite else None
    n_t = K._count_tensor(n_live, device)
    lib = native.library("segmented_scan")
    scratch = torch.empty(int(lib.segmented_scan_scratch_bytes(cap)),
                          dtype=torch.uint8, device=device)
    rc = lib.segmented_scan(A._OPS[op], dcode, A._ptr(data),
                            A._ptr(col.validity if col is not None else None),
                            seg_ids.data_ptr(), n_t.data_ptr(), cap,
                            out.data_ptr(), out_valid.data_ptr(),
                            count.data_ptr(), A._ptr(nf), scratch.data_ptr(),
                            native.stream_ptr(device))
    native.check(rc, "segmented_scan")
    native.bump("segmented_scan")
    return Column(out_t, out, out_valid), count, nf


def _check_input(op: str, col: Optional[Column], cap: int, device) -> None:
    """The value column a K22/K24 launch reads (count: its validity only,
    so strings too)."""
    if col is None:
        return
    if op != "count":
        _check_values(col, cap, device)
        return
    v = col.validity
    if v.device != device or v.dtype != torch.bool or v.shape != (cap,) or \
            not v.is_contiguous():
        raise ValueError(f"validity must be a contiguous bool[{cap}] on "
                         f"{device}")


def _seg_scan_torch(x: torch.Tensor, seg_first: torch.Tensor, combine
                    ) -> torch.Tensor:
    """Inclusive scan of ``x`` restarting at each segment (Hillis-Steele:
    step d adds the partial of row i - d when it is in i's segment)."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    d = 1
    while d < n:
        prev = torch.cat([x[:d], x[:-d]])
        x = torch.where(idx - d >= seg_first, combine(prev, x), x)
        d *= 2
    return x


def _segmented_scan_torch(op, col, seg_ids, n_live, nonfinite=False):
    """Plain PyTorch twin of K22, as :func:`_scan` (sums added in a tree
    order, so float sums agree with the kernel to rounding; everything else
    bit for bit)."""
    cap = seg_ids.shape[0]
    device = seg_ids.device
    live = _live(n_live, cap, device)
    contrib = live if op == "count_star" else live & col.validity
    first = _seg_first_torch(seg_ids)
    count = _seg_scan_torch(contrib.to(torch.int64), first, torch.add)
    count = torch.where(live, count, 0)
    out_t = _out_dtype(op, col)
    st = storage_dtype(out_t)
    if op in ("count", "count_star"):
        return Column(out_t, count, live), count, None
    has = live & (count > 0)
    data, _ = _value_dcode(op, col)
    if op in ("sum", "avg"):
        acc = torch.float64 if data.dtype.is_floating_point else torch.int64
        add, nf = contrib, None
        if nonfinite:
            add = contrib & torch.isfinite(data)
            code = torch.where(torch.isnan(data), (1 << 32) + 1, torch.where(
                data > 0, 1 << 32, 1))
            nf = _seg_scan_torch(torch.where(contrib & ~add, code, 0), first,
                                 torch.add)
            nf = torch.where(live, nf, 0)
        x = torch.where(add, data.to(acc), torch.zeros((), dtype=acc,
                                                       device=device))
        s = _seg_scan_torch(x, first, torch.add)
        if op == "avg":
            s = s.to(torch.float64) / count.clamp(min=1).to(torch.float64)
        return Column(out_t, torch.where(has, s.to(st), 0), has), count, nf
    ident = _I64_MAX if op == "min" else _I64_MIN
    keys = torch.where(contrib, order_keys(data), ident)
    fn = torch.minimum if op == "min" else torch.maximum
    best = _seg_scan_torch(keys, first, fn)
    vals = from_order_keys(best, col.dtype)
    return Column(out_t, torch.where(has, vals, torch.zeros(
        (), dtype=st, device=device)), has), count, None


# ---------------------------------------------------------------------------
# K23: frame bounds
# ---------------------------------------------------------------------------

def frame_bounds(seg_ids: torch.Tensor, first_row: torch.Tensor, n_groups,
                 n_live, lower: Optional[int], upper: Optional[int],
                 key: Optional[Column] = None, nulls_first: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32[cap]: each live row's frame rows; hi < lo is an
    empty frame, dead rows get (0, -1). A ROWS frame without ``key``; a
    RANGE frame over the sorted ascending ``key`` (at most 32 bits) with
    it. ``seg_ids``, ``first_row`` and ``n_groups`` are K3's over the
    partition keys."""
    device = seg_ids.device
    cap = seg_ids.shape[0]
    if key is not None and key.dtype not in RANGE_KEY_TYPES:
        raise TypeError(f"RANGE frame key {key.dtype}: needs at most 32-bit "
                        "integral or date storage")
    if device.type == "cpu":
        return _frame_bounds_torch(seg_ids, first_row, n_groups, n_live,
                                   lower, upper, key, nulls_first)
    if device.type != "cuda":
        raise RuntimeError(f"frame_bounds: unsupported device {device}")
    _check_ids(device, cap, seg_ids, first_row)
    if key is not None:
        _check_values(key, cap, device)
    lo = torch.empty(cap, dtype=torch.int32, device=device)
    hi = torch.empty(cap, dtype=torch.int32, device=device)
    n_t = K._count_tensor(n_live, device)
    g_t = K._count_tensor(n_groups, device)
    lib = native.library("frame_bounds")
    rc = lib.frame_bounds(
        int(key is not None), seg_ids.data_ptr(), first_row.data_ptr(),
        g_t.data_ptr(), n_t.data_ptr(), cap, int(lower is not None),
        int(lower or 0), int(upper is not None), int(upper or 0),
        A._ptr(key.data if key is not None else None),
        key.dtype.byte_width if key is not None else 0,
        A._ptr(key.validity if key is not None else None),
        int(bool(nulls_first)), lo.data_ptr(), hi.data_ptr(),
        native.stream_ptr(device))
    native.check(rc, "frame_bounds")
    native.bump("frame_bounds")
    return lo, hi


def _frame_bounds_torch(seg_ids, first_row, n_groups, n_live, lower, upper,
                        key, nulls_first):
    """Plain PyTorch twin of K23: the ROWS clamp, and for RANGE the
    reference's composite (segment, validity, key) searchsorted."""
    cap = seg_ids.shape[0]
    device = seg_ids.device
    idx = torch.arange(cap, device=device)
    live = idx < n_live
    g = seg_ids.to(torch.int64)
    fr = first_row.to(torch.int64)
    s = fr[g]
    nxt = fr[(g + 1).clamp(max=cap - 1)]
    ng = n_groups if isinstance(n_groups, int) else int(n_groups)
    nl = n_live if isinstance(n_live, int) else int(n_live)
    e = torch.where(g + 1 < ng, nxt, nl) - 1
    if key is None:
        lo = s if lower is None else torch.minimum(
            torch.maximum(idx + int(lower), s), e + 1)
        hi = e if upper is None else torch.maximum(
            torch.minimum(idx + int(upper), e), s - 1)
    else:
        v = key.validity if nulls_first else ~key.validity
        vbit = v.to(torch.int64) << 32
        k = key.data.to(torch.int64)
        base = (g << 33) | vbit
        null = ~key.validity
        comp = torch.where(live, base | torch.where(null, 0, k + (1 << 31)),
                           _I64_MAX)

        def enc(x):
            return x.clamp(-(1 << 31), (1 << 31) - 1) + (1 << 31)
        lo_key = base | (0 if lower is None else enc(k + int(lower)))
        hi_key = base | ((1 << 32) - 1 if upper is None
                         else enc(k + int(upper)))
        lo_key = torch.where(null, base, lo_key)
        hi_key = torch.where(null, base | ((1 << 32) - 1), hi_key)
        lo = torch.searchsorted(comp, lo_key)
        hi = torch.searchsorted(comp, hi_key, right=True) - 1
    lo = torch.where(live, lo, 0).to(torch.int32)
    hi = torch.where(live, hi, -1).to(torch.int32)
    return lo, hi


# ---------------------------------------------------------------------------
# K24: frame aggregates
# ---------------------------------------------------------------------------

def frame_table_levels(capacity: int, block_rows: int = 32) -> Tuple[int, int]:
    """(blocks, levels) of K24's min/max table over ``capacity`` rows."""
    nb = -(-capacity // block_rows)
    return nb, nb.bit_length()


def frame_aggregate(op: str, col: Optional[Column], seg_ids: torch.Tensor,
                    n_live, lo: torch.Tensor, hi: torch.Tensor,
                    prefix: Optional[Column] = None,
                    pcount: Optional[torch.Tensor] = None,
                    nonfinite: Optional[torch.Tensor] = None) -> Column:
    """``op`` over each row's [lo, hi] frame (K23). ``prefix`` (sum, avg),
    ``pcount`` (every op but count(*)) and ``nonfinite`` (a float sum or
    avg) are K22's running sum, count and packed count of NaN and
    infinities of the same column (:func:`frame_prefix`)."""
    _check_op(op, col)
    device = seg_ids.device
    cap = seg_ids.shape[0]
    if op != "count_star" and pcount is None:
        raise ValueError(f"frame {op} needs the running count")
    if op in ("sum", "avg") and prefix is None:
        raise ValueError(f"frame {op} needs the running sum")
    if op in ("sum", "avg") and col.data.dtype.is_floating_point and \
            nonfinite is None:
        raise ValueError(f"frame {op} needs the running non-finite count")
    if device.type == "cpu":
        return _frame_aggregate_torch(op, col, seg_ids, n_live, lo, hi,
                                      prefix, pcount, nonfinite)
    if device.type != "cuda":
        raise RuntimeError(f"frame_aggregate: unsupported device {device}")
    _check_ids(device, cap, seg_ids, lo, hi)
    _check_input(op, col, cap, device)
    data, dcode = _value_dcode(op, col)
    out_t = _out_dtype(op, col)
    out = torch.empty(cap, dtype=storage_dtype(out_t), device=device)
    out_valid = torch.empty(cap, dtype=torch.bool, device=device)
    lib = native.library("frame_aggregate")
    table, levels = None, 0
    if op in ("min", "max"):
        nb, levels = frame_table_levels(cap,
                                        lib.frame_aggregate_block_rows())
        table = torch.empty(levels * nb, dtype=torch.int64, device=device)
    n_t = K._count_tensor(n_live, device)
    rc = lib.frame_aggregate(
        A._OPS[op], dcode, A._ptr(data),
        A._ptr(col.validity if col is not None else None),
        seg_ids.data_ptr(), n_t.data_ptr(), cap, lo.data_ptr(),
        hi.data_ptr(), A._ptr(prefix.data if prefix is not None else None),
        A._ptr(pcount), A._ptr(nonfinite), A._ptr(table), levels,
        out.data_ptr(),
        out_valid.data_ptr(), native.stream_ptr(device))
    native.check(rc, "frame_aggregate")
    native.bump("frame_aggregate")
    return Column(out_t, out, out_valid)


def frame_prefix(op: str, col: Optional[Column], seg_ids: torch.Tensor,
                 n_live) -> Tuple[Optional[Column], Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """K22's running sum (sum, avg; a float sum of the finite values only),
    count (all but count(*)) and packed count of NaN and infinities (a
    float sum or avg) that :func:`frame_aggregate` takes for ``op``."""
    if op == "count_star":
        return None, None, None
    if op not in ("sum", "avg"):
        return None, segmented_scan("count", col, seg_ids, n_live)[1], None
    return _scan("sum", col, seg_ids, n_live,
                 col.data.dtype.is_floating_point)


def _frame_reduce_torch(vals: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, nonempty: torch.Tensor, fn,
                        ident: int) -> torch.Tensor:
    """``fn`` (min or max) of ``vals`` over each nonempty
    [lo, hi]: a doubling table over the rows, as the reference builds it,
    with only the levels this batch's widest frame needs."""
    cap = vals.shape[0]
    width = torch.where(nonempty, hi - lo + 1, 1)
    wmax = int(width.max()) if cap else 1
    levels = [vals]
    span = 1
    while span * 2 <= wmax:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], torch.full(
            (span,), ident, dtype=prev.dtype, device=vals.device)])
        levels.append(fn(prev, shifted))
        span *= 2
    lvl = torch.floor(torch.log2(width.to(torch.float64))).to(torch.int64)
    # float log2 of an exact power of two is exact; guard the others
    lvl = torch.where((1 << (lvl + 1)) <= width, lvl + 1, lvl)
    lvl = torch.where((1 << lvl) > width, lvl - 1, lvl)
    loc = lo.clamp(0, cap - 1)
    right = (hi - (1 << lvl) + 1).clamp(0, cap - 1)
    out = torch.full((cap,), ident, dtype=vals.dtype, device=vals.device)
    for level, t in enumerate(levels):
        out = torch.where(lvl == level, fn(t[loc], t[right]), out)
    return out


def _frame_aggregate_torch(op, col, seg_ids, n_live, lo, hi, prefix, pcount,
                           nonfinite=None):
    """Plain PyTorch twin of K24: prefix differences for every frame (the
    kernel sums a narrow frame directly: float sums agree to rounding),
    min/max from a doubling table over the rows."""
    cap = seg_ids.shape[0]
    device = seg_ids.device
    live = _live(n_live, cap, device)
    lo64, hi64 = lo.to(torch.int64), hi.to(torch.int64)
    width = hi64 - lo64 + 1
    nonempty = live & (width > 0)
    loc = lo64.clamp(0, cap - 1)
    hic = hi64.clamp(0, cap - 1)
    out_t = _out_dtype(op, col)
    st = storage_dtype(out_t)
    zero = torch.zeros((), dtype=st, device=device)
    if op == "count_star":
        return Column(out_t, torch.where(nonempty, width, 0), live)
    same = torch.zeros(cap, dtype=torch.bool, device=device)
    same[1:] = seg_ids[1:] == seg_ids[:-1]
    in_seg = (loc > 0) & same[loc]

    def diff(p: torch.Tensor) -> torch.Tensor:
        before = torch.where(in_seg, p[(loc - 1).clamp(min=0)],
                             torch.zeros((), dtype=p.dtype, device=device))
        return p[hic] - before

    cnt = torch.where(nonempty, diff(pcount), 0)
    if op == "count":
        return Column(out_t, cnt, live)
    has = nonempty & (cnt > 0)
    if op in ("sum", "avg"):
        s = diff(prefix.data)
        if s.dtype.is_floating_point:
            # low half: NaN and -inf values; high half: NaN and +inf
            nf = diff(nonfinite)
            neg, pos = (nf & 0xFFFFFFFF) != 0, (nf >> 32) != 0
            s = torch.where(neg & pos, float("nan"), torch.where(
                pos, float("inf"), torch.where(neg, float("-inf"), s)))
        if op == "avg":
            s = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
        return Column(out_t, torch.where(has, s.to(st), zero), has)
    data, _ = _value_dcode(op, col)
    ident = _I64_MAX if op == "min" else _I64_MIN
    fn = torch.minimum if op == "min" else torch.maximum
    keys = torch.where(live & col.validity, order_keys(data), ident)
    best = _frame_reduce_torch(keys, lo64, hi64, nonempty, fn, ident)
    vals = from_order_keys(best, col.dtype)
    return Column(out_t, torch.where(has, vals, zero), has)


# ---------------------------------------------------------------------------
# Whole partition: K4 + gather
# ---------------------------------------------------------------------------

def whole_partition_agg(op: str, col: Optional[Column], seg_ids: torch.Tensor,
                        live: torch.Tensor, capacity: int,
                        ignore_nulls: bool = True) -> Column:
    """UNBOUNDED..UNBOUNDED: each segment reduced (K4 over the sorted ids,
    strings through their ranks), then broadcast back to its rows."""
    spec = A.AggSpec(op, col, ignore_nulls)
    red = A._sorted_segment_aggregate(spec, seg_ids, live, capacity)
    return K.gather_column(red, seg_ids.to(torch.int64), out_valid=live)
