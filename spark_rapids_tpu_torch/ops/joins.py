"""Sort-merge equi-join and cross-join kernels: the port of
spark_rapids_tpu/ops/joins.py (inner, left outer, left semi and left anti
joins, the unmatched build rows of a full outer join, and the cross
product).

As in the reference, every equality join is sort-merge:

  1. sort the BUILD side by its keys: K2 lanes (kernels.sort_key_lanes)
     plus a stable ``torch.sort`` per lane (kernels.lanes_order);
  2. K6 :func:`join_probe` (csrc/join_probe.cu, twin
     :func:`_join_probe_torch`) searches every STREAM row's lanes in the
     sorted build lanes: the range [lo, lo + count) of equal build rows,
     and the total pair count. Its lower-bound mode (``lower_only``, counter
     ``join_probe_lower``) gives the range partition ids of the exchange
     and the mesh sort;
  3. K7 :func:`_expand_indices` (csrc/join_expand.cu, twin
     :func:`_expand_indices_torch`) turns the ranges into one (stream row,
     build row) pair per output slot; torch indexing gathers the columns.
     Its outer mode gives every live stream row at least one slot, with no
     build row where it has no match (a left join). Semi and anti joins
     compact the stream side through K5 instead.
  4. For a full outer join, K14 :func:`build_matched`
     (csrc/build_matched.cu, twin :func:`_build_matched_torch`) flags the
     build rows some stream row matched, and :func:`unmatched_build_gather`
     compacts the others through K5.

A cross join pairs every left row with every right row: K15
:func:`cross_expand` (csrc/cross_expand.cu, twin
:func:`_cross_expand_torch`) writes each output slot's (left, right) row,
dividing by the right side's row count with the multiplier and shift of
:func:`_fast_divisor`.

Both sides' keys are encoded by K2 with the same descriptors (string pairs
widened to the pair's width first), so lane equality is SQL key equality:
NULL keys never match (the probe masks them), NaN equals NaN and -0.0
equals +0.0. Two-phase sizing, as in the reference: :func:`join_match`
leaves the totals on the device (the pair count, and the live stream rows
without a match, which a left join adds); the caller reads them in one
copy, buckets an output capacity and calls :func:`join_gather`. A wrapper
runs its twin only for tensors on the CPU; for a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.column import Column
from . import kernels as K

_MAX_LANES = 16
_MAX_PROBE_KEYS = 8
_MAX_CAPACITY = 1 << 31     # K6's indices are 32-bit
_SLOTS_32 = 1 << 32         # K15 divides by multiply-high below this


def _widen_string(col: Column, width: int) -> Column:
    """Zero-pad a string column's byte matrix to ``width``
    (order-preserving)."""
    cur = col.data.shape[1]
    if cur >= width:
        return col
    data = torch.nn.functional.pad(col.data, (0, width - cur))
    return Column(col.dtype, data, col.validity, col.lengths)


def pair_widths(build_keys: Sequence[Column],
                stream_keys: Sequence[Column]) -> Tuple[Optional[int], ...]:
    """The byte width each string key pair is widened to (None for other
    key types): both sides must encode to the same lanes."""
    return tuple(max(b.data.shape[1], s.data.shape[1])
                 if b.dtype == dt.STRING and s.dtype == dt.STRING else None
                 for b, s in zip(build_keys, stream_keys))


def widen_keys(keys: Sequence[Column], widths) -> List[Column]:
    """Each string key widened to its pair's width (:func:`pair_widths`)."""
    return [c if w is None else _widen_string(c, w)
            for c, w in zip(keys, widths)]


def _normalize_words(cols: Sequence[Column]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(lanes int64[L, cap], validities): the keys' K2 lanes with every row
    encoded as live, and each key's validity (a row is usable when all of
    them hold). The same encoding the build side is sorted by, so the
    lanes' order is the build's order."""
    cap = cols[0].capacity
    lanes = K.sort_key_lanes([K.SortKey(c) for c in cols], cap, cap)
    return lanes, [c.validity for c in cols]


class BuildSide(NamedTuple):
    order: torch.Tensor    # int64[build_cap] sort permutation of the build
    # int64[L, build_cap] build lanes in sorted order: the transposed view
    # of row-major rows, so K6 reads a row's lanes from one sector
    lanes: torch.Tensor
    n_build: object        # live build rows (int or 0-d tensor)


def sort_build(build_keys: Sequence[Column], n_build) -> BuildSide:
    """Sort the build side by its keys (keys already widened)."""
    cap = build_keys[0].capacity
    lanes = K.sort_key_lanes([K.SortKey(c) for c in build_keys], n_build,
                             cap)
    order = K.lanes_order(lanes)
    rows = lanes.t().index_select(0, order).contiguous()
    return BuildSide(order, rows.t(), n_build)


class JoinMatch(NamedTuple):
    """The reference's fields, and ``totals``. ``build_matched`` (which
    build rows found a match, in sorted order) is None unless asked for:
    only a full outer join needs it."""
    lo: torch.Tensor             # int32[stream_cap] first matching build row
    count: torch.Tensor          # int32[stream_cap] matches per stream row
    build_order: torch.Tensor    # int64[build_cap] build sort permutation
    total_pairs: torch.Tensor    # int64 0-d: sum of count (totals[0])
    build_matched: Optional[torch.Tensor]
    # int64[2]: the pair count and the live stream rows with no match, one
    # device -> host copy for an outer join's output size
    totals: Optional[torch.Tensor] = None


def join_match(build_keys: Sequence[Column], n_build,
               stream_keys: Sequence[Column], n_stream,
               stream_capacity: int,
               build: Optional[BuildSide] = None,
               with_build_matched: bool = False) -> JoinMatch:
    """Phase 1: sort the build side (or take ``build``, sorted once by
    :func:`sort_build` from keys widened by :func:`pair_widths`), then find
    each stream row's match range and count; with ``with_build_matched``
    also flag the matched build rows (K14)."""
    widths = pair_widths(build_keys, stream_keys)
    if build is None:
        build = sort_build(widen_keys(build_keys, widths), n_build)
    s_lanes, s_valid = _normalize_words(widen_keys(stream_keys, widths))
    if s_lanes.shape[1] != stream_capacity:
        raise ValueError("stream keys are not at the stream capacity")
    lo, count, totals = join_probe(build.lanes, build.n_build, s_lanes,
                                   s_valid, n_stream)
    matched = build_matched(lo, count, build.n_build,
                            build.order.shape[0]) \
        if with_build_matched else None
    return JoinMatch(lo, count, build.order, totals[0], matched, totals)


# ---------------------------------------------------------------------------
# K6: join probe
# ---------------------------------------------------------------------------

def join_probe(build_lanes: torch.Tensor, n_build, probe_lanes: torch.Tensor,
               probe_valid: Sequence[torch.Tensor], n_probe,
               lower_only: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
    """(lo int32[pcap], count int32[pcap], totals int64[2]): for each probe
    row the lower bound of its lanes in the first ``n_build`` sorted build
    lanes and the number of equal build rows; the count is 0 for rows at or
    past ``n_probe`` and rows with a NULL key. ``totals`` holds the sum of
    count and the number of live probe rows (< ``n_probe``) whose count is
    0. ``lower_only`` (range partition ids) gives (lo, None, None) and
    skips the upper bound and the totals. A host-int count goes to the
    kernel by value (no copy, no synchronize), a 0-d tensor by pointer."""
    device = probe_lanes.device
    if device.type == "cpu":
        return _join_probe_torch(build_lanes, n_build, probe_lanes,
                                 probe_valid, n_probe, lower_only)
    if device.type != "cuda":
        raise RuntimeError(f"join_probe: unsupported device {device}")
    # the checks read attributes only: at the main path's batch sizes this
    # wrapper's host time is a large part of the call's
    nl, pcap = probe_lanes.shape
    bl, bcap = build_lanes.shape
    if build_lanes.dtype != torch.int64 or \
            probe_lanes.dtype != torch.int64 or \
            build_lanes.device != device or not probe_lanes.is_contiguous():
        raise ValueError("lanes must be int64 on the device, the probe's "
                         "contiguous")
    if bl != nl or nl > _MAX_LANES:
        raise ValueError(f"lane counts {bl} vs {nl} (at most {_MAX_LANES})")
    # the build lane-major ([L, bcap] contiguous) or row-major (its
    # transpose contiguous, as sort_build gives it)
    stride = build_lanes.stride()
    if stride[1] == 1 and (stride[0] == bcap or nl == 1):
        lane_stride, row_stride = bcap, 1
    elif stride == (1, nl):
        lane_stride, row_stride = 1, nl
    else:
        raise ValueError("build lanes must be lane-major or row-major")
    if bcap >= _MAX_CAPACITY or pcap >= _MAX_CAPACITY:
        raise ValueError(f"join_probe takes capacities below 2^31, not "
                         f"{bcap} and {pcap}")
    if probe_valid:
        if len(probe_valid) > _MAX_PROBE_KEYS or any(
                v.dtype != torch.bool or v.shape != (pcap,) or
                v.device != device or not v.is_contiguous()
                for v in probe_valid):
            raise ValueError("probe validity must be contiguous bool[pcap]")
        valid_ptrs = (ctypes.c_void_p * len(probe_valid))(
            *[v.data_ptr() for v in probe_valid])
    else:
        valid_ptrs = None
    nb_t, nb_val = _count_arg(n_build, device, bcap, "n_build")
    np_t, np_val = _count_arg(n_probe, device, _MAX_CAPACITY - 1, "n_probe")
    if lower_only:
        lo = torch.empty(pcap, dtype=torch.int32, device=device)
        count = totals = None
        count_ptr = totals_ptr = None
    else:
        lo, count = torch.empty((2, pcap), dtype=torch.int32,
                                device=device).unbind(0)
        totals = torch.empty(2, dtype=torch.int64, device=device)
        count_ptr, totals_ptr = count.data_ptr(), totals.data_ptr()
    rc = native.library("join_probe").join_probe(
        build_lanes.data_ptr(), bcap, lane_stride, row_stride, _ptr(nb_t),
        nb_val, probe_lanes.data_ptr(), pcap, nl, valid_ptrs,
        len(probe_valid), _ptr(np_t), np_val, lo.data_ptr(), count_ptr,
        totals_ptr, int(lower_only), native.stream_ptr(device))
    native.check(rc, "join_probe")
    native.bump("join_probe")
    if lower_only:
        native.bump("join_probe_lower")
    return lo, count, totals


def _count_arg(n, device, most: int, what: str):
    """(int32[1] tensor or None, value): a tensor count as an int32 on the
    device, read there (the caller holds the tensor until the launch); a
    host int by value, checked against [0, ``most``]."""
    if isinstance(n, torch.Tensor):
        return K._count_tensor(n, device), 0
    n = int(n)
    if not 0 <= n <= most:
        raise ValueError(f"{what} {n} outside [0, {most}]")
    return None, n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _lex_cmp(a_lanes: List[torch.Tensor], b_lanes: List[torch.Tensor]):
    """(a < b, a == b) elementwise, lexicographic over the lane lists."""
    lt = torch.zeros(a_lanes[0].shape, dtype=torch.bool,
                     device=a_lanes[0].device)
    eq = torch.ones_like(lt)
    for a, b in zip(a_lanes, b_lanes):
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return lt, eq


def _search_bounds(build_lanes: torch.Tensor, n_build,
                   probe_lanes: torch.Tensor, side: str) -> torch.Tensor:
    """Vectorized binary search of each probe row into the sorted build
    lanes: side 'left' gives the first index with build >= probe, 'right'
    the first with build > probe. Rows at or past n_build are +infinity."""
    cap = build_lanes.shape[1]
    pcap = probe_lanes.shape[1]
    device = probe_lanes.device
    lo = torch.zeros(pcap, dtype=torch.int64, device=device)
    hi = torch.zeros(pcap, dtype=torch.int64, device=device) + n_build
    probe = list(probe_lanes)
    for _ in range(cap.bit_length()):       # a range of up to cap rows
        active = lo < hi
        mid = (lo + hi) // 2
        midc = torch.clamp(mid, 0, cap - 1)
        blt, beq = _lex_cmp([lane[midc] for lane in build_lanes], probe)
        go_right = blt if side == "left" else (blt | beq)
        go_right = go_right & (mid < n_build)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _join_probe_torch(build_lanes, n_build, probe_lanes, probe_valid,
                      n_probe, lower_only: bool = False):
    """Plain PyTorch twin of K6 (and of its lower-bound mode)."""
    pcap = probe_lanes.shape[1]
    lo = _search_bounds(build_lanes, n_build, probe_lanes, "left")
    if lower_only:
        return lo.to(torch.int32), None, None
    hi = _search_bounds(build_lanes, n_build, probe_lanes, "right")
    live = torch.arange(pcap, device=probe_lanes.device) < n_probe
    ok = live
    for v in probe_valid:
        ok = ok & v
    count = torch.where(ok, hi - lo, 0).to(torch.int32)
    totals = torch.stack([count.sum(dtype=torch.int64),
                          (live & (count == 0)).sum(dtype=torch.int64)])
    return lo.to(torch.int32), count, totals


# ---------------------------------------------------------------------------
# K7: join expansion
# ---------------------------------------------------------------------------

def _expand_indices(m: JoinMatch, out_capacity: int, outer: bool = False,
                    n_stream=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stream_idx int64, build_idx int64, live bool), each of
    ``out_capacity`` slots: slot i < total holds the i-th matched pair, the
    build row already mapped through the build order; the other slots hold
    0 and are not live. ``outer`` (a left join): every live stream row
    (< ``n_stream``) takes max(count, 1) slots, and a row with no match
    has build_idx -1."""
    device = m.count.device
    if device.type == "cpu":
        return _expand_indices_torch(m, out_capacity, outer, n_stream)
    if device.type != "cuda":
        raise RuntimeError(f"join_expand: unsupported device {device}")
    n = m.count.shape[0]
    if m.lo.shape != (n,) or m.lo.dtype != torch.int32 or \
            m.count.dtype != torch.int32 or \
            m.build_order.dtype != torch.int64 or \
            any(not t.is_contiguous() or t.device != device
                for t in (m.lo, m.count, m.build_order)):
        raise ValueError("join_expand takes int32 lo/count and an int64 "
                         "order, contiguous on the device")
    stream_idx = torch.empty(out_capacity, dtype=torch.int64, device=device)
    build_idx = torch.empty(out_capacity, dtype=torch.int64, device=device)
    total = torch.empty(1, dtype=torch.int64, device=device)
    ns_t = K._count_tensor(n_stream, device) if outer else None
    lib = native.library("join_expand")
    scratch = torch.empty(int(lib.join_expand_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    rc = lib.join_expand(m.count.data_ptr(), m.lo.data_ptr(), n, int(outer),
                         ns_t.data_ptr() if outer else None,
                         m.build_order.data_ptr(), out_capacity,
                         stream_idx.data_ptr(), build_idx.data_ptr(),
                         total.data_ptr(), scratch.data_ptr(),
                         native.stream_ptr(device))
    native.check(rc, "join_expand")
    native.bump("join_expand_outer" if outer else "join_expand")
    live = torch.arange(out_capacity, device=device) < total
    return stream_idx, build_idx, live


def _expand_indices_torch(m: JoinMatch, out_capacity: int,
                          outer: bool = False, n_stream=None):
    """Plain PyTorch twin of K7 (the reference's searchsorted over the
    inclusive prefix sum; in outer mode over max(count, 1) of the live
    rows, as its left branch)."""
    device = m.count.device
    count = m.count.to(torch.int64)
    slots = count
    if outer:
        live_rows = torch.arange(count.shape[0], device=device) < n_stream
        slots = torch.where(live_rows, torch.clamp(count, min=1), 0)
    cum = torch.cumsum(slots, 0)
    starts = cum - slots
    out_i = torch.arange(out_capacity, device=device)
    live = out_i < cum[-1]
    stream_idx = torch.clamp(torch.searchsorted(cum, out_i, right=True),
                             max=count.shape[0] - 1)
    sorted_idx = m.lo.to(torch.int64)[stream_idx] + out_i - starts[stream_idx]
    build_idx = m.build_order[torch.clamp(sorted_idx, 0,
                                          m.build_order.shape[0] - 1)]
    if outer:
        build_idx = torch.where(count[stream_idx] == 0, -1, build_idx)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (torch.where(live, stream_idx, zero),
            torch.where(live, build_idx, zero), live)


# ---------------------------------------------------------------------------
# K14: matched build rows
# ---------------------------------------------------------------------------

def build_matched(lo: torch.Tensor, count: torch.Tensor, n_build,
                  build_capacity: int) -> torch.Tensor:
    """bool[build_capacity], in the build's sorted order: True where some
    stream row's match range [lo, lo + count) covers the row and the row
    is live (< ``n_build``). The reference's +1/-1 marks and prefix sum
    (joins.py:147-153)."""
    device = count.device
    if device.type == "cpu":
        return _build_matched_torch(lo, count, n_build, build_capacity)
    if device.type != "cuda":
        raise RuntimeError(f"build_matched: unsupported device {device}")
    n = count.shape[0]
    if lo.shape != (n,) or lo.dtype != torch.int32 or \
            count.dtype != torch.int32 or any(
                not t.is_contiguous() or t.device != device
                for t in (lo, count)):
        raise ValueError("build_matched takes contiguous int32 lo/count on "
                         "the device")
    matched = torch.empty(build_capacity, dtype=torch.bool, device=device)
    nb_t = K._count_tensor(n_build, device)
    lib = native.library("build_matched")
    scratch = torch.empty(
        int(lib.build_matched_scratch_bytes(build_capacity)),
        dtype=torch.uint8, device=device)
    rc = lib.build_matched(lo.data_ptr(), count.data_ptr(), n,
                           nb_t.data_ptr(), build_capacity,
                           matched.data_ptr(), scratch.data_ptr(),
                           native.stream_ptr(device))
    native.check(rc, "build_matched")
    native.bump("build_matched")
    return matched


def _build_matched_torch(lo, count, n_build, build_capacity: int):
    """Plain PyTorch twin of K14."""
    device = count.device
    has = count > 0
    start = lo.to(torch.int64)[has]
    delta = torch.zeros(build_capacity + 1, dtype=torch.int32, device=device)
    one = torch.ones(start.shape[0], dtype=torch.int32, device=device)
    delta.index_add_(0, start, one)
    delta.index_add_(0, start + count.to(torch.int64)[has], -one)
    covered = torch.cumsum(delta[:-1], 0) > 0
    return covered & (torch.arange(build_capacity, device=device) < n_build)


# ---------------------------------------------------------------------------
# K15: cross product
# ---------------------------------------------------------------------------

def cross_expand(n_left: int, n_right: int, out_capacity: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left_idx int64, right_idx int64, total int64 0-d) over
    ``out_capacity`` slots (even: the engine's capacities are powers of
    two): slot i < n_left * n_right pairs left row i // n_right with right
    row i % n_right; the other slots hold 0. The counts are host ints,
    passed to the kernel by value; the product stays int64. The outputs
    are views of one allocation."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    n_left, n_right = int(n_left), int(n_right)
    if n_left < 0 or n_right < 0 or out_capacity < 2 or out_capacity % 2:
        raise ValueError(f"cross_expand: {n_left} x {n_right} rows into "
                         f"{out_capacity} slots (an even count)")
    if device.type == "cpu":
        return _cross_expand_torch(n_left, n_right, out_capacity, device)
    if device.type != "cuda":
        raise RuntimeError(f"cross_expand: unsupported device {device}")
    # at the main path's sizes this wrapper's host time is most of the
    # call's: one allocation, the launch, then one split, which the host
    # makes while the card writes
    buf = torch.empty(2 * out_capacity + 1, dtype=torch.int64,
                      device=device)
    # every main-path call has n_right == 1, which the kernel copies; the
    # multiply-high serves a right side of more rows
    divisor = 0
    if n_right > 1 and out_capacity < _SLOTS_32 and n_right < _SLOTS_32:
        magic, shift, add = _fast_divisor(n_right)
        divisor = magic | shift << 32 | int(add) << 40
    ptr = buf.data_ptr()
    rc = native.library("cross_expand").cross_expand(
        n_left, n_right, out_capacity, divisor, ptr, ptr + 8 * out_capacity,
        ptr + 16 * out_capacity, native.stream_ptr(device))
    native.check(rc, "cross_expand")
    native.bump("cross_expand")
    li, ri, total = buf.split_with_sizes([out_capacity, out_capacity, 1])
    return li, ri, total.squeeze_(0)      # in place: no fourth tensor


def _fast_divisor(d: int) -> Tuple[int, int, bool]:
    """(magic, shift, add) with which K15 divides any 32-bit n by ``d``
    (1 <= d < 2^32) without a division: h = (n * magic) >> 32, then
    n // d = h >> shift, or (h + ((n - h) >> 1)) >> shift when ``add``.
    The round-up multiplier ceil(2^(32+l) / d), 2^l < d <= 2^(l+1), is
    exact for every 32-bit n when its error m d - 2^(32+l) is at most 2^l;
    otherwise the 33-bit ceil(2^(33+l) / d) less 2^32 and the add-and-halve
    step are. d == 1 is (0, 0, False): the kernel copies."""
    if not 1 <= d < _SLOTS_32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    if d == 1:
        return 0, 0, False
    shift = (d - 1).bit_length() - 1
    magic = -(-(1 << (32 + shift)) // d)
    if magic * d - (1 << (32 + shift)) <= 1 << shift:
        return magic, shift, False
    return -(-(1 << (33 + shift)) // d) - (1 << 32), shift, True


def _cross_expand_torch(n_left, n_right, out_capacity: int, device):
    """Plain PyTorch twin of K15 (the reference's floor division and
    remainder, in int64)."""
    nl = torch.as_tensor(n_left, dtype=torch.int64, device=device)
    nr = torch.as_tensor(n_right, dtype=torch.int64, device=device)
    total = nl * nr
    out_i = torch.arange(out_capacity, device=device)
    live = out_i < total
    nr1 = torch.clamp(nr, min=1)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (torch.where(live, out_i // nr1, zero),
            torch.where(live, out_i % nr1, zero), total.reshape(()))


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def join_gather(m: JoinMatch, stream_cols: Sequence[Column],
                build_cols: Sequence[Column], out_capacity: int,
                join_type: str = "inner", n_stream=None
                ) -> Tuple[List[Column], List[Column], torch.Tensor]:
    """Phase 2: the output columns at a host-chosen capacity.

    join_type:
      inner      matched pairs (K7, then gathers at ``out_capacity``)
      left       + one row per live stream row without a match, its build
                 columns NULL (K7's outer mode)
      left_semi  stream rows with a match (K5 compaction, stream capacity)
      left_anti  live stream rows without a match (K5 compaction)
    A right join is a left join with the sides swapped, and a full outer
    join a left join plus :func:`unmatched_build_gather`: the execs
    compose them, as in the reference. Returns (stream output columns,
    build output columns, device row count)."""
    stream_cap = m.count.shape[0]
    if join_type in ("left_semi", "left_anti"):
        s_live = torch.arange(stream_cap, device=m.count.device) < n_stream
        keep = (m.count > 0) if join_type == "left_semi" else \
            (m.count == 0)
        perm, cnt = K.compaction_indices(keep & s_live)
        live = torch.arange(stream_cap, device=m.count.device) < cnt
        return ([K.gather_column(c, perm, out_valid=live)
                 for c in stream_cols], [], cnt)
    if join_type == "left":
        stream_idx, build_idx, live = _expand_indices(
            m, out_capacity, outer=True, n_stream=n_stream)
        b_live = live & (build_idx >= 0)
        s_out = [K.gather_column(c, stream_idx, out_valid=live)
                 for c in stream_cols]
        bidx = torch.clamp(build_idx, min=0)
        b_out = [K.gather_column(c, bidx, out_valid=b_live)
                 for c in build_cols]
        return s_out, b_out, m.totals.sum()
    if join_type != "inner":
        raise NotImplementedError(
            f"join_gather takes inner, left, left_semi or left_anti, not "
            f"{join_type}: a right join is a left join with the sides "
            "swapped, a full outer join a left join plus "
            "unmatched_build_gather")
    stream_idx, build_idx, live = _expand_indices(m, out_capacity)
    s_out = [K.gather_column(c, stream_idx, out_valid=live)
             for c in stream_cols]
    b_out = [K.gather_column(c, build_idx, out_valid=live)
             for c in build_cols]
    return s_out, b_out, m.total_pairs


def unmatched_build_gather(m: JoinMatch, build_cols: Sequence[Column],
                           n_build) -> Tuple[List[Column], torch.Tensor]:
    """The live build rows no stream row matched (``m.build_matched``,
    K14), compacted through K5 in the build's sorted order and gathered
    through the build order, at the build capacity; and their device
    count. NULL-key build rows come out unmatched (a full outer join emits
    them)."""
    if m.build_matched is None:
        raise ValueError("unmatched_build_gather needs join_match(..., "
                         "with_build_matched=True)")
    build_cap = m.build_order.shape[0]
    device = m.build_order.device
    b_live = torch.arange(build_cap, device=device) < n_build
    perm, cnt = K.compaction_indices(b_live & ~m.build_matched)
    orig_idx = m.build_order[perm]
    live = torch.arange(build_cap, device=device) < cnt
    return ([K.gather_column(c, orig_idx, out_valid=live)
             for c in build_cols], cnt)


def cross_join_gather(left_cols: Sequence[Column], n_left: int,
                      right_cols: Sequence[Column], n_right: int,
                      out_capacity: int
                      ) -> Tuple[List[Column], List[Column], torch.Tensor]:
    """Cartesian product: output slot i holds left row i // n_right and
    right row i % n_right (K15), for i < n_left * n_right. Returns (left
    output columns, right output columns, device row count, int64)."""
    device = (list(left_cols) + list(right_cols))[0].device
    li, ri, total = cross_expand(n_left, n_right, out_capacity, device)
    live = torch.arange(out_capacity, device=li.device) < total
    return ([K.gather_column(c, li, out_valid=live) for c in left_cols],
            [K.gather_column(c, ri, out_valid=live) for c in right_cols],
            total)
