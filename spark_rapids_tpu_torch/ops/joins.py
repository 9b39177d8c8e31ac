"""Sort-merge equi-join kernels: the port of spark_rapids_tpu/ops/joins.py
(inner, left semi and left anti joins).

As in the reference, every equality join is sort-merge:

  1. sort the BUILD side by its keys: K2 lanes (kernels.sort_key_lanes)
     plus a stable ``torch.sort`` per lane (kernels.lanes_order);
  2. K6 :func:`join_probe` (csrc/join_probe.cu, twin
     :func:`_join_probe_torch`) binary-searches every STREAM row's lanes in
     the sorted build lanes: the range [lo, lo + count) of equal build rows,
     and the total pair count;
  3. K7 :func:`_expand_indices` (csrc/join_expand.cu, twin
     :func:`_expand_indices_torch`) turns the ranges into one (stream row,
     build row) pair per output slot; torch indexing gathers the columns.
     Semi and anti joins compact the stream side through K5 instead.

Both sides' keys are encoded by K2 with the same descriptors (string pairs
widened to the pair's width first), so lane equality is SQL key equality:
NULL keys never match (the probe masks them), NaN equals NaN and -0.0
equals +0.0. Two-phase sizing, as in the reference: :func:`join_match`
leaves the total pair count on the device; the caller reads it, buckets an
output capacity and calls :func:`join_gather`. A wrapper runs its twin
only for tensors on the CPU; for a CUDA tensor it launches its kernel or
raises.
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
    lanes: torch.Tensor    # int64[L, build_cap] build lanes in sorted order
    n_build: object        # live build rows (int or 0-d tensor)


def sort_build(build_keys: Sequence[Column], n_build) -> BuildSide:
    """Sort the build side by its keys (keys already widened)."""
    cap = build_keys[0].capacity
    lanes = K.sort_key_lanes([K.SortKey(c) for c in build_keys], n_build,
                             cap)
    order = K.lanes_order(lanes)
    return BuildSide(order, lanes[:, order].contiguous(), n_build)


class JoinMatch(NamedTuple):
    """The reference's fields. ``build_matched`` (which build rows found a
    match) is None: only full outer joins need it, and they are not
    ported."""
    lo: torch.Tensor             # int32[stream_cap] first matching build row
    count: torch.Tensor          # int32[stream_cap] matches per stream row
    build_order: torch.Tensor    # int64[build_cap] build sort permutation
    total_pairs: torch.Tensor    # int64 0-d: sum of count
    build_matched: Optional[torch.Tensor]


def join_match(build_keys: Sequence[Column], n_build,
               stream_keys: Sequence[Column], n_stream,
               stream_capacity: int,
               build: Optional[BuildSide] = None) -> JoinMatch:
    """Phase 1: sort the build side (or take ``build``, sorted once by
    :func:`sort_build` from keys widened by :func:`pair_widths`), then find
    each stream row's match range and count."""
    widths = pair_widths(build_keys, stream_keys)
    if build is None:
        build = sort_build(widen_keys(build_keys, widths), n_build)
    s_lanes, s_valid = _normalize_words(widen_keys(stream_keys, widths))
    if s_lanes.shape[1] != stream_capacity:
        raise ValueError("stream keys are not at the stream capacity")
    lo, count, total = join_probe(build.lanes, build.n_build, s_lanes,
                                  s_valid, n_stream)
    return JoinMatch(lo, count, build.order, total, None)


# ---------------------------------------------------------------------------
# K6: join probe
# ---------------------------------------------------------------------------

def join_probe(build_lanes: torch.Tensor, n_build, probe_lanes: torch.Tensor,
               probe_valid: Sequence[torch.Tensor], n_probe
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo int32[pcap], count int32[pcap], total int64 0-d): for each probe
    row the lower bound of its lanes in the first ``n_build`` sorted build
    lanes and the number of equal build rows; the count is 0 for rows at or
    past ``n_probe`` and rows with a NULL key."""
    device = probe_lanes.device
    if device.type == "cpu":
        return _join_probe_torch(build_lanes, n_build, probe_lanes,
                                 probe_valid, n_probe)
    if device.type != "cuda":
        raise RuntimeError(f"join_probe: unsupported device {device}")
    nl, pcap = probe_lanes.shape
    for t in (build_lanes, probe_lanes):
        if t.device != device or t.dtype != torch.int64 or \
                not t.is_contiguous():
            raise ValueError("lanes must be contiguous int64 on the device")
    if build_lanes.shape[0] != nl or nl > _MAX_LANES:
        raise ValueError(f"lane counts {build_lanes.shape[0]} vs {nl} "
                         f"(at most {_MAX_LANES})")
    if len(probe_valid) > _MAX_PROBE_KEYS or any(
            v.dtype != torch.bool or v.shape != (pcap,) or
            v.device != device or not v.is_contiguous()
            for v in probe_valid):
        raise ValueError("probe validity must be contiguous bool[pcap]")
    lo = torch.empty(pcap, dtype=torch.int32, device=device)
    count = torch.empty(pcap, dtype=torch.int32, device=device)
    total = torch.empty(1, dtype=torch.int64, device=device)
    valid_ptrs = (ctypes.c_void_p * max(1, len(probe_valid)))(
        *[v.data_ptr() for v in probe_valid])
    nb_t = K._count_tensor(n_build, device)
    np_t = K._count_tensor(n_probe, device)
    lib = native.library("join_probe")
    rc = lib.join_probe(build_lanes.data_ptr(), build_lanes.shape[1],
                        nb_t.data_ptr(), probe_lanes.data_ptr(), pcap, nl,
                        valid_ptrs, len(probe_valid), np_t.data_ptr(),
                        lo.data_ptr(), count.data_ptr(), total.data_ptr(),
                        native.stream_ptr(device))
    native.check(rc, "join_probe")
    native.bump("join_probe")
    return lo, count, total.reshape(())


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
                      n_probe):
    """Plain PyTorch twin of K6."""
    pcap = probe_lanes.shape[1]
    lo = _search_bounds(build_lanes, n_build, probe_lanes, "left")
    hi = _search_bounds(build_lanes, n_build, probe_lanes, "right")
    ok = torch.arange(pcap, device=probe_lanes.device) < n_probe
    for v in probe_valid:
        ok = ok & v
    count = torch.where(ok, hi - lo, 0).to(torch.int32)
    return lo.to(torch.int32), count, count.sum(dtype=torch.int64)


# ---------------------------------------------------------------------------
# K7: join expansion
# ---------------------------------------------------------------------------

def _expand_indices(m: JoinMatch, out_capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stream_idx int64, build_idx int64, live bool), each of
    ``out_capacity`` slots: slot i < total holds the i-th matched pair, the
    build row already mapped through the build order; the other slots hold
    0 and are not live."""
    device = m.count.device
    if device.type == "cpu":
        return _expand_indices_torch(m, out_capacity)
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
    lib = native.library("join_expand")
    scratch = torch.empty(int(lib.join_expand_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    rc = lib.join_expand(m.count.data_ptr(), m.lo.data_ptr(), n,
                         m.build_order.data_ptr(), out_capacity,
                         stream_idx.data_ptr(), build_idx.data_ptr(),
                         total.data_ptr(), scratch.data_ptr(),
                         native.stream_ptr(device))
    native.check(rc, "join_expand")
    native.bump("join_expand")
    live = torch.arange(out_capacity, device=device) < total
    return stream_idx, build_idx, live


def _expand_indices_torch(m: JoinMatch, out_capacity: int):
    """Plain PyTorch twin of K7 (the reference's searchsorted over the
    inclusive prefix sum)."""
    device = m.count.device
    count = m.count.to(torch.int64)
    cum = torch.cumsum(count, 0)
    starts = cum - count
    out_i = torch.arange(out_capacity, device=device)
    live = out_i < cum[-1]
    stream_idx = torch.clamp(torch.searchsorted(cum, out_i, right=True),
                             max=count.shape[0] - 1)
    sorted_idx = m.lo.to(torch.int64)[stream_idx] + out_i - starts[stream_idx]
    build_idx = m.build_order[torch.clamp(sorted_idx, 0,
                                          m.build_order.shape[0] - 1)]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (torch.where(live, stream_idx, zero),
            torch.where(live, build_idx, zero), live)


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
      left_semi  stream rows with a match (K5 compaction, stream capacity)
      left_anti  live stream rows without a match (K5 compaction)
    Returns (stream output columns, build output columns, device row
    count)."""
    stream_cap = m.count.shape[0]
    if join_type in ("left_semi", "left_anti"):
        s_live = torch.arange(stream_cap, device=m.count.device) < n_stream
        keep = (m.count > 0) if join_type == "left_semi" else \
            (m.count == 0)
        perm, cnt = K.compaction_indices(keep & s_live)
        live = torch.arange(stream_cap, device=m.count.device) < cnt
        return ([K.gather_column(c, perm, out_valid=live)
                 for c in stream_cols], [], cnt)
    if join_type != "inner":
        raise NotImplementedError(
            f"{join_type} join is not ported to the PyTorch engine yet")
    stream_idx, build_idx, live = _expand_indices(m, out_capacity)
    s_out = [K.gather_column(c, stream_idx, out_valid=live)
             for c in stream_cols]
    b_out = [K.gather_column(c, build_idx, out_valid=live)
             for c in build_cols]
    return s_out, b_out, m.total_pairs
