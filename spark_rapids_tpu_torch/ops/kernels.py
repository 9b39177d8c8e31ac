"""Core columnar kernels over torch tensors: the port of spark_rapids_tpu/ops/kernels.py.

Two hand-written CUDA kernels live here, each with a plain PyTorch twin
that computes the same result:

* K2 :func:`sort_key_lanes` (csrc/sort_key_lanes.cu, twin
  :func:`_sort_key_lanes_torch`) encodes the sort keys into order-preserving
  63-bit int64 lanes; :func:`sort_indices` then runs a stable
  ``torch.sort`` per lane, least significant first. The permutation equals
  the JAX package's ``jnp.lexsort`` over its 32-bit lanes.
* K3 :func:`segment_bounds` (csrc/segment_bounds.cu, twin
  :func:`_segment_bounds_torch`) finds the group starts, group ids, group
  count and each group's first row of key-sorted columns.
* K5 :func:`compaction_indices` (csrc/compact_scan.cu, twin
  :func:`_compaction_indices_torch`) writes the stable kept-first
  permutation of a keep mask and the kept count; :func:`compact_columns`
  (every filter) gathers through it.

A wrapper runs its twin only for tensors on the CPU. For a CUDA tensor it
launches its kernel or raises. Gather, concat and slice stay torch
indexing and ``torch.cat`` (data movement one torch op already does as a
single kernel); they carry an ARRAY's element validity and recurse into a
STRUCT's fields.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.column import Column, StructColumn

_MIN_I64 = -(1 << 63)
_LANE_BITS = 63
# key descriptors one K2, K3 or K11 call takes (csrc/keys_common.cuh
# MAX_KEYS); a longer key list goes in blocks of at most this many
MAX_KEYS = 8


class SortKey(NamedTuple):
    column: Column
    ascending: bool = True
    nulls_first: bool = True   # Spark default: NULLS FIRST for asc


# ---------------------------------------------------------------------------
# Key descriptors shared by K2 and K3
# ---------------------------------------------------------------------------

_K_INT, _K_BOOL, _K_F32, _K_F64, _K_STRING = range(5)


def _len_bits(width: int) -> int:
    return max(1, (width + 1).bit_length())


def _key_kind(col: Column) -> Tuple[int, int]:
    t = col.dtype
    if t == dt.STRING:
        return _K_STRING, int(col.data.shape[1])
    if t == dt.BOOL:
        return _K_BOOL, 1
    if t == dt.FLOAT32:
        return _K_F32, 4
    if t == dt.FLOAT64:
        return _K_F64, 8
    if t.is_integral or t in (dt.DATE, dt.TIMESTAMP):
        return _K_INT, t.byte_width
    raise TypeError(f"not an orderable key type: {t}")


def _value_bits(col: Column) -> int:
    kind, width = _key_kind(col)
    if kind == _K_STRING:
        return 8 * width + _len_bits(width)
    if kind in (_K_F32, _K_F64):
        return 1 + 64
    if kind == _K_BOOL:
        return 8
    return 8 * width


def key_blocks(items: Sequence) -> List[Sequence]:
    """``items`` (keys or key columns) in blocks of at most MAX_KEYS, in
    order; no key gives one empty block."""
    return [items[i:i + MAX_KEYS]
            for i in range(0, len(items), MAX_KEYS)] or [items[:0]]


def _block_lane_count(keys: Sequence[SortKey]) -> int:
    bits = 1 + sum(1 + _value_bits(k.column) for k in keys)
    return -(-bits // _LANE_BITS)


def lane_count(keys: Sequence[SortKey]) -> int:
    """Number of 63-bit lanes the keys need: per block of MAX_KEYS keys,
    the lanes of its bit string (pad rank, then a null rank and the value
    bits per key), the blocks' lanes one after another."""
    return sum(_block_lane_count(b) for b in key_blocks(keys))


def _check_key_column(col: Column, capacity: int, device) -> None:
    arrays = col.arrays()
    for a in arrays:
        if a.device != device:
            raise ValueError(f"key arrays on {a.device}, expected {device}")
        if not a.is_contiguous():
            raise ValueError("key arrays must be contiguous")
        if a.shape[0] != capacity:
            raise ValueError(f"key capacity {a.shape[0]} != {capacity}")
    if col.validity.dtype != torch.bool:
        raise TypeError("validity must be torch.bool")
    if col.dtype == dt.STRING and (col.data.dtype != torch.uint8 or
                                   col.lengths.dtype != torch.int32):
        raise TypeError("string keys need uint8 bytes and int32 lengths")


def _key_descs(cols: Sequence[Column], ascending: Sequence[bool],
               nulls_first: Sequence[bool]):
    if len(cols) > MAX_KEYS:
        raise ValueError(f"a kernel call takes at most {MAX_KEYS} key "
                         "columns: split them with key_blocks")
    descs = (native.KeyDesc * max(1, len(cols)))()
    for i, (c, asc, nf) in enumerate(zip(cols, ascending, nulls_first)):
        kind, width = _key_kind(c)
        d = descs[i]
        d.data = c.data.data_ptr()
        d.valid = c.validity.data_ptr()
        d.lengths = c.lengths.data_ptr() if c.lengths is not None else None
        d.kind = kind
        d.width = width
        d.len_bits = _len_bits(width) if kind == _K_STRING else 0
        d.ascending = int(bool(asc))
        d.nulls_first = int(bool(nf))
        d.pad = 0
    return descs


def _count_tensor(n, device) -> torch.Tensor:
    """A row count (int or 0-d tensor) as an int32[1] tensor on ``device``."""
    if isinstance(n, torch.Tensor):
        return n.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(n)], dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# K2: sort-key lanes
# ---------------------------------------------------------------------------

def sort_key_lanes(keys: Sequence[SortKey], num_rows, capacity: int,
                   live_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64[lanes, capacity]: the keys' order-preserving lanes, most
    significant first. Padding rows (``>= num_rows``, or dead rows of
    ``live_mask``) rank last. More than MAX_KEYS keys go in blocks, each
    block's lanes (its own pad rank first) after the previous block's: the
    lexicographic order of the lanes is still the keys' order."""
    blocks = key_blocks(keys)
    if len(blocks) > 1:
        return torch.cat([sort_key_lanes(b, num_rows, capacity, live_mask)
                          for b in blocks])
    device = keys[0].column.device if keys else live_mask.device
    if device.type == "cpu":
        return _sort_key_lanes_torch(keys, num_rows, capacity, live_mask)
    if device.type != "cuda":
        raise RuntimeError(f"sort_key_lanes: unsupported device {device}")
    for k in keys:
        _check_key_column(k.column, capacity, device)
    if live_mask is not None and (live_mask.dtype != torch.bool or
                                  live_mask.shape != (capacity,) or
                                  live_mask.device != device):
        raise ValueError("live_mask must be bool[capacity] on the device")
    nlanes = lane_count(keys)
    lanes = torch.empty((nlanes, capacity), dtype=torch.int64, device=device)
    descs = _key_descs([k.column for k in keys], [k.ascending for k in keys],
                       [k.nulls_first for k in keys])
    n_t = None if live_mask is not None else _count_tensor(num_rows, device)
    lib = native.library("sort_key_lanes")
    rc = lib.sort_key_lanes(
        descs, len(keys),
        live_mask.data_ptr() if live_mask is not None else None,
        n_t.data_ptr() if n_t is not None else None,
        capacity, nlanes, lanes.data_ptr(), native.stream_ptr(device))
    native.check(rc, "sort_key_lanes")
    native.bump("sort_key_lanes")
    return lanes


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def _key_fields(key: SortKey) -> List[Tuple[torch.Tensor, int]]:
    """(unsigned bit pattern as int64, bit width) fields of one key, most
    significant first; the twin of the kernel's per-key encoding."""
    col, asc = key.column, key.ascending
    v = col.validity
    null_rank = (v if key.nulls_first else ~v).to(torch.int64)
    fields = [(null_rank, 1)]
    kind, width = _key_kind(col)
    if kind == _K_INT:
        bits = 8 * width
        x = col.data.to(torch.int64)
        if bits == 64:
            u = x ^ _MIN_I64
            if not asc:
                u = ~u
        else:
            mask = (1 << bits) - 1
            u = (x & mask) ^ (1 << (bits - 1))
            if not asc:
                u = u ^ mask
        fields.append((u, bits))
    elif kind == _K_BOOL:
        u = col.data.to(torch.int64)
        fields.append((u ^ 0xFF if not asc else u, 8))
    elif kind in (_K_F32, _K_F64):
        d = col.data.to(torch.float64)
        nan = torch.isnan(d)
        fields.append(((nan if asc else ~nan).to(torch.int64), 1))
        d = torch.where(nan | (d == 0), torch.zeros((), dtype=torch.float64,
                                                    device=d.device), d)
        b = d.view(torch.int64)
        u = torch.where(b < 0, ~b, b | _MIN_I64)
        fields.append((~u if not asc else u, 64))
    else:
        flip = 0 if asc else 0xFF
        for j in range(width):
            fields.append((col.data[:, j].to(torch.int64) ^ flip, 8))
        lb = _len_bits(width)
        lmask = (1 << lb) - 1
        ln = col.lengths.to(torch.int64) & lmask
        fields.append((ln ^ lmask if not asc else ln, lb))
    return fields


def _sort_key_lanes_torch(keys: Sequence[SortKey], num_rows, capacity: int,
                          live_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch twin of K2: the same lanes, bit for bit."""
    device = keys[0].column.device if keys else live_mask.device
    if live_mask is not None:
        pad = ~live_mask
    else:
        pad = torch.arange(capacity, device=device) >= num_rows
    fields = [(pad.to(torch.int64), 1)]
    for k in keys:
        fields.extend(_key_fields(k))
    lanes = []
    cur = torch.zeros(capacity, dtype=torch.int64, device=device)
    used = 0
    for v, nbits in fields:
        rem = nbits
        while rem > 0:
            take = min(rem, _LANE_BITS - used)
            chunk = _lsr(v, rem - take) & ((1 << take) - 1)
            cur = (cur << take) | chunk
            used += take
            rem -= take
            if used == _LANE_BITS:
                lanes.append(cur)
                cur = torch.zeros(capacity, dtype=torch.int64, device=device)
                used = 0
    if used:
        lanes.append(cur)
    return torch.stack(lanes)


def sort_indices(keys: Sequence[SortKey], num_rows, capacity: int,
                 live_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable permutation (int64) ordering live rows by the keys; padding
    and dead rows go last. K2 builds the lanes, then one stable
    ``torch.sort`` per lane, least significant lane first."""
    return lanes_order(sort_key_lanes(keys, num_rows, capacity, live_mask))


def lanes_order(lanes: torch.Tensor) -> torch.Tensor:
    """Stable permutation (int64) sorting int64[lanes, n] lexicographically,
    most significant lane first: one stable ``torch.sort`` per lane."""
    perm = None
    for lane in reversed(range(lanes.shape[0])):
        k = lanes[lane] if perm is None else lanes[lane][perm]
        _, idx = torch.sort(k, stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


# ---------------------------------------------------------------------------
# Gather / compaction / slicing
# ---------------------------------------------------------------------------

def gather_column(col: Column, indices: torch.Tensor,
                  out_valid: Optional[torch.Tensor] = None) -> Column:
    """Row gather; ``out_valid`` also masks output rows (False: NULL and
    zeroed). A struct gathers its children with the same indices."""
    validity = col.validity[indices]
    if out_valid is not None:
        validity = validity & out_valid
    if isinstance(col, StructColumn):
        return StructColumn(col.dtype, [gather_column(c, indices, out_valid)
                                        for c in col.children], validity)
    data = col.data[indices]
    lengths = col.lengths[indices] if col.lengths is not None else None
    elem_valid = col.elem_validity[indices] \
        if col.elem_validity is not None else None
    if out_valid is not None:
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if col.dtype.var_width:
            data = torch.where(out_valid[:, None], data, zero)
            lengths = torch.where(out_valid, lengths,
                                  torch.zeros((), dtype=torch.int32,
                                              device=data.device))
            if elem_valid is not None:
                elem_valid = elem_valid & out_valid[:, None]
        else:
            data = torch.where(out_valid, data, zero)
    return Column(col.dtype, data, validity, lengths, elem_valid)


def compaction_indices(keep: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm int64[n], count int32 0-d): stable order with kept rows first;
    ``keep`` is False on padding. The count stays on the device. K5
    (csrc/compact_scan.cu) on the card."""
    device = keep.device
    if device.type == "cpu":
        return _compaction_indices_torch(keep)
    if device.type != "cuda":
        raise RuntimeError(f"compaction_indices: unsupported device {device}")
    if keep.dtype != torch.bool or keep.dim() != 1 or \
            not keep.is_contiguous():
        raise ValueError("keep must be a contiguous bool[n] tensor")
    n = keep.shape[0]
    perm = torch.empty(n, dtype=torch.int64, device=device)
    count = torch.empty(1, dtype=torch.int32, device=device)
    lib = native.library("compact_scan")
    scratch = torch.empty(int(lib.compact_scan_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    rc = lib.compact_scan(keep.data_ptr(), n, perm.data_ptr(),
                          count.data_ptr(), scratch.data_ptr(),
                          native.stream_ptr(device))
    native.check(rc, "compact_scan")
    native.bump("compact_scan")
    return perm, count.reshape(())


def _compaction_indices_torch(keep: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K5: two cumsums and one scatter."""
    n = keep.shape[0]
    k = keep.to(torch.int64)
    n_keep = k.sum()
    pos_keep = torch.cumsum(k, 0) - 1
    pos_drop = n_keep + torch.cumsum(1 - k, 0) - 1
    pos = torch.where(keep, pos_keep, pos_drop)
    perm = torch.empty(n, dtype=torch.int64, device=keep.device)
    perm.scatter_(0, pos, torch.arange(n, device=keep.device))
    return perm, n_keep.to(torch.int32)


def compact_columns(cols: Sequence[Column], keep: torch.Tensor
                    ) -> Tuple[List[Column], torch.Tensor]:
    """Filter: rows where ``keep`` is True, compacted to the front; the
    count stays on the device."""
    perm, count = compaction_indices(keep)
    live = torch.arange(keep.shape[0], device=keep.device) < count
    return [gather_column(c, perm, out_valid=live) for c in cols], count


def slice_column(col: Column, start: int, out_capacity: int, length) -> Column:
    """Rows [start, start + length) into a column of ``out_capacity``."""
    dev = col.device
    idx = torch.clamp(torch.arange(out_capacity, device=dev) + start, 0,
                      col.capacity - 1)
    live = torch.arange(out_capacity, device=dev) < length
    return gather_column(col, idx, out_valid=live)


def rebucket_column(col: Column, num_rows: int, new_capacity: int) -> Column:
    return slice_column(col, 0, new_capacity, num_rows)


def concat_columns(cols: Sequence[Column], counts: Sequence[int],
                   out_capacity: int) -> Column:
    """Concatenate same-dtype columns (host-known counts) into one column
    of ``out_capacity`` rows with zeroed, invalid padding. Var-width
    columns are right-padded to the widest in their own dtype (a map's
    interleaved lanes pad by whole empty entries); structs concatenate
    field by field."""
    dtype = cols[0].dtype
    dev = cols[0].device
    pad = out_capacity - sum(counts)

    def cat(parts: List[torch.Tensor]) -> torch.Tensor:
        if pad:
            parts.append(torch.zeros((pad,) + tuple(parts[0].shape[1:]),
                                     dtype=parts[0].dtype, device=dev))
        return torch.cat(parts)

    validity = cat([c.validity[:n] for c, n in zip(cols, counts)])
    if isinstance(cols[0], StructColumn):
        return StructColumn(dtype, [
            concat_columns([c.children[j] for c in cols], counts,
                           out_capacity)
            for j in range(len(cols[0].children))], validity)
    if dtype.var_width:
        width = max(int(c.data.shape[1]) for c in cols)

        def widened(t: torch.Tensor, n: int) -> torch.Tensor:
            return torch.nn.functional.pad(t[:n], (0, width - t.shape[1]))
        data = cat([widened(c.data, n) for c, n in zip(cols, counts)])
        lens = cat([c.lengths[:n] for c, n in zip(cols, counts)])
        ev = None
        if dt.is_array(dtype):
            ev = cat([widened(c.elem_validity, n)
                      for c, n in zip(cols, counts)])
        return Column(dtype, data, validity, lens, ev)
    return Column(dtype, cat([c.data[:n] for c, n in zip(cols, counts)]),
                  validity)


# ---------------------------------------------------------------------------
# K3: segment bounds
# ---------------------------------------------------------------------------

def segment_bounds(key_cols: Sequence[Column], n_live, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(starts bool[cap], seg_ids int32[cap], n_groups int32 0-d,
    first_row int32[cap]) of key-sorted columns whose first ``n_live`` rows
    (an int or a 0-d tensor) are live. ``first_row[:n_groups]`` holds each
    group's first row; the rest of it is the other rows in order. More
    than MAX_KEYS columns go in blocks: a row starts a group when any block
    differs from the row before (one flags pass per block, then one
    scan)."""
    blocks = key_blocks(key_cols)
    device = key_cols[0].device
    if device.type == "cpu":
        starts = None
        for block in blocks:
            starts = _starts_torch(block, n_live, capacity, starts)
        return _bounds_from_starts_torch(starts)
    if device.type != "cuda":
        raise RuntimeError(f"segment_bounds: unsupported device {device}")
    for c in key_cols:
        _check_key_column(c, capacity, device)
    starts = torch.empty(capacity, dtype=torch.bool, device=device)
    seg_ids = torch.empty(capacity, dtype=torch.int32, device=device)
    first_row = torch.empty(capacity, dtype=torch.int32, device=device)
    n_groups = torch.empty(1, dtype=torch.int32, device=device)
    lib = native.library("segment_bounds")
    scratch = torch.empty(int(lib.segment_bounds_scratch_bytes(capacity)),
                          dtype=torch.uint8, device=device)
    n_t = _count_tensor(n_live, device)
    for b, block in enumerate(blocks):
        descs = _key_descs(block, [True] * len(block), [True] * len(block))
        rc = lib.segment_bounds(descs, len(block), int(b > 0),
                                int(b == len(blocks) - 1), n_t.data_ptr(),
                                capacity, starts.data_ptr(),
                                seg_ids.data_ptr(), first_row.data_ptr(),
                                n_groups.data_ptr(), scratch.data_ptr(),
                                native.stream_ptr(device))
        native.check(rc, "segment_bounds")
        native.bump("segment_bounds")
    return starts, seg_ids, n_groups.reshape(()), first_row


def _starts_torch(key_cols: Sequence[Column], n_live, capacity: int,
                  starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The group starts of one block of keys, OR-ed into ``starts`` (an
    earlier block's) when given."""
    device = key_cols[0].device
    idx = torch.arange(capacity, device=device)
    live = idx < n_live
    changed = torch.zeros(capacity, dtype=torch.bool, device=device) \
        if starts is None else starts
    for col in key_cols:
        prev_valid = torch.cat([col.validity[:1], col.validity[:-1]])
        vdiff = col.validity != prev_valid
        prev_d = torch.cat([col.data[:1], col.data[:-1]])
        if col.dtype == dt.STRING:
            prev_l = torch.cat([col.lengths[:1], col.lengths[:-1]])
            ddiff = (col.data != prev_d).any(dim=1) | (col.lengths != prev_l)
        elif col.dtype.is_floating:
            both_nan = torch.isnan(col.data) & torch.isnan(prev_d)
            ddiff = (col.data != prev_d) & ~both_nan
        else:
            ddiff = col.data != prev_d
        changed = changed | vdiff | (ddiff & col.validity & prev_valid)
    return live & ((idx == 0) | changed)


def _segment_bounds_torch(key_cols: Sequence[Column], n_live, capacity: int):
    """Plain PyTorch twin of K3 (all keys in one pass)."""
    return _bounds_from_starts_torch(_starts_torch(key_cols, n_live,
                                                   capacity))


def _bounds_from_starts_torch(starts: torch.Tensor):
    seg_ids = (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)
    n_groups = starts.sum().to(torch.int32)
    perm, _ = _compaction_indices_torch(starts)
    return starts, seg_ids, n_groups, perm.to(torch.int32)


def segment_starts_from_sorted_keys(key_cols: Sequence[Column], num_rows,
                                    capacity: int) -> torch.Tensor:
    """Bool[cap]: row i starts a new group in key-sorted data (K3)."""
    return segment_bounds(key_cols, num_rows, capacity)[0]


def segment_ids(starts: torch.Tensor) -> torch.Tensor:
    """Int32[cap] group id per row from group-start flags. On the card the
    ids come from K3 (:func:`segment_bounds`) together with the starts."""
    if starts.device.type != "cpu":
        raise RuntimeError("on the card, take the ids from segment_bounds")
    return (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)
