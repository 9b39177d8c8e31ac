"""ARRAY expressions and the explode kernels: the port of spark_rapids_tpu/ops/arrays.py.

An ARRAY<primitive> column is an element matrix ``data[cap, W]``, the
per-row ``lengths`` and an element validity ``bool[cap, W]``
(columnar/column.py). Two hand-written CUDA kernels live here, each with a
plain PyTorch twin that computes the same result:

* K25 :func:`explode_expand` (csrc/explode_expand.cu, twin
  :func:`_explode_expand_torch`): each output row's source row and element
  position from the per-row slot counts, and in array mode the element and
  its validity. It reads its total from the device once: the generate
  exec's one size read per batch (the reference reads its sum there too).
* K26 :func:`split_count` / :func:`split_place` (csrc/split_parts.cu,
  twins :func:`_split_count_torch` / :func:`_split_place_torch`): split on
  a single-byte literal delimiter, in count mode (parts per row) and place
  mode (each output row's part bytes); K25's index mode over the counts
  maps output rows to (row, part).

A wrapper runs its twin only for tensors on the CPU. For a CUDA tensor it
launches its kernel or raises. ``GetArrayItem`` and ``Size`` are one gather
along W and a ``where``: torch ops, data movement.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, bucket
from .expressions import Expression, materialize


class GetArrayItem(Expression):
    """arr[i]: an out-of-bounds index or a NULL array gives NULL, and so
    does a NULL element. ``one_based=True`` is element_at's indexing:
    1-based from the front, negative from the end, and 0 gives NULL (Spark
    raises; a deliberate difference kept from the reference)."""

    def __init__(self, child: Expression, index: Expression,
                 one_based: bool = False):
        super().__init__(child, index)
        self.one_based = one_based

    @property
    def dtype(self):
        return self.children[0].dtype.element

    @property
    def nullable(self):
        return True

    def eval(self, batch: ColumnarBatch):
        arr = materialize(self.children[0].eval(batch), batch)
        idx = self.children[1].eval(batch)
        cap, w = arr.data.shape
        dev = arr.device
        if isinstance(idx, Scalar):
            if idx.is_null:
                return Column.full_null(self.dtype, cap, dev)
            i = torch.full((cap,), int(idx.value), dtype=torch.int64,
                           device=dev)
            ivalid = torch.ones(cap, dtype=torch.bool, device=dev)
        else:
            i = idx.data.to(torch.int64)
            ivalid = idx.validity
        lens = arr.lengths.to(torch.int64)
        if self.one_based:
            eff = torch.where(i > 0, i - 1, lens + i)
            ok = arr.validity & ivalid & (i != 0) & (eff >= 0) & (eff < lens)
            i = eff
        else:
            ok = arr.validity & ivalid & (i >= 0) & (i < lens)
        ic = torch.clamp(i, 0, w - 1)[:, None]
        ok = ok & arr.elem_validity.gather(1, ic)[:, 0]
        data = arr.data.gather(1, ic)[:, 0]
        data = torch.where(ok, data, torch.zeros((), dtype=data.dtype,
                                                 device=dev))
        return Column(self.dtype, data, ok)


class Size(Expression):
    """size(arr) or size(map): Spark 3.0's legacy semantics, size(NULL) =
    -1 (spark.sql.legacy.sizeOfNull defaults true in the reference's
    era)."""

    @property
    def dtype(self):
        return dt.INT32

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        arr = materialize(self.children[0].eval(batch), batch)
        data = torch.where(arr.validity, arr.lengths, -1)
        live = batch.row_mask_raw()
        return Column(dt.INT32, torch.where(live, data, 0).to(torch.int32),
                      live)


class Explode(Expression):
    """Generator marker: planned by TpuGenerateExec, never evaluated
    inline. ``pos=True`` is posexplode."""

    def __init__(self, child: Expression, pos: bool = False):
        super().__init__(child)
        self.pos = pos

    @property
    def dtype(self):
        if isinstance(self.children[0], StringSplit):
            return dt.STRING
        t = self.children[0].dtype
        return t.element if t.element is not None else t

    @property
    def nullable(self):
        return True

    def eval(self, batch):
        raise RuntimeError("Explode is planned by TpuGenerateExec")


class StringSplit(Expression):
    """split(str, delim) -> array<string>. A single-byte literal delimiter
    that is no regex metacharacter runs on the device fused with explode;
    any other use raises at plan time (plan/overrides.py)."""

    def __init__(self, child: Expression, delimiter: str):
        super().__init__(child)
        self.delimiter = delimiter

    @property
    def dtype(self):
        return dt.ARRAY_STRING

    @property
    def nullable(self):
        return True

    def eval(self, batch):
        raise RuntimeError("StringSplit is planned with explode")


# ---------------------------------------------------------------------------
# K25: explode expansion
# ---------------------------------------------------------------------------

class Exploded(NamedTuple):
    """Output rows of an explode: ``src`` and ``pos`` int32[out_cap] (0
    past ``count``), ``count`` the output rows (read from the device once),
    ``total`` the same count as an int64 0-d tensor on the device; in array
    mode the elements ``values`` [out_cap] and ``values_valid``."""
    src: torch.Tensor
    pos: torch.Tensor
    count: int
    total: torch.Tensor
    values: Optional[torch.Tensor] = None
    values_valid: Optional[torch.Tensor] = None

    @property
    def out_capacity(self) -> int:
        return int(self.src.shape[0])

    def live(self) -> torch.Tensor:
        return torch.arange(self.out_capacity, device=self.src.device) < \
            self.count


def explode_expand(counts: torch.Tensor, valid: torch.Tensor,
                   live: torch.Tensor, data: Optional[torch.Tensor] = None,
                   elem_valid: Optional[torch.Tensor] = None) -> Exploded:
    """K25. Row j holds ``counts[j]`` output rows where ``live[j]`` and
    ``valid[j]``; the output capacity is bucket(total). With ``data``
    [cap, W] and ``elem_valid`` (array mode) each output row also gets its
    element; a NULL element gives a NULL row."""
    device = counts.device
    if device.type == "cpu":
        return _explode_expand_torch(counts, valid, live, data, elem_valid)
    if device.type != "cuda":
        raise RuntimeError(f"explode_expand: unsupported device {device}")
    n = counts.shape[0]
    for t, dtype in ((counts, torch.int32), (valid, torch.bool),
                     (live, torch.bool)):
        if t.dtype != dtype or t.shape != (n,) or t.device != device or \
                not t.is_contiguous():
            raise ValueError("explode_expand takes contiguous int32 counts "
                             "and bool validity and live mask of one length")
    if data is not None and (
            data.dim() != 2 or data.shape[0] != n or not data.is_contiguous()
            or elem_valid is None or elem_valid.shape != data.shape or
            elem_valid.dtype != torch.bool or
            not elem_valid.is_contiguous() or
            data.element_size() not in (1, 2, 4, 8)):
        raise ValueError("explode_expand: array data must be contiguous "
                         "[n, W] with a bool [n, W] element validity")
    lib = native.library("explode_expand")
    scratch = torch.empty(int(lib.explode_scratch_bytes(n)),
                          dtype=torch.uint8, device=device)
    total = torch.empty(1, dtype=torch.int64, device=device)
    stream = native.stream_ptr(device)
    rc = lib.explode_scan(counts.data_ptr(), valid.data_ptr(),
                          live.data_ptr(), n, total.data_ptr(),
                          scratch.data_ptr(), stream)
    native.check(rc, "explode_expand")
    count = int(total.item())          # the one size read of a batch
    out_cap = bucket(max(count, 1))
    src = torch.empty(out_cap, dtype=torch.int32, device=device)
    pos = torch.empty(out_cap, dtype=torch.int32, device=device)
    values = values_valid = None
    if data is not None:
        values = torch.empty(out_cap, dtype=data.dtype, device=device)
        values_valid = torch.empty(out_cap, dtype=torch.bool, device=device)
    rc = lib.explode_expand(
        counts.data_ptr(), valid.data_ptr(), live.data_ptr(), n, out_cap,
        total.data_ptr(), scratch.data_ptr(),
        data.data_ptr() if data is not None else None,
        data.shape[1] if data is not None else 0,
        data.element_size() if data is not None else 0,
        elem_valid.data_ptr() if data is not None else None,
        src.data_ptr(), pos.data_ptr(),
        values.data_ptr() if data is not None else None,
        values_valid.data_ptr() if data is not None else None, stream)
    native.check(rc, "explode_expand")
    native.bump("explode_expand")
    return Exploded(src, pos, count, total.reshape(()), values,
                    values_valid)


def _explode_expand_torch(counts, valid, live, data=None, elem_valid=None
                          ) -> Exploded:
    """Plain PyTorch twin of K25: a cumsum and a searchsorted."""
    device = counts.device
    n = torch.where(live & valid, counts, 0).to(torch.int64)
    cum = torch.cumsum(n, 0)
    total = cum[-1]
    count = int(total)
    out_cap = bucket(max(count, 1))
    out_i = torch.arange(out_cap, device=device)
    src = torch.clamp(torch.searchsorted(cum, out_i, right=True), 0,
                      n.shape[0] - 1)
    elem = out_i - (cum[src] - n[src])
    out_live = out_i < total
    src = torch.where(out_live, src, 0)
    pos = torch.where(out_live, elem, 0)
    values = values_valid = None
    if data is not None:
        values_valid = out_live & elem_valid[src, pos]
        values = torch.where(values_valid, data[src, pos],
                             torch.zeros((), dtype=data.dtype, device=device))
    return Exploded(src.to(torch.int32), pos.to(torch.int32), count, total,
                    values, values_valid)


def explode_array(arr: Column, live: torch.Tensor) -> tuple:
    """(Exploded, element column, position column) of an ARRAY column: one
    output row per element of each live, non-NULL array."""
    ex = explode_expand(arr.lengths, arr.validity, live, arr.data,
                        arr.elem_validity)
    elem = Column(arr.dtype.element, ex.values, ex.values_valid)
    return ex, elem, _pos_column(ex)


def _pos_column(ex: Exploded) -> Column:
    live = ex.live()
    return Column(dt.INT32, torch.where(live, ex.pos, 0), live)


# ---------------------------------------------------------------------------
# K26: split on a single-byte delimiter
# ---------------------------------------------------------------------------

def _check_string(col: Column, what: str) -> None:
    d = col.data
    if col.dtype != dt.STRING or d.dtype != torch.uint8 or \
            not d.is_contiguous() or d.shape[1] % 8 or \
            col.lengths.dtype != torch.int32 or \
            not col.lengths.is_contiguous() or \
            not col.validity.is_contiguous():
        raise ValueError(f"{what}: a contiguous string column of a width "
                         "that is a multiple of 8")


def split_count(col: Column, delim: int) -> torch.Tensor:
    """K26 count mode: int32[cap] parts of each row, 1 + the delimiter
    bytes inside its length (0 for NULL)."""
    device = col.device
    if device.type == "cpu":
        return _split_count_torch(col, delim)
    if device.type != "cuda":
        raise RuntimeError(f"split_count: unsupported device {device}")
    _check_string(col, "split_count")
    n, w = col.data.shape
    parts = torch.empty(n, dtype=torch.int32, device=device)
    lib = native.library("split_parts")
    rc = lib.split_count(col.data.data_ptr(), col.lengths.data_ptr(),
                         col.validity.data_ptr(), n, w, int(delim),
                         parts.data_ptr(), native.stream_ptr(device))
    native.check(rc, "split_parts")
    native.bump("split_parts")
    return parts


def _is_delim(col: Column, delim: int) -> torch.Tensor:
    w = col.data.shape[1]
    return (col.data == delim) & (
        torch.arange(w, device=col.device)[None, :] < col.lengths[:, None])


def _split_count_torch(col: Column, delim: int) -> torch.Tensor:
    """Plain PyTorch twin of K26's count mode."""
    n = 1 + _is_delim(col, delim).sum(dim=1)
    return torch.where(col.validity, n, 0).to(torch.int32)


def split_place(col: Column, delim: int, ex: Exploded) -> Column:
    """K26 place mode: output row i holds part ``ex.pos[i]`` of row
    ``ex.src[i]`` (bytes past its length 0), at the input's width."""
    device = col.device
    if device.type == "cpu":
        return _split_place_torch(col, delim, ex)
    if device.type != "cuda":
        raise RuntimeError(f"split_place: unsupported device {device}")
    _check_string(col, "split_place")
    w = col.data.shape[1]
    out_cap = ex.out_capacity
    out = torch.empty((out_cap, w), dtype=torch.uint8, device=device)
    lens = torch.empty(out_cap, dtype=torch.int32, device=device)
    valid = torch.empty(out_cap, dtype=torch.bool, device=device)
    lib = native.library("split_parts")
    rc = lib.split_place(col.data.data_ptr(), col.lengths.data_ptr(), w,
                         int(delim), ex.src.data_ptr(), ex.pos.data_ptr(),
                         out_cap, ex.total.data_ptr(), out.data_ptr(),
                         lens.data_ptr(), valid.data_ptr(),
                         native.stream_ptr(device))
    native.check(rc, "split_parts")
    native.bump("split_parts")
    return Column(dt.STRING, out, valid, lens)


def _split_place_torch(col: Column, delim: int, ex: Exploded) -> Column:
    """Plain PyTorch twin of K26's place mode: each row's delimiter
    positions in order, then a gather of each part's bytes."""
    device = col.device
    cap, w = col.data.shape
    is_delim = _is_delim(col, delim)
    # dpos[r, p]: byte position of row r's (p+1)-th delimiter, w if none
    dpos = torch.full((cap, w + 1), w, dtype=torch.int64, device=device)
    rows, cols = is_delim.nonzero(as_tuple=True)
    rank = torch.cumsum(is_delim.to(torch.int64), dim=1) - 1
    dpos[rows, rank[rows, cols]] = cols
    src = ex.src.to(torch.int64)
    part = ex.pos.to(torch.int64)
    prev = dpos[src, torch.clamp(part - 1, min=0)]
    p_start = torch.where(part == 0, 0, prev + 1)
    p_end = torch.minimum(dpos[src, part], col.lengths[src].to(torch.int64))
    p_len = torch.clamp(p_end - p_start, min=0)
    live = ex.live()
    j = torch.arange(w, device=device)[None, :]
    data = col.data[src[:, None], torch.clamp(p_start[:, None] + j, 0,
                                              w - 1)]
    data = torch.where((j < p_len[:, None]) & live[:, None], data,
                       torch.zeros((), dtype=torch.uint8, device=device))
    return Column(dt.STRING, data, live,
                  torch.where(live, p_len, 0).to(torch.int32))


def split_explode(col: Column, delim: int, live: torch.Tensor) -> tuple:
    """(Exploded, part column, position column) of split(col, delim)
    exploded, without the intermediate array<string>: K26 counts, K25
    maps output rows to (row, part), K26 places the bytes. Spark's split:
    "a,b" -> ["a", "b"]; "" -> [""]; NULL -> no row."""
    counts = split_count(col, delim)
    ex = explode_expand(counts, col.validity, live)
    return ex, split_place(col, delim, ex), _pos_column(ex)
