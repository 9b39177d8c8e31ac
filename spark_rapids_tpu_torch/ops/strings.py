"""String expressions over padded byte matrices: the port of
spark_rapids_tpu/ops/strings.py.

Strings are ``uint8[cap, W]`` zero-padded bytes plus ``int32[cap]``
lengths. Character semantics (Length, Substring, locate) count UTF-8
character starts, bytes that are not ``0b10xxxxxx``. Case mapping is
ASCII-only and the pads count bytes, as the reference declares; Upper,
Lower and InitCap are ``incompat`` and need
``spark.rapids.tpu.sql.incompatibleOps.enabled`` (plan/overrides.py).

Four hand-written CUDA kernels carry the device work, each with a plain
PyTorch twin:

* K13 :func:`find_pattern` (csrc/find_pattern.cu, twin
  :func:`_find_pattern_torch`): the position of a literal pattern in
  every row, first occurrence, prefix or suffix (Contains, StartsWith,
  EndsWith and LIKE's fast paths), and in its LOCATE mode the 1-based
  character index of the first occurrence (StringLocate; counted apart as
  ``find_pattern_locate``).
* K16 :func:`string_map` (csrc/string_map.cu, twin
  :func:`_string_map_torch`): Length's character count and the case maps.
* K17 :func:`string_slice` (csrc/string_slice.cu, twin
  :func:`_string_slice_torch`): Substring and the trims, which keep one
  contiguous byte run of each row.
* K18 :func:`string_place` (csrc/string_place.cu, twin
  :func:`_string_place_torch`): ConcatStr and the pads, whose every output
  byte comes from one source at a per-row offset or from a pad pattern.

A wrapper runs its twin only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises.

Three expressions run on the host in the reference itself, and so they do
here, the same way: LIKE with ``_``, an escape or an inner ``%``,
StringReplace, and StringLocate from a position other than 1. Each copies
the column to the host, applies the reference's Python function and
uploads the result (``Column.from_pylist``); ``native.HOST_STRING_PASSES``
counts those passes. The host regex expressions are not ported yet.

Where the reference departs from Spark's own rules, the port follows
Spark: ``substring`` with a negative position computes the end before it
clamps the start (UTF8String.substringSQL); ``lpad``/``rpad`` with an empty
pad cut the string to the width instead of padding with a space, and a
width of 0 or less gives the empty string.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, Scalar, string_width_bucket
from .expressions import (Expression, Literal, combine_validity, materialize,
                          result_column)
from .strings_util import scalar_bytes, string_equal

# K13's modes
FIRST, PREFIX, SUFFIX, LOCATE = 0, 1, 2, 3
# K16's modes
LENGTH, UPPER, LOWER, INITCAP = 0, 1, 2, 3
# K17's modes
SUBSTRING, TRIM, LTRIM, RTRIM = 0, 1, 2, 3
# K18's modes
CONCAT, LPAD, RPAD = 0, 1, 2
# operands one K18 call takes (csrc/string_place.cu MAX_OPERANDS)
MAX_CONCAT_OPERANDS = 32


def _rows_check(name: str, data: torch.Tensor, lengths: torch.Tensor,
                *others: Optional[torch.Tensor]) -> None:
    n = data.shape[0]
    tensors = [data, lengths] + [t for t in others if t is not None]
    if data.dtype != torch.uint8 or data.dim() != 2 or \
            lengths.dtype != torch.int32 or lengths.shape != (n,) or any(
                t.device != data.device or not t.is_contiguous()
                for t in tensors):
        raise ValueError(f"{name} takes contiguous uint8[N, W] rows and "
                         "int32[N] lengths on one device")


def _bool_check(name: str, t: Optional[torch.Tensor], n: int) -> None:
    if t is not None and (t.dtype != torch.bool or t.shape != (n,)):
        raise ValueError(f"{name}: validity must be bool[N]")


# ---------------------------------------------------------------------------
# Byte-matrix primitives
# ---------------------------------------------------------------------------

def _is_char_start(data: torch.Tensor) -> torch.Tensor:
    """True for bytes that start a UTF-8 character (not 0b10xxxxxx)."""
    return (data & 0xC0) != 0x80


def _char_count(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """int32[N]: the character starts below each row's length."""
    w = data.shape[1]
    in_str = torch.arange(w, device=data.device)[None, :] < lengths[:, None]
    return (_is_char_start(data) & in_str).sum(dim=1).to(torch.int32)


def _materialize_str(v, device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(data, lengths, validity) of a Column or Scalar operand: a column's
    own, or a scalar as one row (``[1, W]``, ``[1]``, ``[1]``; W the width
    bucket of its bytes) that stands for every row."""
    if isinstance(v, Scalar):
        raw, n = scalar_bytes(v)
        row = np.zeros((1, string_width_bucket(max(n, 1))), dtype=np.uint8)
        row[0, :n] = raw
        return (torch.from_numpy(row).to(device),
                torch.tensor([n], dtype=torch.int32, device=device),
                torch.tensor([not v.is_null], dtype=torch.bool,
                             device=device))
    return v.data, v.lengths, v.validity


def _pattern_tensor(pat, device) -> torch.Tensor:
    return torch.from_numpy(np.array(pat, dtype=np.uint8)).to(device)


# ---------------------------------------------------------------------------
# K13: pattern positions
# ---------------------------------------------------------------------------

def find_pattern(data: torch.Tensor, lengths: torch.Tensor,
                 pattern: torch.Tensor, mode: int = FIRST) -> torch.Tensor:
    """int32[N]: for each row of ``data`` (uint8[N, W]) the byte position
    where ``pattern`` (uint8[p], on the rows' device) occurs within the
    row's length: its first occurrence (FIRST), 0 when the row starts with
    it (PREFIX), ``length - p`` when the row ends with it (SUFFIX); -1
    where it does not. An empty pattern matches at 0, one longer than W
    nowhere. LOCATE gives the character starts in bytes 0 .. j of the row
    for the first occurrence j (its 1-based character index), 0 where
    there is none."""
    device = data.device
    if device.type == "cpu":
        return _find_pattern_torch(data, lengths, pattern, mode)
    if device.type != "cuda":
        raise RuntimeError(f"find_pattern: unsupported device {device}")
    if mode not in (FIRST, PREFIX, SUFFIX, LOCATE):
        raise ValueError(f"find_pattern: unknown mode {mode}")
    _rows_check("find_pattern", data, lengths, pattern)
    if pattern.dtype != torch.uint8 or pattern.dim() != 1:
        raise ValueError("find_pattern takes a uint8[p] pattern")
    n, w = data.shape
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    p = pattern.shape[0]
    if p == 0:          # the kernel reads no byte; give it a valid pointer
        pattern = data
    rc = native.library("find_pattern").find_pattern(
        data.data_ptr(), lengths.data_ptr(), n, w, pattern.data_ptr(), p,
        mode, out.data_ptr(), native.stream_ptr(device))
    native.check(rc, "find_pattern")
    native.bump("find_pattern_locate" if mode == LOCATE else "find_pattern")
    return out


def _find_pattern_torch(data: torch.Tensor, lengths: torch.Tensor,
                        pattern: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain PyTorch twin of K13 (the reference's shifted compare, with
    the start positions of the mode; LOCATE the reference's char-start
    cumsum at the found byte)."""
    n, w = data.shape
    p = pattern.shape[0]
    device = data.device
    if mode == LOCATE:
        found = _find_pattern_torch(data, lengths, pattern, FIRST)
        cum = torch.cumsum(_is_char_start(data).to(torch.int32), dim=1)
        at = torch.gather(cum, 1, found.clamp(0, w - 1).to(torch.int64)
                          [:, None])[:, 0]
        return torch.where(found >= 0, at, 0).to(torch.int32)
    if p == 0:
        return torch.zeros(n, dtype=torch.int32, device=device)
    if p > w:
        return torch.full((n,), -1, dtype=torch.int32, device=device)
    pos = torch.arange(w - p + 1, device=device)
    match = torch.ones((n, w - p + 1), dtype=torch.bool, device=device)
    for k in range(p):
        match &= data[:, k:k + w - p + 1] == pattern[k]
    ln = lengths.to(torch.int64).clamp(max=w)[:, None]
    match &= pos[None, :] + p <= ln
    if mode == PREFIX:
        match &= pos[None, :] == 0
    elif mode == SUFFIX:
        match &= pos[None, :] == ln - p
    first = torch.argmax(match.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(match.any(dim=1), first, -1).to(torch.int32)


def _find_pattern(data: torch.Tensor, lengths: torch.Tensor,
                  pat: np.ndarray) -> torch.Tensor:
    """The reference's function: int32[N], the byte index of the first
    occurrence of ``pat`` in each row, -1 if none (K13, FIRST)."""
    return find_pattern(data, lengths, _pattern_tensor(pat, data.device),
                        FIRST)


# ---------------------------------------------------------------------------
# K16: character count and case maps
# ---------------------------------------------------------------------------

def string_map(data: torch.Tensor, lengths: torch.Tensor,
               validity: torch.Tensor, mode: int) -> torch.Tensor:
    """LENGTH: int32[N], the character count of each row (0 for a NULL
    row). UPPER, LOWER, INITCAP: uint8[N, W], every byte of the matrix
    mapped (ASCII only; INITCAP upper-cases a byte after a space or at
    column 0 and lower-cases the rest)."""
    device = data.device
    if device.type == "cpu":
        return _string_map_torch(data, lengths, validity, mode)
    if device.type != "cuda":
        raise RuntimeError(f"string_map: unsupported device {device}")
    if mode not in (LENGTH, UPPER, LOWER, INITCAP):
        raise ValueError(f"string_map: unknown mode {mode}")
    _rows_check("string_map", data, lengths, validity)
    n, w = data.shape
    if w % 8:
        raise ValueError("string_map takes rows whose width is a multiple "
                         "of 8")
    _bool_check("string_map", validity, n)
    if mode == LENGTH:
        out = torch.empty(n, dtype=torch.int32, device=device)
    else:
        out = torch.empty((n, w), dtype=torch.uint8, device=device)
    if n == 0 or w == 0:
        return out
    rc = native.library("string_map").string_map(
        data.data_ptr(), lengths.data_ptr(), validity.data_ptr(), n, w, mode,
        out.data_ptr() if mode != LENGTH else None,
        out.data_ptr() if mode == LENGTH else None,
        native.stream_ptr(device))
    native.check(rc, "string_map")
    native.bump("string_map")
    return out


def _string_map_torch(data: torch.Tensor, lengths: torch.Tensor,
                      validity: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain PyTorch twin of K16 (the reference's matrix expressions)."""
    if mode == LENGTH:
        return torch.where(validity, _char_count(data, lengths),
                           0).to(torch.int32)
    lower = (data >= ord("a")) & (data <= ord("z"))
    upper = (data >= ord("A")) & (data <= ord("Z"))
    if mode == UPPER:
        return torch.where(lower, data - 32, data).to(torch.uint8)
    if mode == LOWER:
        return torch.where(upper, data + 32, data).to(torch.uint8)
    is_sp = data == ord(" ")
    prev_sp = torch.cat([torch.ones((data.shape[0], 1), dtype=torch.bool,
                                    device=data.device), is_sp[:, :-1]],
                        dim=1)
    return torch.where(prev_sp & lower, data - 32,
                       torch.where(~prev_sp & upper, data + 32,
                                   data)).to(torch.uint8)


# ---------------------------------------------------------------------------
# K17: one byte run of every row (Substring, trims)
# ---------------------------------------------------------------------------

def _int_arg(x, n: int, device) -> Tuple[Optional[torch.Tensor], int]:
    """A per-row int operand as (contiguous int32[N] tensor, 0) or (None,
    the one value)."""
    if isinstance(x, torch.Tensor):
        if x.shape != (n,) or x.device != device:
            raise ValueError("per-row positions and lengths must be [N] on "
                             "the rows' device")
        return x.to(torch.int32).contiguous(), 0
    return None, int(x)


def string_slice(data: torch.Tensor, lengths: torch.Tensor,
                 validity: Optional[torch.Tensor], mode: int,
                 pos=0, length=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8[N, W], int32[N]): one run of bytes of each row moved to its
    front, zeros after it; the run's length, 0 for a NULL row (``validity``
    None: every row valid). SUBSTRING takes the characters from the
    1-based ``pos`` for ``length`` characters (ints or int[N] tensors;
    pos 0 is 1, a negative pos counts from the end, with Spark's order:
    the end before the start is clamped); TRIM, LTRIM, RTRIM drop leading
    and/or trailing spaces."""
    device = data.device
    if device.type == "cpu":
        return _string_slice_torch(data, lengths, validity, mode, pos,
                                   length)
    if device.type != "cuda":
        raise RuntimeError(f"string_slice: unsupported device {device}")
    if mode not in (SUBSTRING, TRIM, LTRIM, RTRIM):
        raise ValueError(f"string_slice: unknown mode {mode}")
    _rows_check("string_slice", data, lengths, validity)
    n, w = data.shape
    _bool_check("string_slice", validity, n)
    pos_t, pos_s = _int_arg(pos, n, device)
    len_t, len_s = _int_arg(length, n, device)
    if not (-2 ** 31 <= pos_s < 2 ** 31 and -2 ** 31 <= len_s < 2 ** 31):
        raise ValueError("string_slice takes int32 positions and lengths")
    out = torch.empty((n, w), dtype=torch.uint8, device=device)
    out_len = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0 or w == 0:
        return out, out_len.zero_()
    rc = native.library("string_slice").string_slice(
        data.data_ptr(), lengths.data_ptr(),
        validity.data_ptr() if validity is not None else None, n, w, mode,
        pos_t.data_ptr() if pos_t is not None else None, pos_s,
        len_t.data_ptr() if len_t is not None else None, len_s,
        out.data_ptr(), out_len.data_ptr(), native.stream_ptr(device))
    native.check(rc, "string_slice")
    native.bump("string_slice")
    return out, out_len


def _compact_rows(data: torch.Tensor, keep: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row stable compaction of kept bytes to the left (the
    reference's argsort form); returns (data, lengths)."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    out = torch.gather(data, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    pos = torch.arange(data.shape[1], device=data.device)[None, :]
    out = torch.where(pos < new_len[:, None], out, 0).to(torch.uint8)
    return out, new_len


def _string_slice_torch(data, lengths, validity, mode, pos, length):
    """Plain PyTorch twin of K17: the reference's per-byte keep mask and
    stable per-row compaction (with Spark's end for a negative pos)."""
    n, w = data.shape
    device = data.device
    col = torch.arange(w, device=device)[None, :]
    in_str = col < lengths[:, None]
    if mode == SUBSTRING:
        nchars = _char_count(data, lengths).to(torch.int64)
        p = pos.to(torch.int64) if isinstance(pos, torch.Tensor) else \
            torch.full((n,), int(pos), dtype=torch.int64, device=device)
        ln = length.to(torch.int64) if isinstance(length, torch.Tensor) \
            else torch.full((n,), int(length), dtype=torch.int64,
                            device=device)
        start = torch.where(p > 0, p - 1, torch.where(p < 0, nchars + p, 0))
        end = start + ln
        start = start.clamp(min=0)
        char_idx = torch.cumsum(_is_char_start(data).to(torch.int64),
                                dim=1) - 1
        keep = in_str & (char_idx >= start[:, None]) & \
            (char_idx < end[:, None])
    else:
        is_sp = (data == ord(" ")) & in_str
        keep = in_str
        if mode in (TRIM, LTRIM):
            lead = torch.cumprod(is_sp.to(torch.int32), dim=1).to(torch.bool)
            keep = keep & ~lead
        if mode in (TRIM, RTRIM):
            rev = (is_sp | ~in_str).flip(1)
            trail = torch.cumprod(rev.to(torch.int32), dim=1).flip(1) \
                .to(torch.bool)
            keep = keep & ~trail
    out, new_len = _compact_rows(data, keep)
    if validity is not None:
        new_len = torch.where(validity, new_len, 0).to(torch.int32)
    return out, new_len


# ---------------------------------------------------------------------------
# K18: bytes placed from sources or a pad pattern (ConcatStr, pads)
# ---------------------------------------------------------------------------

def _operand_of(data, lengths, validity, n: int):
    """A K18 operand descriptor: a column of ``n`` rows, or one row for
    every row (stride 0)."""
    stride = 1 if data.shape[0] == n else 0
    if stride == 0 and data.shape[0] != 1:
        raise ValueError("an operand has N rows or one")
    op = native.Operand()
    op.data = data.data_ptr()
    op.lengths = lengths.data_ptr()
    op.valid = validity.data_ptr()
    op.width = int(data.shape[1])
    op.stride = stride
    return op


def string_place(operands: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]],
                 n: int, out_width: int, mode: int, target: int = 0,
                 pad: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(uint8[n, out_width], int32[n] lengths, bool[n] validity).

    CONCAT: the operands ``(data, lengths, validity)`` (N rows each, or one
    row standing for all) laid end to end; NULL if any is NULL, with zero
    bytes and length 0. LPAD, RPAD: one operand cut or padded to ``target``
    bytes with the cyclic ``pad`` (uint8[p]) before (LPAD) or after (RPAD)
    it; an empty pad cuts without padding, a target of 0 or less gives the
    empty string; a NULL row keeps its bytes with length 0.

    One kernel call takes MAX_CONCAT_OPERANDS operands; a longer CONCAT
    places its first ones into a temporary column and concatenates that
    with the rest (concat is associative), on every device."""
    if not operands:
        raise ValueError("string_place takes at least one operand")
    if mode != CONCAT and len(operands) != 1:
        raise ValueError("a pad takes one operand")
    if len(operands) > MAX_CONCAT_OPERANDS:
        head = operands[:MAX_CONCAT_OPERANDS]
        head_w = string_width_bucket(sum(d.shape[1] for d, _, _ in head))
        placed = string_place(head, n, head_w, CONCAT)
        return string_place([placed, *operands[MAX_CONCAT_OPERANDS:]], n,
                            out_width, CONCAT)
    device = operands[0][0].device
    if pad is None:
        pad = torch.zeros(0, dtype=torch.uint8, device=device)
    if device.type == "cpu":
        return _string_place_torch(operands, n, out_width, mode, target, pad)
    if device.type != "cuda":
        raise RuntimeError(f"string_place: unsupported device {device}")
    if mode not in (CONCAT, LPAD, RPAD):
        raise ValueError(f"string_place: unknown mode {mode}")
    for data, lengths, validity in operands:
        _rows_check("string_place", data, lengths, validity)
        _bool_check("string_place", validity, data.shape[0])
    if pad.dtype != torch.uint8 or pad.dim() != 1 or pad.device != device \
            or not pad.is_contiguous():
        raise ValueError("string_place takes a uint8[p] pad on the device")
    if out_width % 8:
        raise ValueError("string_place writes rows whose width is a "
                         "multiple of 8")
    out = torch.empty((n, out_width), dtype=torch.uint8, device=device)
    out_len = torch.empty(n, dtype=torch.int32, device=device)
    out_valid = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out, out_len, out_valid
    ops = (native.Operand * len(operands))(
        *[_operand_of(d, l, v, n) for d, l, v in operands])
    p = pad.shape[0]
    rc = native.library("string_place").string_place(
        ops, len(operands), n, out_width, mode, int(target),
        pad.data_ptr() if p else out.data_ptr(), p, out.data_ptr(),
        out_len.data_ptr(), out_valid.data_ptr(), native.stream_ptr(device))
    native.check(rc, "string_place")
    native.bump("string_place")
    return out, out_len, out_valid


def _string_place_torch(operands, n, out_width, mode, target, pad):
    """Plain PyTorch twin of K18: the reference's shifted gathers and
    selects (ConcatStr 243-261, _Pad 583-606), with Spark's rule for an
    empty pad and a target of 0 or less."""
    device = operands[0][0].device
    pos = torch.arange(out_width, device=device)[None, :]

    def rows(t):
        return t.expand(n, *t.shape[1:]) if t.shape[0] != n else t

    if mode == CONCAT:
        out = torch.zeros((n, out_width), dtype=torch.uint8, device=device)
        offset = torch.zeros(n, dtype=torch.int64, device=device)
        validity = None
        for data, lengths, valid in operands:
            data, lengths, valid = rows(data), rows(lengths), rows(valid)
            w = data.shape[1]
            rel = pos - offset[:, None]
            in_src = (rel >= 0) & (rel < lengths[:, None])
            src = torch.gather(data, 1, rel.clamp(0, w - 1))
            out = torch.where(in_src, src, out)
            offset = offset + lengths
            validity = valid if validity is None else validity & valid
        lengths = torch.where(validity, offset, 0)
        out = torch.where(validity[:, None] & (pos < lengths[:, None]), out,
                          0).to(torch.uint8)
        return out, lengths.to(torch.int32), validity.clone()
    data, lengths, validity = (rows(t) for t in operands[0])
    if data.shape[1] < out_width:
        data = torch.nn.functional.pad(data, (0, out_width - data.shape[1]))
    ln = lengths.to(torch.int64)
    p = pad.shape[0]
    if target <= 0:
        new_len = torch.zeros(n, dtype=torch.int64, device=device)
        out = torch.zeros((n, out_width), dtype=torch.uint8, device=device)
    elif p == 0:
        new_len = ln.clamp(max=target)
        out = data[:, :out_width]
    else:
        pad_l = pad.to(torch.int64)
        if mode == LPAD:
            pad_n = (target - ln).clamp(min=0)
            src_idx = pos - pad_n[:, None]
            from_src = (src_idx >= 0) & (src_idx < ln[:, None])
            src = torch.gather(data, 1, src_idx.clamp(0, out_width - 1))
            pad_b = pad_l[pos % p].to(torch.uint8).expand(n, out_width)
        else:
            from_src = pos < ln[:, None]
            src = data[:, :out_width]
            pad_b = pad_l[(pos - ln[:, None]) % p].to(torch.uint8)
        out = torch.where(from_src, src, pad_b)
        new_len = torch.full((n,), target, dtype=torch.int64, device=device)
    out = torch.where(pos < new_len[:, None], out, 0).to(torch.uint8)
    return (out, torch.where(validity, new_len, 0).to(torch.int32),
            validity.clone())


# ---------------------------------------------------------------------------
# Host passes: the expressions the reference runs on the host
# ---------------------------------------------------------------------------

def _host_values(name: str, v: Column, num_rows: int) -> List:
    """The column's first ``num_rows`` values on the host: one pass of a
    host string expression, counted."""
    native.bump_host(name)
    return v.to_pylist(num_rows)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class StringUnary(Expression):
    """Base for one-string-child device expressions."""

    @property
    def child(self):
        return self.children[0]


class Length(StringUnary):
    """GpuLength: character count (K16, LENGTH)."""

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, batch: ColumnarBatch):
        v = self.child.eval(batch)
        if isinstance(v, Scalar):
            return Scalar(None if v.is_null else len(str(v.value)), dt.INT32)
        data = string_map(v.data, v.lengths, v.validity, LENGTH)
        return result_column(dt.INT32, data, v.validity, batch.capacity)


class _AsciiCase(StringUnary):
    """ASCII-only case mapping, 'incompat' as the reference's Upper/Lower
    (K16, UPPER or LOWER, over every byte of the matrix)."""
    incompat = True
    _mode: int

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.child.eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.STRING)
            f = str.upper if self._mode == UPPER else str.lower
            return Scalar(f(v.value), dt.STRING)
        data = string_map(v.data, v.lengths, v.validity, self._mode)
        return Column(dt.STRING, data, v.validity, v.lengths)


class Upper(_AsciiCase):
    _mode = UPPER


class Lower(_AsciiCase):
    _mode = LOWER


class InitCap(StringUnary):
    """GpuInitCap, incompat for the same ASCII reasons (K16, INITCAP)."""
    incompat = True

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.child.eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.STRING)
            return Scalar(" ".join(w.capitalize()
                                   for w in v.value.split(" ")), dt.STRING)
        data = string_map(v.data, v.lengths, v.validity, INITCAP)
        return Column(dt.STRING, data, v.validity, v.lengths)


def _int_operand(x):
    """(position or length, validity) of an int operand: a Scalar's value
    (-1 when NULL, as the reference fills it) and python validity, or a
    column's int32 data and validity."""
    if isinstance(x, Scalar):
        return (-1 if x.is_null else int(x.value)), not x.is_null
    return x.data.to(torch.int32), x.validity


class Substring(Expression):
    """GpuSubstring: 1-based character position, negative counts from the
    end (K17, SUBSTRING)."""

    def __init__(self, child: Expression, pos: Expression, length: Expression):
        super().__init__(child, pos, length)

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        pos_v = self.children[1].eval(batch)
        len_v = self.children[2].eval(batch)
        cap = batch.capacity
        if isinstance(v, Scalar):
            v = materialize(v, batch)
        pos, pval = _int_operand(pos_v)
        ln, lval = _int_operand(len_v)
        validity = combine_validity(v.validity, pval, lval)
        if validity is False:
            validity = torch.zeros(cap, dtype=torch.bool, device=batch.device)
        data, lengths = string_slice(
            v.data, v.lengths, None if validity is True else validity,
            SUBSTRING, pos, ln)
        if validity is True:
            validity = torch.ones(cap, dtype=torch.bool, device=batch.device)
        return Column(dt.STRING, data, validity, lengths)


class ConcatStr(Expression):
    """GpuConcat (string concat, NULL if any input NULL; K18, CONCAT)."""

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        cap = batch.capacity
        vals = [c.eval(batch) for c in self.children]
        if all(isinstance(v, Scalar) for v in vals):
            if any(v.is_null for v in vals):
                return Scalar(None, dt.STRING)
            return Scalar("".join(str(v.value) for v in vals), dt.STRING)
        mats = [_materialize_str(v, batch.device) for v in vals]
        total_w = string_width_bucket(sum(m[0].shape[1] for m in mats))
        data, lengths, validity = string_place(mats, cap, total_w, CONCAT)
        return Column(dt.STRING, data, validity, lengths)


class _PatternPredicate(Expression):
    """Base for Contains/StartsWith/EndsWith with a literal pattern: the
    row's result is ``(pos >= 0) & validity & live`` with validity
    ``validity & live`` (K13). A NULL literal gives an all-NULL column; a
    column pattern raises (the reference runs it on its host engine, which
    the port does not have)."""

    MODE = FIRST

    @property
    def dtype(self):
        return dt.BOOL

    def _pattern(self) -> Optional[np.ndarray]:
        rhs = self.children[1]
        if isinstance(rhs, Literal) and rhs.value is not None:
            return np.frombuffer(str(rhs.value).encode("utf-8"),
                                 dtype=np.uint8)
        return None

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        pat = self._pattern()
        if pat is None:
            rv = self.children[1].eval(batch)
            if not isinstance(rv, Scalar):
                raise NotImplementedError(
                    f"{type(self).__name__} with a column pattern is not "
                    "ported to the PyTorch engine (the reference runs it "
                    "on its host engine)")
            if rv.is_null:
                if isinstance(v, Scalar):
                    return Scalar(None, dt.BOOL)
                false = torch.zeros(batch.capacity, dtype=torch.bool,
                                    device=batch.device)
                return result_column(dt.BOOL, false, false.clone(),
                                     batch.capacity)
            pat = np.frombuffer(str(rv.value).encode("utf-8"),
                                dtype=np.uint8)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.BOOL)
            return Scalar(self._py(str(v.value), bytes(pat).decode("utf-8")),
                          dt.BOOL)
        pos = find_pattern(v.data, v.lengths,
                           _pattern_tensor(pat, v.data.device), self.MODE)
        valid = v.validity & batch.row_mask_raw()
        return result_column(dt.BOOL, (pos >= 0) & valid, valid,
                             batch.capacity)


class Contains(_PatternPredicate):
    MODE = FIRST

    def _py(self, s, p):
        return p in s


class StartsWith(_PatternPredicate):
    MODE = PREFIX

    def _py(self, s, p):
        return s.startswith(p)


class EndsWith(_PatternPredicate):
    MODE = SUFFIX

    def _py(self, s, p):
        return s.endswith(p)


class Like(Expression):
    """GpuLike: SQL LIKE. Plain equality and one-``%`` patterns (``x%``,
    ``%x``, ``%x%``) run on the device (string_equal, K13); a pattern with
    ``_``, the escape or an inner ``%`` runs on the host, as in the
    reference."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        super().__init__(child)
        self.pattern = pattern
        self.escape = escape

    @property
    def dtype(self):
        return dt.BOOL

    @property
    def fusable(self):  # type: ignore[override]
        """The reference's flag (strings.py:359): only the device fast
        paths may join a fused stage."""
        return self._fast_path() is not None

    def _fast_path(self):
        p = self.pattern
        if self.escape in p or "_" in p:
            return None
        if "%" not in p:
            return ("eq", p)
        core = p.strip("%")
        if "%" in core:
            return None
        if p.startswith("%") and p.endswith("%") and len(p) >= 2:
            return ("contains", core)
        if p.endswith("%"):
            return ("prefix", core)
        if p.startswith("%"):
            return ("suffix", core)
        return None

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        fp = self._fast_path()
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.BOOL)
            return Scalar(_like_py(str(v.value), self.pattern, self.escape),
                          dt.BOOL)
        if fp is None:
            vals = _host_values("like", v, batch.num_rows)
            out = [None if x is None else
                   _like_py(x, self.pattern, self.escape) for x in vals]
            return Column.from_pylist(out, dt.BOOL, capacity=batch.capacity,
                                      device=batch.device)
        kind, core = fp
        if kind == "eq":
            data = string_equal(v, Scalar(core, dt.STRING), batch.capacity,
                                batch.device)
        else:
            mode = {"contains": FIRST, "prefix": PREFIX,
                    "suffix": SUFFIX}[kind]
            pat = _pattern_tensor(np.frombuffer(core.encode("utf-8"),
                                                dtype=np.uint8), batch.device)
            data = find_pattern(v.data, v.lengths, pat, mode) >= 0
        valid = v.validity & batch.row_mask_raw()
        return result_column(dt.BOOL, data & valid, valid, batch.capacity)


def _like_py(s: str, pattern: str, escape: str) -> bool:
    """Host LIKE matcher (reference semantics: % any seq, _ any one char)."""
    import re
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.fullmatch("".join(out), s, flags=re.DOTALL) is not None


class StringLocate(Expression):
    """GpuStringLocate: locate(substr, str[, pos]), 1-based, 0 if not
    found (K13, LOCATE). A start position other than 1 runs on the host,
    as in the reference; a start given as a column is not read, as in the
    reference."""

    def __init__(self, substr: Expression, child: Expression,
                 start: Optional[Expression] = None):
        super().__init__(substr, child, start or Literal(1))

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, batch: ColumnarBatch):
        sub = self.children[0]
        if not isinstance(sub, Literal):
            raise NotImplementedError("locate takes a literal substring "
                                      "(as the reference)")
        v = self.children[1].eval(batch)
        start_v = self.children[2].eval(batch)
        if sub.value is None:
            if isinstance(v, Scalar):
                return Scalar(None, dt.INT32)
            return Column.full_null(dt.INT32, batch.capacity, batch.device)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.INT32)
            s = int(start_v.value or 1) if isinstance(start_v, Scalar) else 1
            return Scalar(str(v.value).find(str(sub.value), max(s - 1, 0)) + 1,
                          dt.INT32)
        if isinstance(start_v, Scalar) and (start_v.value or 1) != 1:
            vals = _host_values("locate", v, batch.num_rows)
            s = int(start_v.value or 1)
            out = [None if x is None else
                   (x.find(str(sub.value), max(s - 1, 0)) + 1 if s >= 1
                    else 0) for x in vals]
            return Column.from_pylist(out, dt.INT32, capacity=batch.capacity,
                                      device=batch.device)
        pat = _pattern_tensor(np.frombuffer(str(sub.value).encode("utf-8"),
                                            dtype=np.uint8), v.data.device)
        data = find_pattern(v.data, v.lengths, pat, LOCATE)
        data = torch.where(v.validity, data, 0).to(torch.int32)
        return result_column(dt.INT32, data, v.validity, batch.capacity)


class StringReplace(Expression):
    """GpuStringReplace: replace(str, search, replace) with literal search
    and replacement. The reference runs it on the host (the widths
    change); so does the port."""

    fusable = False   # the reference's flag (strings.py:497)

    def __init__(self, child: Expression, search: str, replacement: str):
        super().__init__(child)
        self.search = search
        self.replacement = replacement

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.STRING)
            return Scalar(str(v.value).replace(self.search, self.replacement),
                          dt.STRING)
        if self.search == "":
            return v
        vals = _host_values("replace", v, batch.num_rows)
        out = [None if x is None else x.replace(self.search, self.replacement)
               for x in vals]
        return Column.from_pylist(out, dt.STRING, capacity=batch.capacity,
                                  device=batch.device)


class _Trim(Expression):
    """GpuStringTrim family: spaces only, the common case (K17)."""
    _mode: int

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.STRING)
            s = str(v.value)
            if self._mode == TRIM:
                return Scalar(s.strip(" "), dt.STRING)
            return Scalar(s.lstrip(" ") if self._mode == LTRIM
                          else s.rstrip(" "), dt.STRING)
        data, lengths = string_slice(v.data, v.lengths, v.validity,
                                     self._mode)
        return Column(dt.STRING, data, v.validity, lengths)


class StringTrim(_Trim):
    _mode = TRIM


class StringTrimLeft(_Trim):
    _mode = LTRIM


class StringTrimRight(_Trim):
    _mode = RTRIM


class _Pad(Expression):
    """GpuStringLPad/RPad with a literal width and pad string (K18). Bytes,
    not characters, as the reference declares; Spark's rule for an empty
    pad and a width of 0 or less."""
    _mode: int

    def __init__(self, child: Expression, width: int, pad: str = " "):
        super().__init__(child)
        self.width = int(width)
        self.pad = pad

    @property
    def dtype(self):
        return dt.STRING

    def eval(self, batch: ColumnarBatch):
        v = self.children[0].eval(batch)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(None, dt.STRING)
            return Scalar(_pad_py(str(v.value), self.width, self.pad,
                                  self._mode == LPAD), dt.STRING)
        target = self.width
        out_w = string_width_bucket(max(target, v.data.shape[1]))
        pad = _pattern_tensor(np.frombuffer(self.pad.encode("utf-8"),
                                            dtype=np.uint8), batch.device)
        data, lengths, validity = string_place(
            [(v.data, v.lengths, v.validity)], batch.capacity, out_w,
            self._mode, target, pad)
        return Column(dt.STRING, data, validity, lengths)


def _pad_py(s: str, width: int, pad: str, left: bool) -> str:
    """Spark's lpad/rpad on a host value (characters)."""
    if width <= 0:
        return ""
    if len(s) >= width or pad == "":
        return s[:width]
    fill = (pad * width)[: width - len(s)]
    return fill + s if left else s + fill


class StringLPad(_Pad):
    _mode = LPAD


class StringRPad(_Pad):
    _mode = RPAD
