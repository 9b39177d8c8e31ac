"""String pattern predicates: the port of the pattern part of
spark_rapids_tpu/ops/strings.py (``_find_pattern``, ``StringUnary``,
``_PatternPredicate``, ``Contains``, ``StartsWith``, ``EndsWith``).

Strings are ``uint8[cap, W]`` zero-padded bytes plus ``int32[cap]``
lengths. The three predicates take a literal pattern and go through K13
:func:`find_pattern` (csrc/find_pattern.cu, twin
:func:`_find_pattern_torch`) in its first-occurrence, prefix or suffix
mode: the match position of every row, or -1. A wrapper runs its twin only
for tensors on the CPU; for a CUDA tensor it launches its kernel or
raises. The rest of the reference's string module (Length, case mapping,
Substring, ConcatStr, Like, locate, replace, trims, pads, the host regex
ops) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Scalar
from .expressions import Expression, Literal, result_column

# K13's modes
FIRST, PREFIX, SUFFIX = 0, 1, 2


def find_pattern(data: torch.Tensor, lengths: torch.Tensor,
                 pattern: torch.Tensor, mode: int = FIRST) -> torch.Tensor:
    """int32[N]: for each row of ``data`` (uint8[N, W]) the byte position
    where ``pattern`` (uint8[p], on the rows' device) occurs within the
    row's length: its first occurrence (FIRST), 0 when the row starts with
    it (PREFIX), ``length - p`` when the row ends with it (SUFFIX); -1
    where it does not. An empty pattern matches at 0, one longer than W
    nowhere."""
    device = data.device
    if device.type == "cpu":
        return _find_pattern_torch(data, lengths, pattern, mode)
    if device.type != "cuda":
        raise RuntimeError(f"find_pattern: unsupported device {device}")
    if mode not in (FIRST, PREFIX, SUFFIX):
        raise ValueError(f"find_pattern: unknown mode {mode}")
    n, w = data.shape
    if data.dtype != torch.uint8 or lengths.dtype != torch.int32 or \
            pattern.dtype != torch.uint8 or lengths.shape != (n,) or \
            pattern.dim() != 1 or any(
                t.device != device or not t.is_contiguous()
                for t in (data, lengths, pattern)):
        raise ValueError("find_pattern takes contiguous uint8[N, W] rows, "
                         "int32[N] lengths and a uint8[p] pattern on the "
                         "device")
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
    native.bump("find_pattern")
    return out


def _find_pattern_torch(data: torch.Tensor, lengths: torch.Tensor,
                        pattern: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain PyTorch twin of K13 (the reference's shifted compare, with
    the start positions of the mode)."""
    n, w = data.shape
    p = pattern.shape[0]
    device = data.device
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
    return find_pattern(data, lengths,
                        torch.from_numpy(np.array(pat, dtype=np.uint8)).to(
                            data.device), FIRST)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class StringUnary(Expression):
    """Base for one-string-child device expressions."""

    @property
    def child(self):
        return self.children[0]


class _PatternPredicate(Expression):
    """Base for Contains/StartsWith/EndsWith with a literal pattern: the
    row's result is ``(pos >= 0) & validity & live`` with validity
    ``validity & live``. A NULL literal gives an all-NULL column; a column
    pattern raises (the reference runs it on its host engine, which the
    port does not have)."""

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
                           torch.from_numpy(pat.copy()).to(v.data.device),
                           self.MODE)
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
