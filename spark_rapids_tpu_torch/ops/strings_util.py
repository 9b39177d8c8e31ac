"""Helpers over padded byte-matrix string columns: the port of
spark_rapids_tpu/ops/strings_util.py.

Strings are ``uint8[cap, W]`` zero-padded bytes plus ``int32[cap]``
lengths. Lexicographic comparison on the padded bytes is exact because the
zero pad sorts before any real byte (strings holding NUL bytes compare as
if cut there, as in the reference). These are elementwise torch ops; no
kernel of the port's own is needed for them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..columnar.column import Column, Scalar

StrOperand = Union[Column, Scalar]


def scalar_bytes(s: Scalar) -> Tuple[np.ndarray, int]:
    b = s.value.encode("utf-8") if isinstance(s.value, str) else \
        (s.value or b"")
    return np.frombuffer(b, dtype=np.uint8), len(b)


def operand_arrays(v: StrOperand, width: int, device,
                   cache: Optional[dict] = None):
    """(data[cap|1, W], lengths[cap|1]) padded to ``width``. A scalar's
    padded bytes and length are kept in ``cache`` (one per expression
    node), so a literal is copied to the device once, not once a batch."""
    if isinstance(v, Scalar):
        key = (v.value, width, str(device))
        hit = cache.get(key) if cache is not None else None
        if hit is not None:
            return hit
        raw, n = scalar_bytes(v)
        if n > width:
            raise ValueError(f"scalar of {n} bytes vs width {width}")
        row = np.zeros((1, width), dtype=np.uint8)
        row[0, :n] = raw
        out = (torch.from_numpy(row).to(device),
               torch.tensor([n], dtype=torch.int32, device=device))
        if cache is not None:
            cache[key] = out
        return out
    data = v.data
    if data.shape[1] < width:
        data = torch.nn.functional.pad(data, (0, width - data.shape[1]))
    return data, v.lengths


def _widths(lv: StrOperand, rv: StrOperand) -> int:
    w = 1
    for v in (lv, rv):
        if isinstance(v, Scalar):
            w = max(w, len(scalar_bytes(v)[0]))
        else:
            w = max(w, int(v.data.shape[1]))
    return w


def string_compare(lv: StrOperand, rv: StrOperand, capacity: int,
                   device, cache: Optional[dict] = None) -> torch.Tensor:
    """Three-way lexicographic compare -> int32[cap] in {-1, 0, 1}."""
    w = _widths(lv, rv)
    ld, _ = operand_arrays(lv, w, device, cache)
    rd, _ = operand_arrays(rv, w, device, cache)
    d = ld.to(torch.int16) - rd.to(torch.int16)
    nz = d != 0
    first = torch.argmax(nz.to(torch.uint8), dim=1)
    any_diff = nz.any(dim=1)
    byte_cmp = torch.gather(d, 1, first[:, None])[:, 0]
    out = torch.where(any_diff, torch.sign(byte_cmp).to(torch.int32),
                      torch.zeros((), dtype=torch.int32, device=device))
    return out.expand(capacity)


def string_equal(lv: StrOperand, rv: StrOperand, capacity: int,
                 device, cache: Optional[dict] = None) -> torch.Tensor:
    """Bool[cap]: equal bytes and equal lengths."""
    w = _widths(lv, rv)
    ld, ll = operand_arrays(lv, w, device, cache)
    rd, rl = operand_arrays(rv, w, device, cache)
    eq = (ld == rd).all(dim=1) & (ll == rl)
    return eq.expand(capacity)
