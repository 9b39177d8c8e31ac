"""Spark's Murmur3Hash: the port of spark_rapids_tpu/ops/hashing.py
(``murmur3_column``, ``murmur3_batch``, the ``Murmur3Hash`` expression).

The hash is bit-compatible with Spark's (Murmur3_x86_32, seed 42, chained
across columns through the seed): ints, dates and booleans hash as int32,
longs and timestamps as int64, floats and doubles as their bits, strings as
their UTF-8 bytes. Hash partitioning places rows by ``pmod(hash, n)``, so
placement equals Spark's.

One hand-written CUDA kernel lives here: K11 :func:`murmur3`
(csrc/murmur3.cu, twin :func:`_murmur3_torch`), which hashes every row
over all its key columns and, for a hash exchange, writes the partition id
``pmod(hash, n)`` (``n`` for padding rows) that K12 splits by. The twin
carries uint32 values in int64 tensors with ``& 0xFFFFFFFF`` masks, since
torch's uint32 has no shifts.

A difference from the reference, on purpose: Spark hashes a float's
``Float.floatToIntBits`` and a double's ``Double.doubleToLongBits``, which
turn every NaN into the canonical NaN. The reference hashes the raw bits
(hashing.py:107-116), so NaN keys with other payloads land elsewhere. The
port hashes as Spark does; for every other value it gives the reference's
bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column
from . import kernels as K
from .expressions import Expression, materialize, result_column

SEED = 42
_M32 = 0xFFFFFFFF
_NAN_F32_BITS = 0x7FC00000
_NAN_F64_BITS = 0x7FF8000000000000


# ---------------------------------------------------------------------------
# K11: murmur3 over a row's key columns
# ---------------------------------------------------------------------------

def murmur3(cols: Sequence[Column], capacity: int, seed=SEED,
            num_partitions: int = 0, num_rows=None, want_hash: bool = True
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(hash int32[cap] or None, partition id int32[cap] or None).

    ``seed`` is an int or an int32[cap] tensor of per-row seeds. With
    ``num_partitions`` n > 0 the partition id ``pmod(hash, n)`` is written
    for rows below ``num_rows`` (an int or a 0-d tensor) and n for the
    padding rows; ``want_hash=False`` skips the hash output. More than
    MAX_KEYS columns go in blocks: murmur3 chains the columns through the
    seed, so each block's per-row hash seeds the next block."""
    blocks = K.key_blocks(cols)
    for block in blocks[:-1]:
        seed, _ = _murmur3_block(block, capacity, seed, 0, None, True)
    return _murmur3_block(blocks[-1], capacity, seed, num_partitions,
                          num_rows, want_hash)


def _murmur3_block(cols: Sequence[Column], capacity: int, seed,
                   num_partitions: int, num_rows, want_hash: bool
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K11 over at most MAX_KEYS columns (the twin for CPU tensors)."""
    device = cols[0].device if cols else seed.device
    if device.type == "cpu":
        h, pid = _murmur3_torch(cols, capacity, seed, num_partitions,
                                num_rows)
        return (h if want_hash else None), pid
    if device.type != "cuda":
        raise RuntimeError(f"murmur3: unsupported device {device}")
    for c in cols:
        K._check_key_column(c, capacity, device)
    seeds = None
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.shape != (capacity,) or \
                seed.device != device or not seed.is_contiguous():
            raise ValueError("per-row seeds must be contiguous int32[cap] "
                             "on the device")
        seeds = seed
        seed = 0
    hash_out = torch.empty(capacity, dtype=torch.int32, device=device) \
        if want_hash else None
    pid = n_t = None
    if num_partitions > 0:
        pid = torch.empty(capacity, dtype=torch.int32, device=device)
        n_t = K._count_tensor(num_rows, device)
    descs = K._key_descs(cols, [True] * len(cols), [True] * len(cols))
    rc = native.library("murmur3").murmur3(
        descs, len(cols), int(seed) & _M32,
        seeds.data_ptr() if seeds is not None else None, capacity,
        n_t.data_ptr() if n_t is not None else None, int(num_partitions),
        hash_out.data_ptr() if hash_out is not None else None,
        pid.data_ptr() if pid is not None else None,
        native.stream_ptr(device))
    native.check(rc, "murmur3")
    native.bump("murmur3")
    return hash_out, pid


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * 0xCC9E2D51) & _M32
    return (_rotl(k1, 15) * 0x1B873593) & _M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt: one 4-byte block (``v`` holds uint32 bits in int64)."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def _hash_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong: the low word, then the high word, of int64 bits."""
    h1 = _mix_h1(seed, _mix_k1(v & _M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & _M32))
    return _fmix(h1, 8)


def _hash_bytes(data: torch.Tensor, lengths: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
    """hashUnsafeBytes: whole 4-byte little-endian blocks inside the
    length, then each tail byte as a signed int block."""
    w = data.shape[1]
    d = data.to(torch.int64)
    ln = lengths.to(torch.int64)
    h1 = seed
    for b in range(w // 4):
        k1 = d[:, 4 * b] | (d[:, 4 * b + 1] << 8) | \
            (d[:, 4 * b + 2] << 16) | (d[:, 4 * b + 3] << 24)
        h1 = torch.where(ln >= 4 * (b + 1), _mix_h1(h1, _mix_k1(k1)), h1)
    base = (ln // 4) * 4
    for j in range(3):
        idx = base + j
        byte = torch.gather(d, 1, torch.clamp(idx, 0, w - 1)[:, None])[:, 0]
        signed = ((byte ^ 0x80) - 0x80) & _M32
        h1 = torch.where(idx < ln, _mix_h1(h1, _mix_k1(signed)), h1)
    return _fmix(h1, ln & _M32)


def _column_step(col: Column, h: torch.Tensor) -> torch.Tensor:
    """One column's step of the chain (h: uint32 in int64)."""
    t = col.dtype
    if t == dt.STRING:
        out = _hash_bytes(col.data, col.lengths, h)
    elif t == dt.FLOAT64:
        d = col.data
        bits = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int64)
        bits = torch.where(torch.isnan(d), _NAN_F64_BITS, bits)
        out = _hash_long(bits, h)
    elif t == dt.FLOAT32:
        d = col.data
        bits = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int32)
        bits = torch.where(torch.isnan(d), _NAN_F32_BITS,
                           bits.to(torch.int64) & _M32)
        out = _hash_int(bits, h)
    elif t.byte_width == 8:          # int64, timestamp
        out = _hash_long(col.data.to(torch.int64), h)
    else:                            # int8/16/32, date, bool
        out = _hash_int(col.data.to(torch.int64) & _M32, h)
    return torch.where(col.validity, out, h)


def _murmur3_torch(cols: Sequence[Column], capacity: int, seed=SEED,
                   num_partitions: int = 0, num_rows=None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch twin of K11: (hash int32[cap], partition id int32[cap]
    or None)."""
    device = cols[0].device if cols else seed.device
    if isinstance(seed, torch.Tensor):
        h = seed.to(torch.int64) & _M32
    else:
        h = torch.full((capacity,), int(seed) & _M32, dtype=torch.int64,
                       device=device)
    for c in cols:
        h = _column_step(c, h)
    h = ((h ^ 0x80000000) - 0x80000000).to(torch.int32)
    pid = None
    if num_partitions > 0:
        live = torch.arange(capacity, device=device) < num_rows
        pid = torch.where(live, torch.remainder(h, num_partitions),
                          num_partitions).to(torch.int32)
    return h, pid


def murmur3_column(col: Column, seed) -> torch.Tensor:
    """int32[cap] hash of one column chained from ``seed`` (an int or
    per-row int32 seeds); NULL rows keep the seed."""
    h, _ = murmur3([col], col.capacity, seed)
    return h


def murmur3_batch(cols: Sequence[Column], capacity: int,
                  seed: int = SEED) -> torch.Tensor:
    """Row hash across columns, chained as Spark's Murmur3Hash(children,
    42): each column's hash seeds the next. int32[cap]."""
    h, _ = murmur3(cols, capacity, seed)
    return h


def hash_partition_ids(cols: Sequence[Column], num_rows, capacity: int,
                       num_partitions: int) -> torch.Tensor:
    """int32[cap]: pmod(murmur3(cols), n) for live rows, n for padding
    (Spark's HashPartitioning)."""
    _, pid = murmur3(cols, capacity, SEED, num_partitions, num_rows,
                     want_hash=False)
    return pid


class Murmur3Hash(Expression):
    """hash(...) expression (Spark Murmur3Hash, seed 42)."""

    def __init__(self, *children: Expression, seed: int = SEED):
        super().__init__(*children)
        self.seed = seed

    @property
    def dtype(self):
        return dt.INT32

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch):
        cols = [materialize(c.eval(batch), batch) for c in self.children]
        data = murmur3_batch(cols, batch.capacity, self.seed)
        live = batch.row_mask_raw()
        return result_column(dt.INT32, torch.where(live, data, 0), live,
                             batch.capacity)
