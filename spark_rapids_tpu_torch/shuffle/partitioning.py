"""Partitioning strategies: the port of spark_rapids_tpu/shuffle/partitioning.py
(single, hash, round-robin and range).

A partitioner gives every live row of a batch a partition id; ``split``
cuts the batch into one piece per partition, rows in their original order
within a piece. One hand-written CUDA kernel lives here: K12
:func:`partition_split` (csrc/partition_split.cu, twin
:func:`_partition_split_torch`), a stable counting sort of the rows by
partition id (padding last) that also counts each partition's rows. The
pieces are then gathered through slices of that permutation, one
``index_select`` per payload array and piece, each into a ``bucket(n)``
capacity (the reference sorts every array first and slices the sorted
arrays; the port gathers each piece once).

Hash ids are ``pmod(murmur3(keys), n)`` from K11 (ops/hashing.py), so
placement equals Spark's. Range ids count the bounds strictly below a row:
K2 encodes the bound rows and the batch's rows into the same lanes, and
K6's lower-bound search counts. The reference narrows f64 order keys to f32
there (partitioning.py:283-288); the port compares them exactly, so a row
within f32 rounding of a bound may land one partition over. The sorted
result is the same.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..columnar.batch import ColumnarBatch
from ..columnar.column import bucket
from ..ops import expressions as ex
from ..ops import hashing
from ..ops import joins as join_k
from ..ops import kernels as K

# ---------------------------------------------------------------------------
# K12: partition split
# ---------------------------------------------------------------------------

def partition_split(pids: torch.Tensor, num_rows, num_partitions: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm int64[cap], counts int32[n]): the rows ordered stably by
    partition id, rows at or past ``num_rows`` (an int or a 0-d tensor)
    last, and the rows of each partition. Equals
    ``argsort(where(live, pids, n), stable=True)`` and its bincount. Any
    number of partitions: up to 4096 the kernel keeps its counters in
    shared memory, above that in device memory."""
    n = int(num_partitions)
    if n < 1:
        raise ValueError(f"partition_split needs a partition, got {n}")
    device = pids.device
    if device.type == "cpu":
        return _partition_split_torch(pids, num_rows, n)
    if device.type != "cuda":
        raise RuntimeError(f"partition_split: unsupported device {device}")
    if pids.dtype != torch.int32 or pids.dim() != 1 or \
            not pids.is_contiguous():
        raise ValueError("pids must be a contiguous int32[cap] tensor")
    cap = pids.shape[0]
    perm = torch.empty(cap, dtype=torch.int64, device=device)
    counts = torch.empty(n, dtype=torch.int32, device=device)
    lib = native.library("partition_split")
    scratch = torch.empty(int(lib.partition_split_scratch_bytes(cap, n)),
                          dtype=torch.uint8, device=device)
    n_t = K._count_tensor(num_rows, device)
    rc = lib.partition_split(pids.data_ptr(), n_t.data_ptr(), cap, n,
                             perm.data_ptr(), counts.data_ptr(),
                             scratch.data_ptr(), native.stream_ptr(device))
    native.check(rc, "partition_split")
    native.bump("partition_split")
    return perm, counts


def _partition_split_torch(pids: torch.Tensor, num_rows, n: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K12 (the reference's formula)."""
    live = torch.arange(pids.shape[0], device=pids.device) < num_rows
    bins = torch.where(live, torch.clamp(pids.to(torch.int64), 0, n), n)
    perm = torch.argsort(bins, stable=True)
    counts = torch.bincount(bins, minlength=n + 1)[:n].to(torch.int32)
    return perm, counts


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------

class TpuPartitioner:
    num_partitions: int

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        """int32[cap] partition id of each live row."""
        raise NotImplementedError

    def split_deferred(self, batch: ColumnarBatch
                       ) -> Optional[Tuple[torch.Tensor, Callable]]:
        """Device half of :meth:`split`, its sizing read deferred:
        ``(counts on the device, make_pieces)``. The caller parks the
        counts on a PipelineWindow and calls ``make_pieces(host counts)``
        when they land (``None``: read them now). None when there is
        nothing to defer (one partition, or a batch known to be empty):
        then :meth:`split` needs no read."""
        raw = batch.num_rows_raw
        if self.num_partitions == 1 or (isinstance(raw, int) and raw == 0):
            return None
        perm, counts = partition_split(self.partition_ids(batch), raw,
                                       self.num_partitions)

        def make_pieces(host_counts) -> List[ColumnarBatch]:
            if host_counts is None:
                host_counts = counts.cpu().numpy()
            out: List[ColumnarBatch] = []
            offset = 0
            for n in np.asarray(host_counts).reshape(-1).tolist():
                if n == 0:
                    out.append(ColumnarBatch.empty(batch.schema,
                                                   batch.device))
                    continue
                cap = bucket(n)
                idx = torch.nn.functional.pad(perm[offset:offset + n],
                                              (0, cap - n))
                live = torch.arange(cap, device=perm.device) < n
                out.append(ColumnarBatch(
                    batch.schema, [K.gather_column(c, idx, out_valid=live)
                                   for c in batch.columns], n))
                offset += n
            return out

        return counts, make_pieces

    def split(self, batch: ColumnarBatch) -> List[ColumnarBatch]:
        """One piece per partition (blocking: the sizing read resolves at
        once)."""
        deferred = self.split_deferred(batch)
        if deferred is None:
            if self.num_partitions == 1:
                return [batch]
            return [ColumnarBatch.empty(batch.schema, batch.device)
                    for _ in range(self.num_partitions)]
        counts, make_pieces = deferred
        return make_pieces(counts.cpu().numpy())


class SinglePartitioner(TpuPartitioner):
    def __init__(self):
        self.num_partitions = 1

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)


class HashPartitioner(TpuPartitioner):
    """pmod(murmur3(keys, seed=42), n): Spark's HashPartitioning (K11)."""

    def __init__(self, num_partitions: int,
                 key_exprs: Sequence[ex.Expression]):
        self.num_partitions = num_partitions
        self.key_exprs = key_exprs

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        cols = [ex.materialize(e.eval(batch), batch) for e in self.key_exprs]
        return hashing.hash_partition_ids(cols, batch.num_rows_raw,
                                          batch.capacity,
                                          self.num_partitions)


class RoundRobinPartitioner(TpuPartitioner):
    """Row i of every batch goes to partition (i + start) mod n."""

    def __init__(self, num_partitions: int, start: int = 0):
        self.num_partitions = num_partitions
        self.start = start

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        idx = torch.arange(batch.capacity, dtype=torch.int32,
                           device=batch.device)
        return torch.remainder(idx + self.start % self.num_partitions,
                               self.num_partitions).to(torch.int32)


class RangePartitioner(TpuPartitioner):
    """Sample-based range partitioning (GpuRangePartitioner): bounds are
    n - 1 evenly spaced rows of the sorted sample; a row goes to the
    partition numbered by the bounds strictly below it (Spark's
    RangePartitioning.getPartition)."""

    def __init__(self, num_partitions: int, orders: List,
                 sample_batches: Sequence[ColumnarBatch]):
        self.num_partitions = num_partitions
        self.orders = orders
        self._sample = list(sample_batches)
        self._bounds: Optional[ColumnarBatch] = None
        self._bounds_done = False

    def bounds(self) -> Optional[ColumnarBatch]:
        """The bound rows (None when the sample is empty or n is 1)."""
        if not self._bounds_done:
            self._bounds = self._compute_bounds()
            self._bounds_done = True
        return self._bounds

    def _compute_bounds(self) -> Optional[ColumnarBatch]:
        from ..plan.physical import concat_batches
        if not self._sample:
            return None
        first = self._sample[0]
        sample = concat_batches(first.schema, self._sample, first.device)
        n = sample.num_rows
        k = self.num_partitions
        if n == 0 or k <= 1:
            return None
        keys = [K.SortKey(ex.materialize(o.child.eval(sample), sample),
                          o.ascending, o.nulls_first) for o in self.orders]
        order = K.sort_indices(keys, n, sample.capacity)
        picks = [min(n - 1, max(0, (i + 1) * n // k)) for i in range(k - 1)]
        idx = order[torch.tensor(picks, dtype=torch.int64,
                                 device=order.device)]
        cap = bucket(len(picks))
        idx = torch.nn.functional.pad(idx, (0, cap - len(picks)))
        live = torch.arange(cap, device=idx.device) < len(picks)
        cols = [K.gather_column(c, idx, out_valid=live)
                for c in sample.columns]
        return ColumnarBatch(sample.schema, cols, len(picks))

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        bounds = self.bounds()
        if bounds is None:
            return torch.zeros(batch.capacity, dtype=torch.int32,
                               device=batch.device)
        bkeys = [ex.materialize(o.child.eval(bounds), bounds)
                 for o in self.orders]
        rkeys = [ex.materialize(o.child.eval(batch), batch)
                 for o in self.orders]
        widths = join_k.pair_widths(bkeys, rkeys)
        bkeys = join_k.widen_keys(bkeys, widths)
        rkeys = join_k.widen_keys(rkeys, widths)
        asc = [o.ascending for o in self.orders]
        nf = [o.nulls_first for o in self.orders]
        b_lanes = K.sort_key_lanes(
            [K.SortKey(c, a, f) for c, a, f in zip(bkeys, asc, nf)],
            bounds.num_rows, bounds.capacity)
        cap = batch.capacity
        r_lanes = K.sort_key_lanes(
            [K.SortKey(c, a, f) for c, a, f in zip(rkeys, asc, nf)],
            cap, cap)
        # lower bound of each row among the sorted bounds = the number of
        # bounds strictly below it (K6's lower-bound mode)
        lo, _, _ = join_k.join_probe(b_lanes, bounds.num_rows, r_lanes, [],
                                     cap, lower_only=True)
        return torch.clamp(lo, 0, self.num_partitions - 1)
