"""Exchanges: the port of spark_rapids_tpu/shuffle/exchange.py (the local,
in-process form: ``LocalShuffle``, the shuffle, hash, range and broadcast
exchanges).

A shuffle exchange's map side splits every upstream batch with a
partitioner (K11 hash ids or range/round-robin ids, K12 split) and keeps
the pieces per reduce partition; the reduce side reads each partition as
one concatenated batch. The split's sizing read (its per-partition counts)
is parked on a PipelineWindow at ``spark.rapids.tpu.sql.shuffle.pipelineDepth``,
so a map phase of B batches reads its counts in about 2B/depth batched
copies instead of B.

With a mesh active (parallel/mesh.py) a shuffle or hash exchange may take
the ICI plane instead (``spark.rapids.tpu.sql.shuffle.plane``): the child
is cut into one shard per worker, every row goes to the worker owning its
reduce partition (partition ``p`` on worker ``p % n``) in one all_to_all,
and each worker's rows come back ordered by partition, so a partition is
one slice of its owner's rows. The counts are the exchange's one read. A
forced ``ici`` that cannot run raises; ``auto`` takes the local split
without a mesh, for one partition, or for nested columns. (The
reference's multi-process workers and its mesh-loss fault, which fall
back to its DCN plane, are not ported.)

There are no spill tiers yet: every piece stays on the device until its
partition is read (then the reduce side holds it) or the exchange is
released. Map tasks drain one upstream partition after another (the
reference runs them on exec/tasks.py's thread pool). There is no adaptive
coalescing or skew split: one reduce partition per output partition.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch, resolve_counts
from ..columnar.column import bucket
from ..exec.pipeline import PipelineWindow
from ..ops import expressions as ex
from ..ops import kernels as K
from ..plan import logical as lp
from ..plan import physical as ph
from .partitioning import (HashPartitioner, RangePartitioner,
                           RoundRobinPartitioner, SinglePartitioner,
                           TpuPartitioner)


class LocalShuffle:
    """In-process shuffle state of one exchange: reduce partition -> the
    map side's pieces for it, in map order."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        self.slices: Dict[int, List[ColumnarBatch]] = {
            p: [] for p in range(num_partitions)}

    def _keep(self, pieces: List[ColumnarBatch]) -> None:
        for p, piece in enumerate(pieces):
            if piece.num_rows > 0:
                self.slices[p].append(piece)

    def write(self, partitioner: TpuPartitioner, batch: ColumnarBatch
              ) -> None:
        self._keep(partitioner.split(batch))

    def write_deferred(self, window: PipelineWindow,
                       partitioner: TpuPartitioner,
                       batch: ColumnarBatch) -> None:
        """Launch the split now, park its counts on ``window`` and keep
        the pieces when the window lands them."""
        deferred = partitioner.split_deferred(batch)
        if deferred is None:
            self.write(partitioner, batch)
            return
        counts, make_pieces = deferred
        window.push(lambda host: self._keep(make_pieces(host)), counts)

    def read(self, p: int, schema: dt.Schema, device) -> ph.Partition:
        """Reduce partition ``p`` as one batch (nothing when it is empty);
        the pieces are released as they are read."""
        pieces, self.slices[p] = self.slices[p], []
        if pieces:
            yield ph.concat_batches(schema, pieces, device)

    def close_pending(self) -> None:
        """Release the pieces never read."""
        for p in self.slices:
            self.slices[p] = []


class TpuShuffleExchangeExec(ph.TpuExec):
    """repartition(n) / repartition(n, cols): round-robin, hash (on
    ``by``) or, for one partition, single."""

    def __init__(self, child: ph.TpuExec, num_partitions: int,
                 by: Optional[List[ex.Expression]] = None,
                 split_depth: int = 8, plane: str = "auto", mesh=None):
        super().__init__(child)
        self.num_partitions = max(1, int(num_partitions))
        self.by = [ph.bind_refs(e, child.schema) for e in by] if by else None
        self.split_depth = split_depth
        self.plane = plane
        self.mesh = mesh
        self._shuffle: Optional[LocalShuffle] = None
        self._ici_results = None
        # the map phase's last window (its batched count reads)
        self.window: Optional[PipelineWindow] = None

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def output_partitions(self) -> int:
        return self.num_partitions

    def _make_partitioner(self) -> TpuPartitioner:
        if self.num_partitions == 1:
            return SinglePartitioner()
        if self.by:
            return HashPartitioner(self.num_partitions, self.by)
        return RoundRobinPartitioner(self.num_partitions)

    def _run_map_phase(self, shuffle: LocalShuffle) -> None:
        """Split every upstream batch, one upstream partition after
        another, each on its own window."""
        partitioner = self._make_partitioner()
        for part in self.children[0].execute():
            win = self.window = PipelineWindow(self.split_depth)
            for batch in part:
                shuffle.write_deferred(win, partitioner, batch)
            win.flush()

    @staticmethod
    def _reduce_groups(shuffle: LocalShuffle) -> List[List[int]]:
        """Reduce partitions read together: one each (no adaptive
        coalescing)."""
        return [[p] for p in range(shuffle.num_partitions)]

    # -- plane routing -------------------------------------------------------

    def _ici_capable(self) -> bool:
        """The ICI exchange carries flat primitive and string columns;
        nested layouts stay on the local split."""
        return all(not f.dtype.var_width or f.dtype == dt.STRING
                   for f in self.schema)

    def _resolve_plane(self) -> str:
        """'ici' or 'dcn' for this execution. ``auto`` takes the mesh
        exactly when the planner handed one over and the shape qualifies;
        a forced ``ici`` that cannot run raises, never downgrades."""
        plane = (self.plane or "auto").lower()
        if plane == "dcn":
            return "dcn"
        forced = plane == "ici"
        if self.mesh is None or self.mesh.size < 2:
            if forced:
                raise RuntimeError(
                    "spark.rapids.tpu.sql.shuffle.plane=ici but no mesh is "
                    "active (spark.rapids.tpu.sql.mesh.enabled)")
            return "dcn"
        if self.num_partitions == 1:
            return "dcn"          # a single sink: nothing to exchange
        if not self._ici_capable():
            if forced:
                raise RuntimeError(
                    "spark.rapids.tpu.sql.shuffle.plane=ici but the "
                    f"exchange schema [{self.schema}] carries nested "
                    "columns the mesh's exchange cannot move")
            return "dcn"
        return "ici"

    def would_use_ici(self) -> bool:
        """The plane this exchange takes if executed now."""
        return self._resolve_plane() == "ici"

    def _execute_ici(self) -> List[ph.Partition]:
        """Device exchange over the mesh: shard the child, route every row
        to its reduce partition's owner in one all_to_all, and slice each
        worker's partition-sorted rows into the partitions it owns. The
        one read is the [n, num_partitions] counts."""
        from ..parallel import mesh as M
        from ..parallel.mesh_exec import on_device, shard_for_mesh
        n = self.mesh.size
        shards = shard_for_mesh(self.children[0], n)
        partitioner = self._make_partitioner()
        pids = [partitioner.partition_ids(s) for s in shards]
        self._ici_results = M.run_partition_exchange(
            self.mesh, shards, pids, self.num_partitions)

        def gen(p: int) -> ph.Partition:
            cols_w, counts_w = self._ici_results[p % n]
            count = int(counts_w[p])
            if count <= 0:
                return
            offset = int(counts_w[:p].sum())
            pcap = bucket(count)
            cols = [K.slice_column(c, offset, pcap, count) for c in cols_w]
            yield on_device(ColumnarBatch(self.schema, cols, count),
                            self.device)

        return [gen(p) for p in range(self.num_partitions)]

    def execute(self) -> List[ph.Partition]:
        """Runs the map phase now; the partitions read lazily."""
        self.release()
        if self._resolve_plane() == "ici":
            return self._execute_ici()
        shuffle = self._shuffle = LocalShuffle(self.num_partitions)
        self._run_map_phase(shuffle)
        return [self._read_group(shuffle, g)
                for g in self._reduce_groups(shuffle)]

    def _read_group(self, shuffle: LocalShuffle, group: List[int]
                    ) -> ph.Partition:
        for p in group:
            yield from shuffle.read(p, self.schema, self.device)

    def release(self) -> None:
        """Drop the pieces no consumer read."""
        self._ici_results = None
        if self._shuffle is not None:
            self._shuffle.close_pending()
            self._shuffle = None

    def _node_string(self):
        if self.mesh is None:
            return self.name
        return f"{self.name}[plane={self.plane}, workers={self.mesh.size}]"


class TpuHashExchangeExec(TpuShuffleExchangeExec):
    """Hash exchange on keys: the two sides of a shuffled join, and the
    partial -> final step of a grouped aggregate."""

    def __init__(self, child: ph.TpuExec, num_partitions: int,
                 keys: List[ex.Expression], split_depth: int = 8,
                 plane: str = "auto", mesh=None):
        super().__init__(child, num_partitions, by=keys,
                         split_depth=split_depth, plane=plane, mesh=mesh)


class TpuRangeExchangeExec(ph.TpuExec):
    """Range exchange under a distributed sort (GpuRangePartitioning):
    sample every upstream batch, take ordered bound rows, send each row to
    the partition owning its key range. Partition i holds keys below
    partition i + 1's, so per-partition sorts make a total order."""

    SAMPLE_TARGET_PER_PARTITION = 100

    def __init__(self, child: ph.TpuExec, num_partitions: int,
                 orders: List[lp.SortOrder], split_depth: int = 8):
        super().__init__(child)
        self.num_partitions = max(1, int(num_partitions))
        self.orders = [lp.SortOrder(ph.bind_refs(o.child, child.schema),
                                    o.ascending, o.nulls_first)
                       for o in orders]
        self.split_depth = split_depth
        self._shuffle: Optional[LocalShuffle] = None

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def output_partitions(self) -> int:
        return self.num_partitions

    @staticmethod
    def _sample(batch: ColumnarBatch, k: int) -> ColumnarBatch:
        """Up to ``k`` rows of the batch, chosen as the reference chooses
        them (numpy ``default_rng(42 + rows)``), in row order."""
        n = batch.num_rows
        take = min(n, k)
        rng = np.random.default_rng(42 + n)
        idx = np.sort(rng.choice(n, size=take, replace=False))
        cap = bucket(take)
        idx_t = torch.zeros(cap, dtype=torch.int64, device=batch.device)
        idx_t[:take] = torch.from_numpy(idx.astype(np.int64)).to(
            batch.device)
        live = torch.arange(cap, device=batch.device) < take
        cols = [K.gather_column(c, idx_t, out_valid=live)
                for c in batch.columns]
        return ColumnarBatch(batch.schema, cols, take)

    def execute(self) -> List[ph.Partition]:
        self.release()
        batches = [b for part in self.children[0].execute() for b in part]
        resolve_counts(batches)
        batches = [b for b in batches if b.num_rows > 0]
        if not batches:
            return [iter(()) for _ in range(self.num_partitions)]
        target = self.SAMPLE_TARGET_PER_PARTITION * self.num_partitions
        per_batch = max(8, -(-target // len(batches)))
        samples = [self._sample(b, per_batch) for b in batches]
        partitioner = RangePartitioner(self.num_partitions, self.orders,
                                       samples)
        shuffle = self._shuffle = LocalShuffle(self.num_partitions)
        win = PipelineWindow(self.split_depth)
        for b in batches:
            shuffle.write_deferred(win, partitioner, b)
        win.flush()
        return [shuffle.read(p, self.schema, self.device)
                for p in range(self.num_partitions)]

    def release(self) -> None:
        if self._shuffle is not None:
            self._shuffle.close_pending()
            self._shuffle = None


class TpuBroadcastExchangeExec(ph.TpuExec):
    """Collect the child once into a single batch shared by every
    consumer partition. The batch stays on the device until the join
    releases it at the end of its streams."""

    def __init__(self, child: ph.TpuExec):
        super().__init__(child)
        self._batch: Optional[ColumnarBatch] = None

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def output_partitions(self) -> int:
        return 1

    def materialize(self) -> ColumnarBatch:
        """Build (once) and return the broadcast batch."""
        if self._batch is None:
            batches = [b for part in self.children[0].execute()
                       for b in part]
            self._batch = ph.concat_batches(self.schema, batches,
                                            self.device)
        return self._batch

    def release(self) -> None:
        """Drop the batch once its consumer is done with it, so a finished
        plan holds no device memory."""
        self._batch = None

    def execute(self) -> List[ph.Partition]:
        return [iter([self.materialize()])]
