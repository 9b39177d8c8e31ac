"""Mesh-routed physical operators: the port of
spark_rapids_tpu/parallel/mesh_exec.py.

The planner emits these when a mesh is active
(``spark.rapids.tpu.sql.mesh.enabled``): the exchange operators and the
operator above them collapse into one SPMD stage per operator
(parallel/mesh.py), whose shuffle is one all_to_all. Host staging happens
only at the stage boundary: the child's partitions are drained,
concatenated and cut into one shard per worker. Each exec's output is one
partition per worker.

Not ported yet: the reference's exec contracts, spans and metrics
(``exec_contract``, ``trace_span``, ``flight_record``, ``note_plane``;
ROADMAP A13), and the spillable staging under ``shard_for_mesh`` (A8):
the port concatenates on the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import bucket
from ..ops import expressions as ex
from ..ops import kernels as K
from ..plan import logical as lp
from ..plan.physical import (Partition, TpuExec, TpuShuffledJoinExec,
                             bind_refs, concat_batches)
from . import mesh as M

# ops the SPMD group-by merges correctly (first/last are left out: their
# distributed result would depend on the shard order)
MESH_AGG_OPS = ("sum", "count", "count_star", "avg", "min", "max")


def shard_for_mesh(child: TpuExec, n: int) -> List[ColumnarBatch]:
    """Drain the child and cut it into n shards of equal row counts at one
    common capacity; the shards are the per-worker inputs of the stage."""
    batch = concat_batches(child.schema,
                           [b for part in child.execute() for b in part],
                           child.device)
    per = -(-batch.num_rows // n) if batch.num_rows else 0
    cap = bucket(max(per, 1))
    shards = []
    for w in range(n):
        lo = min(w * per, batch.num_rows)
        take = max(0, min(per, batch.num_rows - lo))
        cols = [K.slice_column(c, lo, cap, take) for c in batch.columns]
        shards.append(ColumnarBatch(batch.schema, cols, take))
    return shards


def on_device(batch: ColumnarBatch, device) -> ColumnarBatch:
    """A worker's output batch on the session's device (itself when the
    worker runs there): the operators above a mesh stage run there."""
    if batch.device == device:
        return batch
    return ColumnarBatch.from_flat_arrays(
        batch.schema, [a.to(device) for a in batch.flat_arrays()],
        batch.num_rows_raw)


def _append_eval_columns(batch: ColumnarBatch, exprs: List[ex.Expression]
                         ) -> Tuple[ColumnarBatch, List[int]]:
    """The batch extended with evaluated expression columns; a bound
    reference reuses its column instead of copying it."""
    cols = list(batch.columns)
    fields = list(batch.schema.fields)
    positions = []
    for i, e in enumerate(exprs):
        if isinstance(e, ex.BoundReference):
            positions.append(e.ordinal)
            continue
        c = ex.materialize(e.eval(batch), batch)
        positions.append(len(cols))
        cols.append(c)
        fields.append(dt.Field(f"_mk{i}", c.dtype, True))
    return ColumnarBatch(dt.Schema(fields), cols, batch.num_rows), positions


class TpuMeshGroupByExec(TpuExec):
    """SPMD group-by over the mesh: per-worker partial aggregate ->
    hash-bucketed all_to_all -> merge aggregate
    (mesh.distributed_groupby_fn), or the streaming rounds above
    ``mesh.maxStageBytes`` (``window_rows``). Output: one partition per
    worker, disjoint key ownership."""

    def __init__(self, child: TpuExec, grouping: List[ex.Expression],
                 outputs: List[ex.Expression], mesh,
                 window_rows: Optional[int] = None):
        super().__init__(child)
        self.mesh = mesh
        self.window_rows = window_rows
        self.grouping_src = grouping
        self.grouping = [bind_refs(e, child.schema) for e in grouping]
        self.outputs = outputs
        # each output is a grouping key or an aggregate leaf
        self._spec: List[Tuple[str, int]] = []
        self.agg_leaves: List[lp.AggregateExpression] = []
        for e in outputs:
            inner = e.children[0] if isinstance(e, ex.Alias) else e
            if isinstance(inner, lp.AggregateExpression):
                self._spec.append(("agg", len(self.agg_leaves)))
                self.agg_leaves.append(inner)
            else:
                self._spec.append(("key", _grouping_index(inner, grouping)))
        self.bound_leaf_inputs = [
            bind_refs(l.children[0], child.schema) if l.children else None
            for l in self.agg_leaves]
        self._schema = dt.Schema([
            dt.Field(ex.output_name(e, i), e.dtype, e.nullable)
            for i, e in enumerate(outputs)])

    @property
    def schema(self):
        return self._schema

    @property
    def output_partitions(self) -> int:
        return self.mesh.size

    def execute(self) -> List[Partition]:
        n = self.mesh.size
        shards = shard_for_mesh(self.children[0], n)
        nk = len(self.grouping)
        proj_shards = []
        for shard in shards:
            keys = [ex.materialize(g.eval(shard), shard)
                    for g in self.grouping]
            vals = []
            for bound in self.bound_leaf_inputs:
                if bound is None:              # COUNT(*): any column works
                    vals.append(keys[0])
                else:
                    vals.append(ex.materialize(bound.eval(shard), shard))
            fields = [dt.Field(f"k{i}", c.dtype, True)
                      for i, c in enumerate(keys)]
            fields += [dt.Field(f"v{i}", c.dtype, True)
                       for i, c in enumerate(vals)]
            proj_shards.append(ColumnarBatch(dt.Schema(fields), keys + vals,
                                             shard.num_rows))
        results = M.run_distributed_groupby(
            self.mesh, proj_shards, key_idx=list(range(nk)),
            val_idx=list(range(nk, nk + len(self.agg_leaves))),
            agg_ops=[l.op for l in self.agg_leaves],
            window_rows=self.window_rows)
        out = []
        for r in results:
            # r's columns: k0..k{nk-1}, a0..; in the outputs' order
            cols = [r.columns[idx] if kind == "key" else r.columns[nk + idx]
                    for kind, idx in self._spec]
            out.append(iter([on_device(
                ColumnarBatch(self._schema, cols, r.num_rows), self.device)]))
        return out

    def _node_string(self):
        stream = f" window_rows={self.window_rows}" \
            if self.window_rows is not None else ""
        return f"{self.name}[workers={self.mesh.size}]{stream}"


def _grouping_index(e: ex.Expression, grouping: List[ex.Expression]) -> int:
    for gi, g in enumerate(grouping):
        if e is g or (isinstance(e, ex.ColumnRef) and
                      isinstance(g, ex.ColumnRef) and
                      e.col_name == g.col_name):
            return gi
    raise ValueError(f"output {e!r} is not a grouping expression")


class TpuMeshSortExec(TpuExec):
    """SPMD global sort (mesh.distributed_sort_fn): sample -> all_gather
    bounds -> all_to_all -> local sort. Worker w's partition is the w-th
    key range, sorted."""

    def __init__(self, child: TpuExec, orders: List[lp.SortOrder], mesh):
        super().__init__(child)
        self.mesh = mesh
        self.orders = [lp.SortOrder(bind_refs(o.child, child.schema),
                                    o.ascending, o.nulls_first)
                       for o in orders]

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def output_partitions(self) -> int:
        return self.mesh.size

    def execute(self) -> List[Partition]:
        shards = shard_for_mesh(self.children[0], self.mesh.size)
        n_payload = len(self.schema)
        ext_shards, positions = [], None
        for shard in shards:
            extb, positions = _append_eval_columns(
                shard, [o.child for o in self.orders])
            ext_shards.append(extb)
        results = M.run_distributed_sort(
            self.mesh, ext_shards, positions,
            [o.ascending for o in self.orders],
            [o.nulls_first for o in self.orders])
        return [iter([on_device(ColumnarBatch(
            self.schema, r.columns[:n_payload], r.num_rows), self.device)])
            for r in results]

    def _node_string(self):
        return f"{self.name}[workers={self.mesh.size}]"


class TpuMeshJoinExec(TpuShuffledJoinExec):
    """SPMD shuffled join: both sides co-partitioned by one all_to_all each
    (mesh.copartition_exchange_fn), then each worker's pair of shards runs
    the shuffled join's per-partition join. A full outer join is right per
    worker: co-partitioning makes key ownership disjoint."""

    def __init__(self, left: TpuExec, right: TpuExec, how: str,
                 left_keys, right_keys, condition, mesh,
                 part_left_keys=None, part_right_keys=None):
        super().__init__(left, right, how, left_keys, right_keys, condition)
        self.mesh = mesh
        # partitioning keys may carry promotion casts so both sides hash
        # one type; they default to the join keys
        self.part_left_keys = [bind_refs(e, left.schema)
                               for e in (part_left_keys or left_keys)]
        self.part_right_keys = [bind_refs(e, right.schema)
                                for e in (part_right_keys or right_keys)]

    @property
    def output_partitions(self) -> int:
        return self.mesh.size

    def children_coalesce_goal(self, i: int):
        # the sort-merge join's goals, as in the reference (the children
        # are the sides themselves, not exchanges)
        return "target" if i == 0 else "single"

    def _copartition(self, child: TpuExec, part_keys) -> List[ColumnarBatch]:
        shards = shard_for_mesh(child, self.mesh.size)
        n_payload = len(child.schema)
        ext, positions = [], None
        for shard in shards:
            extb, positions = _append_eval_columns(shard, part_keys)
            ext.append(extb)
        co = M.run_copartition_exchange(self.mesh, ext, positions)
        # the per-worker joins run on the session's device
        return [on_device(ColumnarBatch(child.schema, b.columns[:n_payload],
                                        b.num_rows), self.device)
                for b in co]

    def execute(self) -> List[Partition]:
        l_co = self._copartition(self.children[0], self.part_left_keys)
        r_co = self._copartition(self.children[1], self.part_right_keys)
        return [self._join_copart(iter([lb]), iter([rb]))
                for lb, rb in zip(l_co, r_co)]

    def _node_string(self):
        return f"{super()._node_string()}[workers={self.mesh.size}]"
