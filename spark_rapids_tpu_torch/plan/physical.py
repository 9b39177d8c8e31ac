"""Physical columnar operators: the port of the main-path execs of
spark_rapids_tpu/plan/physical.py.

An exec's ``execute()`` returns a list of partitions, each an iterator of
:class:`ColumnarBatch`; ``output_partitions`` says how many, with the
reference's rules. A scan is one partition; exchanges
(shuffle/exchange.py) make more. The aggregate runs in the reference's
modes: ``complete`` (one node sees every row of its groups), ``partial``
(per partition, below a hash exchange) and ``final`` (the merge and result
projection, per partition above the exchange). A batch's update carries
the folded filter/project chain as a live mask; pending partials merge in
fan-in groups. Where the planner attached a generated kernel
(plan/stage_compiler.generate_kernels), a CUDA batch's project, filter or
update inputs come from one K19 ``fused_stage`` launch, and a
grouping-free update is one K20 ``fused_reduce`` launch plus K1's fold
per aggregate; on the CPU the same units run their eager torch ops.
Grouping-free input takes the reduce route (K1 per
aggregate); grouped input goes through ops/aggregates.groupby_aggregate_fast,
which picks the dense route (K8 stats, K9) or the sort route (K2 + stable
sort, K3, then K4 or K9). Update batches ride a PipelineWindow: each
batch's stats read lands with its half-window peers in one copy.
Filters compact through K5. The equi-joins sort their build side once per
partition (K2), probe it per stream batch (K6) and expand the pairs (K7):
:class:`TpuSortMergeJoinExec` over a broadcast build,
:class:`TpuShuffledJoinExec` over co-partitioned (hash-exchanged) sides.
Partials are plain device tensors. Failures propagate: nothing falls back
to another engine or device.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterable, Iterator, List, Optional, Set

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch, resolve_counts
from ..columnar.column import Column, Scalar, bucket
from ..exec.pipeline import PipelineWindow
from ..ops import aggregates as agg_k
from ..ops import arrays as ar_ops
from ..ops import expressions as ex
from ..ops import joins as join_k
from ..ops import kernels as K
from ..ops.cast import Cast
from . import logical as lp
from . import stage_codegen as sg

Partition = Iterator[ColumnarBatch]


def bind_refs(e: ex.Expression, schema: dt.Schema) -> ex.Expression:
    def fn(node):
        if isinstance(node, ex.ColumnRef):
            i = schema.index_of(node.col_name)
            f = schema[i]
            return ex.BoundReference(i, f.dtype, f.nullable, f.name)
        return None
    return e.transform(fn)


def concat_batches(schema: dt.Schema, batches: List[ColumnarBatch],
                   device) -> ColumnarBatch:
    """One batch holding every row of ``batches`` (counts read in one
    device -> host copy), capacity bucket(total)."""
    resolve_counts(batches)
    batches = [b for b in batches if b.num_rows > 0]
    if not batches:
        return ColumnarBatch.empty(schema, device)
    if len(batches) == 1:
        return batches[0]
    counts = [b.num_rows for b in batches]
    cap = bucket(sum(counts))
    cols = [K.concat_columns([b.columns[i] for b in batches], counts, cap)
            for i in range(len(schema))]
    return ColumnarBatch(schema, cols, sum(counts))


class TpuExec:
    """Base physical operator."""

    def __init__(self, *children: "TpuExec"):
        self.children = list(children)

    @property
    def schema(self) -> dt.Schema:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.children[0].device

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def output_partitions(self) -> int:
        """How many partitions ``execute`` returns: the planner adds an
        exchange where an operator needs its input partitioned."""
        return self.children[0].output_partitions if self.children else 1

    def children_coalesce_goal(self, i: int):
        """None, "target" (concat small batches toward the batch size) or
        "single" (the whole partition in one batch)."""
        return None

    def execute(self) -> List[Partition]:
        raise NotImplementedError

    def release(self) -> None:
        """Drop device state held past ``execute`` (an exchange's pieces
        no consumer read); the session calls it on every node once a
        query ends."""

    def execute_collect(self) -> ColumnarBatch:
        """Every partition's rows in one device batch."""
        batches = [b for part in self.execute() for b in part]
        return concat_batches(self.schema, batches, self.device)

    def tree_string(self, depth: int = 0) -> str:
        out = "  " * depth + self._node_string()
        for c in self.children:
            out += "\n" + c.tree_string(depth + 1)
        return out

    def operator_tree(self, depth: int = 0) -> str:
        """The operators' names, one a line, two spaces a level: the form
        of the JAX package's plan string, so two plans compare."""
        return "\n".join(["  " * depth + self.name] +
                         [c.operator_tree(depth + 1) for c in self.children])

    def _node_string(self) -> str:
        return self.name

    def __repr__(self):
        return self.tree_string()


class ScanCache:
    """Device copies of scanned columns, reused across queries. An entry is
    one column of one base table cut into ``batch_rows``-row batches, keyed
    by (base table, column name, batch rows, device), so a column that
    several queries read is on the device once. ``max_bytes`` caps the
    total. Entries go when their base table is garbage collected.

    The columns one scan uploads share their batches' device buffers, so
    they form one group: a group is cached, reused and evicted whole. When
    a put does not fit, the least recently used groups holding no column
    :meth:`pin`-ned by the running query are evicted until it does (the
    reference spills cache entries instead; the port has no spill tier
    yet); if that is not enough the put is refused.

    ``uploads`` counts the column batches scans had to upload, ``refused``
    the puts that did not fit, ``evicted`` the column entries evicted: a
    scan served from the cache bumps none of them."""

    # 12 GiB holds every column TPC-H's main path scans at SF 10 on an
    # 80 GB card: q7, q8 and q9 read every lineitem column (their
    # withColumn references them all, and scans are pruned by name, as
    # in the reference)
    def __init__(self, max_bytes: int = 12 << 30):
        self.max_bytes = max_bytes
        self.bytes = 0
        self.uploads = 0
        self.refused = 0
        self.evicted = 0
        self._entries: Dict[tuple, List[Column]] = {}
        # group id -> (its keys, its bytes), least recently used first
        self._groups: "OrderedDict[int, tuple]" = OrderedDict()
        self._group_of: Dict[tuple, int] = {}
        self._next_group = 0
        self._pinned: Set[tuple] = set()
        self._watched: set = set()

    def pin(self, keys: Iterable[tuple]) -> None:
        """The entries the running query reads: never evicted while it
        runs. Replaces the previous pin set."""
        self._pinned = set(keys)

    def get(self, key: tuple) -> Optional[List[Column]]:
        cols = self._entries.get(key)
        if cols is not None:
            self._groups.move_to_end(self._group_of[key])
        return cols

    def put_all(self, entries: Dict[tuple, List[Column]],
                table: lp.HostTable) -> bool:
        """Cache every entry, as one group, or none."""
        size = sum(c.device_size_bytes() for cols in entries.values()
                   for c in cols)
        if any(k in self._entries for k in entries) or \
                not self._make_room(size):
            self.refused += 1
            return False
        gid = self._next_group
        self._next_group += 1
        self._groups[gid] = (tuple(entries), size)
        for k in entries:
            self._group_of[k] = gid
        self._entries.update(entries)
        self.bytes += size
        tid = id(table)
        if tid not in self._watched:
            self._watched.add(tid)
            weakref.finalize(table, self._evict_table, tid)
        return True

    def _make_room(self, size: int) -> bool:
        need = self.bytes + size - self.max_bytes
        if need <= 0:
            return True
        victims, freed = [], 0
        for gid, (keys, gsize) in self._groups.items():
            if freed >= need:
                break
            if not self._pinned.intersection(keys):
                victims.append(gid)
                freed += gsize
        if freed < need:
            return False
        for gid in victims:
            self.evicted += len(self._groups[gid][0])
            self._drop_group(gid)
        return True

    def _drop_group(self, gid: int) -> None:
        keys, size = self._groups.pop(gid)
        for k in keys:
            del self._entries[k]
            del self._group_of[k]
        self.bytes -= size

    def _evict_table(self, tid: int) -> None:
        self._watched.discard(tid)
        for gid in [g for g, (keys, _) in self._groups.items()
                    if keys[0][0] == tid]:
            self._drop_group(gid)


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class TpuLocalScanExec(TpuExec):
    """In-memory table scan -> device batches of ``batch_rows`` rows. The
    columns missing from ``cache`` go up in one pinned copy per batch and
    are cached for later queries over the same table; cached columns are
    reused as they are."""

    def __init__(self, table: lp.HostTable, schema: dt.Schema, device,
                 batch_rows: int = 1 << 20,
                 cache: Optional[ScanCache] = None):
        super().__init__()
        self.table = table
        self._schema = schema
        self._device = torch.device(device)
        self.batch_rows = batch_rows
        self.cache = cache

    @property
    def schema(self):
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def execute(self) -> List[Partition]:
        return [self._part()]

    def cache_keys(self) -> Dict[str, tuple]:
        """The scan cache key of each column this scan reads."""
        return {n: (id(self.table.base), n, self.batch_rows,
                    str(self._device)) for n in self._schema.names()}

    def _part(self) -> Partition:
        names = self._schema.names()
        keys = self.cache_keys()
        cached = {n: self.cache.get(keys[n]) for n in names} \
            if self.cache is not None else {}
        missing = [n for n in names if cached.get(n) is None]
        upload = self.table.select(missing)
        made: Dict[str, List[Column]] = {n: [] for n in missing}
        n_rows = self.table.num_rows
        for i, lo in enumerate(range(0, n_rows, self.batch_rows)):
            rows = min(self.batch_rows, n_rows - lo)
            cols = {n: c[i] for n, c in cached.items() if c is not None}
            if missing:
                hosts = upload.host_arrays(lo, rows, bucket(rows))
                up = ColumnarBatch.upload(upload.schema, hosts, rows,
                                          self._device)
                for n, c in zip(missing, up.columns):
                    made[n].append(c)
                    cols[n] = c
                if self.cache is not None:
                    self.cache.uploads += len(missing)
            yield ColumnarBatch(self._schema, [cols[n] for n in names], rows)
        if self.cache is not None and missing:
            self.cache.put_all({keys[n]: made[n] for n in missing},
                               self.table.base)

    def _node_string(self):
        return f"TpuLocalScanExec [{', '.join(self._schema.names())}]"


# ---------------------------------------------------------------------------
# Project / Filter / Coalesce
# ---------------------------------------------------------------------------

def on_card(batch: ColumnarBatch) -> bool:
    """Whether a fused unit launches its generated kernel on ``batch``: a
    CUDA batch does; a CPU batch runs the eager ops, the kernels' plain
    version."""
    return batch.device.type == "cuda"


class FusedStage:
    """A project's or a filter's bound expressions as one generated kernel
    (K19, plan/stage_codegen.py): the reference's FusedStage
    (physical.py:710). Compiled kernels are cached per process by the
    hash of their source (native.generated_kernel), so every query with
    the same expression shapes shares one, whatever its literals.
    ``project``: the output columns; ``filter``: the input columns
    compacted (K5) where the condition holds, with the count on the
    device."""

    def __init__(self, kernel: "sg.StageKernel", mode: str):
        self.kernel = kernel
        self.mode = mode

    def __call__(self, batch: ColumnarBatch, schema: dt.Schema
                 ) -> ColumnarBatch:
        outs, mask = self.kernel.launch(batch)
        if self.mode == "project":
            return ColumnarBatch(schema, outs, batch.num_rows_raw)
        cols, count = K.compact_columns(batch.columns, mask)
        return ColumnarBatch(schema, cols, count)


class TpuProjectExec(TpuExec):
    def __init__(self, child: TpuExec, exprs: List[ex.Expression]):
        super().__init__(child)
        self.exprs = [bind_refs(e, child.schema) for e in exprs]
        self._schema = dt.Schema([
            dt.Field(ex.output_name(e, i), e.dtype, e.nullable)
            for i, e in enumerate(exprs)])
        self.kernel: Optional[sg.StageKernel] = None   # planner-attached

    @property
    def schema(self):
        return self._schema

    def execute(self) -> List[Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: Partition) -> Partition:
        fused = FusedStage(self.kernel, "project") \
            if self.kernel is not None else None
        for batch in part:
            if fused is not None and on_card(batch):
                yield fused(batch, self._schema)
                continue
            cols = [ex.materialize(e.eval(batch), batch) for e in self.exprs]
            yield ColumnarBatch(self._schema, cols, batch.num_rows_raw)


def filter_batch(condition: ex.Expression, batch: ColumnarBatch
                 ) -> Optional[ColumnarBatch]:
    """The rows of ``batch`` where the bound ``condition`` holds, compacted
    to the front through K5 (None when a constant condition drops them
    all); the count stays on the device."""
    pred = condition.eval(batch)
    if isinstance(pred, Scalar):
        return batch if pred.value is True else None
    keep = pred.data & pred.validity & batch.row_mask_raw()
    cols, count = K.compact_columns(batch.columns, keep)
    return ColumnarBatch(batch.schema, cols, count)


class TpuFilterExec(TpuExec):
    """Filter by compaction (K5); the count stays on the device."""

    def __init__(self, child: TpuExec, condition: ex.Expression):
        super().__init__(child)
        self.condition = bind_refs(condition, child.schema)
        self._schema = child.schema
        self.kernel: Optional[sg.StageKernel] = None   # planner-attached

    @property
    def schema(self):
        return self._schema

    def execute(self) -> List[Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: Partition) -> Partition:
        fused = FusedStage(self.kernel, "filter") \
            if self.kernel is not None else None
        for batch in part:
            if fused is not None and on_card(batch):
                yield fused(batch, self._schema)
                continue
            out = filter_batch(self.condition, batch)
            if out is not None:
                yield out


class TpuCoalesceBatchesExec(TpuExec):
    """Concatenate batches up to a goal: "single" (the whole partition) or
    "target" (at least ``target_rows`` rows per output batch)."""

    def __init__(self, child: TpuExec, goal: Any = "single",
                 target_rows: int = 1 << 20):
        super().__init__(child)
        self.goal = goal
        self.target_rows = target_rows

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self) -> List[Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: Partition) -> Partition:
        pending: List[ColumnarBatch] = []
        rows = 0
        for batch in part:
            resolve_counts([batch])
            if batch.num_rows == 0:
                continue
            pending.append(batch)
            rows += batch.num_rows
            if self.goal != "single" and rows >= self.target_rows:
                yield concat_batches(self.schema, pending, self.device)
                pending, rows = [], 0
        if pending:
            yield concat_batches(self.schema, pending, self.device)


# ---------------------------------------------------------------------------
# Aggregate
# ---------------------------------------------------------------------------

class TpuHashAggregateExec(TpuExec):
    """Group-by aggregate. ``mode``: ``complete`` (every partition's rows
    stream into one update/merge/final), ``partial`` (update and merge per
    partition, output in the partial schema: keys ``_k{i}`` then each
    leaf's update columns) or ``final`` (merge and result projection of
    partial-schema input; ``per_partition_final`` when the input is hash
    partitioned on the keys, so each partition holds whole groups).
    ``pre_stage`` is the filter/project chain the planner folded into an
    update (stage_compiler.StageChain). ``allow_matmul`` turns on the K9
    reductions (the dense route and the few-groups sort route);
    ``pipeline_depth`` is the update window's depth."""

    # pending partials merge in groups of this many (one merge per batch
    # would run a merge aggregation per input batch)
    MERGE_FAN_IN = 8

    def __init__(self, child: TpuExec, grouping: List[ex.Expression],
                 aggregate_exprs: List[ex.Expression], pre_stage=None,
                 allow_matmul: bool = False, pipeline_depth: int = 8,
                 mode: str = "complete", per_partition_final: bool = False):
        super().__init__(child)
        self.mode = mode
        self.per_partition_final = per_partition_final
        self.allow_matmul = allow_matmul
        self.pipeline_depth = pipeline_depth
        # groupby_aggregate_fast's memo: off once a key span rules the
        # dense route out (key domains are stable across a stream)
        self._dense_state: Dict[str, bool] = {}
        self.window: Optional[PipelineWindow] = None   # the last stream's
        self.pre_stage = pre_stage
        # the update's generated kernel (K19 prologue or K20), attached by
        # the planner (stage_compiler.generate_kernels)
        self.kernel: Optional[sg.StageKernel] = None
        self.grouping_src = grouping
        self.aggregate_exprs = aggregate_exprs
        self.leaves: List[lp.AggregateExpression] = []
        for e in aggregate_exprs:
            self.leaves.extend(
                e.collect(lambda x: isinstance(x, lp.AggregateExpression)))
        if mode == "final":
            # the child emits the partial schema: keys then update columns,
            # by position (the original names do not exist below)
            self.grouping = [ex.BoundReference(i, g.dtype, True)
                             for i, g in enumerate(grouping)]
            self.bound_leaf_inputs = [None] * len(self.leaves)
        else:
            in_schema = pre_stage.out_schema if pre_stage is not None \
                else child.schema
            self.grouping = [bind_refs(e, in_schema) for e in grouping]
            self.bound_leaf_inputs = [
                bind_refs(l.children[0], in_schema) if l.children else None
                for l in self.leaves]
        self._out_schema = self._partial_schema() if mode == "partial" \
            else dt.Schema([dt.Field(ex.output_name(e, i), e.dtype,
                                     e.nullable)
                            for i, e in enumerate(aggregate_exprs)])

    def _partial_schema(self) -> dt.Schema:
        """Keys, then the update columns of each leaf."""
        fields = [dt.Field(f"_k{i}", g.dtype, True)
                  for i, g in enumerate(self.grouping_src)]
        for i, l in enumerate(self.leaves):
            for j, (_op, t) in enumerate(self._update_cols(l)):
                fields.append(dt.Field(f"_a{i}_{j}", t, True))
        return dt.Schema(fields)

    def _update_cols(self, leaf: lp.AggregateExpression):
        """(op, dtype) of one leaf's update outputs (avg = sum + count)."""
        t = leaf.children[0].dtype if leaf.children else None
        if leaf.op == "avg":
            return [("sum", dt.FLOAT64), ("count", dt.INT64)]
        if leaf.op in ("count", "count_star"):
            return [(leaf.op, dt.INT64)]
        return [(leaf.op, agg_k.result_dtype(leaf.op, t))]

    def _merge_ops(self, leaf: lp.AggregateExpression):
        if leaf.op == "avg":
            return ["sum", "sum"]
        if leaf.op in ("count", "count_star"):
            return ["sum"]
        return [leaf.op]

    @property
    def schema(self):
        return self._out_schema

    def children_coalesce_goal(self, i: int):
        return "target"

    @property
    def output_partitions(self) -> int:
        if self.mode == "partial" or self.per_partition_final:
            return self.children[0].output_partitions
        return 1

    def execute(self) -> List[Partition]:
        parts = self.children[0].execute()
        if self.mode == "partial" or self.per_partition_final:
            return [self._stream_merge(p) for p in parts]

        def stream():
            for p in parts:
                yield from p
        return [self._stream_merge(stream())]

    def dense_candidate(self) -> bool:
        """Whether an update batch may take the dense route: one integral
        key and specs it supports (the reference's dense_cand)."""
        if self.mode == "final":
            return False
        sig = []
        for leaf, bound in zip(self.leaves, self.bound_leaf_inputs):
            t = bound.dtype if bound is not None else None
            sig += [("sum", dt.FLOAT64), ("count", t)] \
                if leaf.op == "avg" else [(leaf.op, t)]
        return (self.allow_matmul and len(self.grouping) == 1 and
                self._dense_state.get("enabled", True) and
                agg_k.dense_key_type(self.grouping[0].dtype) and
                all(agg_k.dense_op_supported(op, t) for op, t in sig))

    def _stream_merge(self, batches) -> Partition:
        """Per-batch update (``final`` mode: the input batches are already
        partials), pending partials merged in fan-in groups, then the final
        merge and projection (``partial`` mode: the merged partial as it
        is). The update is pipelined on a PipelineWindow: a batch's device
        half (the dense route's K8 stats, or the sort route's sort and
        group finding) runs at once and its stats vector is parked on the
        window; the host half runs when the window lands it, its read
        batched with its half-window peers."""
        pschema = self._partial_schema()
        pending: List[ColumnarBatch] = []

        def bank(pb: ColumnarBatch) -> None:
            pending.append(pb)
            if len(pending) >= self.MERGE_FAN_IN:
                pending[:] = [self._merge(pending)]

        win = self.window = PipelineWindow(self.pipeline_depth)
        for batch in batches:
            if self.mode == "final":
                ready = win.push(lambda b=batch: b)
            elif not self.grouping:
                pb = self._update(batch)
                ready = win.push(lambda p=pb: p)
            else:
                tok, stats = self._update_dispatch(batch)
                ready = win.push(
                    lambda v, t=tok, d=stats: self._update_finish(t, v, d),
                    stats)
            for pb in ready:
                bank(pb)
        for pb in win.flush():
            bank(pb)
        if not pending:
            final_in = ColumnarBatch.empty(pschema, self.device)
        elif len(pending) == 1:
            final_in = pending[0]
        else:
            final_in = self._merge(pending)
        yield final_in if self.mode == "partial" else self._final(final_in)

    # -- update (per input batch) -----------------------------------------
    def update_unit(self):
        """The update as a fused unit over the child's schema: (label,
        mode, in_schema, filters, outputs, specs) for the generator. A
        grouped update's outputs are its keys, then each leaf's input (the
        K19 prologue); a grouping-free update's specs are K20's."""
        in_schema = self.children[0].schema
        filters, cur = sg.inline_chain(self.pre_stage, in_schema)
        stage = getattr(self, "_fusion_stage", None)
        label = f"stage #{stage}" if stage is not None else "update"
        inputs = [None if b is None else sg.Materialize(sg.inline(b, cur))
                  for b in self.bound_leaf_inputs]
        if self.grouping:
            # one output per distinct column: leaves (and keys) that read
            # the same chain column share it, as they share it eagerly
            outputs, slot = [], {}

            def slot_of(e):
                k = id(e.children[0])
                if k not in slot:
                    slot[k] = len(outputs)
                    outputs.append(e)
                return slot[k]
            keys = [slot_of(sg.Materialize(sg.inline(g, cur)))
                    for g in self.grouping]
            leaves = [None if e is None else slot_of(e) for e in inputs]
            self._prologue_slots = (keys, leaves)
            return (label, "stage", in_schema, filters, outputs, ())
        specs = []
        for leaf, e in zip(self.leaves, inputs):
            for op, _t in self._update_cols(leaf):
                if leaf.op == "avg" and op == "sum" and \
                        e.dtype != dt.FLOAT64:
                    specs.append((op, Cast(e, dt.FLOAT64), True))
                else:
                    specs.append((op, e, leaf.ignore_nulls))
        return (label, "reduce", in_schema, filters, [], specs)

    def eager_update_inputs(self, batch: ColumnarBatch):
        """(keys, each leaf's input column or None, live mask or None):
        the folded chain and the update's inputs by the eager torch ops,
        the plain version of the generated prologue."""
        mask = None
        if self.pre_stage is not None:
            batch, mask = self.pre_stage.eval(batch)
        keys = [ex.materialize(g.eval(batch), batch) for g in self.grouping]
        cols = [ex.materialize(bound.eval(batch), batch)
                if bound is not None else None
                for bound in self.bound_leaf_inputs]
        return keys, cols, mask

    def _specs_of(self, cols: List[Optional[Column]]
                  ) -> List[agg_k.AggSpec]:
        """The update's AggSpecs over each leaf's input column."""
        specs: List[agg_k.AggSpec] = []
        for leaf, col in zip(self.leaves, cols):
            for op, _t in self._update_cols(leaf):
                if leaf.op == "avg" and op == "sum" and \
                        col.dtype != dt.FLOAT64:
                    specs.append(agg_k.AggSpec(op, Column(
                        dt.FLOAT64, col.data.to(torch.float64),
                        col.validity)))
                else:
                    specs.append(agg_k.AggSpec(
                        op, col, ignore_nulls=leaf.ignore_nulls))
        return specs

    def _pre_stage(self, batch: ColumnarBatch):
        """(batch, keys, specs, live mask or None): one K19 launch for a
        CUDA batch with a generated prologue, else the chain and the
        inputs evaluated eagerly."""
        if self.kernel is not None and self.kernel.mode == "stage" and \
                on_card(batch):
            outs, mask = self.kernel.launch(batch)
            keys, leaves = self._prologue_slots
            cols = [None if i is None else outs[i] for i in leaves]
            return batch, [outs[i] for i in keys], self._specs_of(cols), mask
        keys, cols, mask = self.eager_update_inputs(batch)
        return batch, keys, self._specs_of(cols), mask

    def _update(self, batch: ColumnarBatch) -> ColumnarBatch:
        if self.kernel is not None and self.kernel.mode == "reduce" and \
                on_card(batch):
            return ColumnarBatch(self._partial_schema(), self.kernel.reduce(
                batch, agg_k.REDUCE_SLOTS), 1)
        batch, keys, specs, mask = self._pre_stage(batch)
        return self._aggregate(keys, specs, batch, mask)

    def _update_dispatch(self, batch: ColumnarBatch):
        """Device half of a grouped update: (token, f64 stats vector)."""
        batch, keys, specs, mask = self._pre_stage(batch)
        return agg_k.groupby_fast_dispatch(
            keys, specs, batch.num_rows_raw, batch.capacity,
            allow_matmul=self.allow_matmul, dense_state=self._dense_state,
            live_mask=mask)

    def _update_finish(self, tok, stats, stats_dev) -> ColumnarBatch:
        """Host half: the landed stats (None when the window's batched read
        failed: read this batch's own)."""
        if stats is None:
            stats = stats_dev.cpu().numpy()
        out_keys, aggs, n_groups = agg_k.groupby_fast_finish(tok, stats,
                                                             shrink=True)
        return ColumnarBatch(self._partial_schema(), out_keys + aggs,
                             n_groups)

    def _aggregate(self, keys, specs, batch: ColumnarBatch,
                   mask: Optional[torch.Tensor]) -> ColumnarBatch:
        pschema = self._partial_schema()
        cap = batch.capacity
        if not keys:
            live = mask if mask is not None else batch.row_mask_raw()
            aggs = agg_k.reduce_aggregate(specs, batch.num_rows_raw, cap,
                                          live_mask=live)
            return ColumnarBatch(pschema, aggs, 1)
        out_keys, aggs, n_groups = agg_k.groupby_aggregate_fast(
            keys, specs, batch.num_rows_raw, cap,
            allow_matmul=self.allow_matmul, dense_state=self._dense_state,
            live_mask=mask, shrink=True)
        return ColumnarBatch(pschema, out_keys + aggs, n_groups)

    # -- merge / final -----------------------------------------------------
    def _merge_specs(self, batch: ColumnarBatch):
        nk = len(self.grouping_src)
        keys = list(batch.columns[:nk])
        specs: List[agg_k.AggSpec] = []
        ci = nk
        for leaf in self.leaves:
            for op in self._merge_ops(leaf):
                specs.append(agg_k.AggSpec(op, batch.columns[ci],
                                           ignore_nulls=leaf.ignore_nulls))
                ci += 1
        return keys, specs

    def _merge(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        merged_in = concat_batches(self._partial_schema(), partials,
                                   self.device)
        keys, specs = self._merge_specs(merged_in)
        return self._aggregate(keys, specs, merged_in, None)

    def _final(self, batch: ColumnarBatch) -> ColumnarBatch:
        keys, specs = self._merge_specs(batch)
        merged = self._aggregate(keys, specs, batch, None)
        nk = len(keys)
        return self._project_results(merged.columns[:nk],
                                     merged.columns[nk:], merged.num_rows)

    def _project_results(self, out_keys: List[Column], aggs: List[Column],
                         n_groups: int) -> ColumnarBatch:
        """Evaluate the output expressions over [keys..., leaf values...]
        (avg = sum / count; counts never NULL)."""
        leaf_cols: List[Column] = []
        ai = 0
        for leaf in self.leaves:
            if leaf.op == "avg":
                s, c = aggs[ai], aggs[ai + 1]
                valid = s.validity & (c.data > 0)
                data = torch.where(valid, s.data / torch.clamp(
                    c.data.to(torch.float64), min=1.0), 0.0)
                leaf_cols.append(Column(dt.FLOAT64, data, valid))
            elif leaf.op in ("count", "count_star"):
                c = aggs[ai]
                live = torch.arange(c.capacity, device=c.device) < \
                    max(n_groups, 1)
                data = torch.where(live & c.validity, c.data, 0)
                leaf_cols.append(Column(dt.INT64, data, live))
            else:
                leaf_cols.append(aggs[ai])
            ai += len(self._merge_ops(leaf))
        fields = [dt.Field(f"_k{i}", self.grouping_src[i].dtype, True)
                  for i in range(len(out_keys))]
        fields += [dt.Field(f"_l{i}", l.dtype, True)
                   for i, l in enumerate(self.leaves)]
        internal = ColumnarBatch(dt.Schema(fields), list(out_keys) +
                                 leaf_cols, n_groups)
        out_cols = [ex.materialize(self._rewrite_result(e, len(out_keys))
                                   .eval(internal), internal)
                    for e in self.aggregate_exprs]
        return ColumnarBatch(self._out_schema, out_cols, n_groups)

    def _rewrite_result(self, e: ex.Expression, nk: int) -> ex.Expression:
        def fn(node):
            for i, leaf in enumerate(self.leaves):
                if node is leaf:
                    return ex.BoundReference(nk + i, leaf.dtype, True)
            for gi, g in enumerate(self.grouping_src):
                if node is g or (isinstance(node, ex.ColumnRef) and
                                 isinstance(g, ex.ColumnRef) and
                                 node.col_name == g.col_name):
                    return ex.BoundReference(gi, g.dtype, True)
            return None
        return e.transform_down(fn)

    def _node_string(self):
        chain = f" pre_stage={self.pre_stage.describe()}" \
            if self.pre_stage is not None else ""
        route = " dense-candidate" if self.dense_candidate() else ""
        return f"TpuHashAggregateExec[{self.mode}]{route}{chain}"


# ---------------------------------------------------------------------------
# Join
# ---------------------------------------------------------------------------

class TpuSortMergeJoinExec(TpuExec):
    """Equality join, broadcast form: the build side (the right child) is
    one batch, sorted by its keys once per execution; each stream (left)
    batch is probed against it (K6). An inner join expands the pairs (K7)
    at an output capacity sized by one device -> host read of the pair
    count per stream batch; a left join expands every live stream row to
    at least one slot (K7's outer mode), sized by one read of the pair
    count and the unmatched stream rows together. Semi and anti joins
    compact the stream batch (K5). A full outer join joins the whole
    stream side merged into one batch as a left join, then appends the
    build rows no stream row matched (K14, K5) with NULL left columns; it
    has one output partition. An inner join's residual condition is a
    post-filter (K5); on other join types the planner refuses one.
    """

    JOIN_TYPES = ("inner", "left", "full", "left_semi", "left_anti")

    def __init__(self, left: TpuExec, right: TpuExec, how: str,
                 left_keys: List[ex.Expression],
                 right_keys: List[ex.Expression],
                 condition: Optional[ex.Expression] = None):
        super().__init__(left, right)
        if how not in self.JOIN_TYPES:
            raise NotImplementedError(
                f"{how} join is not ported to the PyTorch engine yet")
        if condition is not None and how != "inner":
            raise NotImplementedError(
                f"a residual condition on a {how} join is not ported to "
                "the PyTorch engine yet")
        self.how = how
        self.left_keys = [bind_refs(e, left.schema) for e in left_keys]
        self.right_keys = [bind_refs(e, right.schema) for e in right_keys]
        self._out_schema = self._compute_schema()
        self.condition = bind_refs(condition, dt.Schema(
            list(left.schema.fields) + list(right.schema.fields))) \
            if condition is not None else None

    def _compute_schema(self) -> dt.Schema:
        """The reference's output nullability: a full join's left columns
        and a left or full join's right columns may be NULL."""
        left, right = self.children[0].schema, self.children[1].schema
        if self.how in ("left_semi", "left_anti"):
            return left
        lf = [dt.Field(f.name, f.dtype, self.how == "full" or f.nullable)
              for f in left.fields]
        rf = [dt.Field(f.name, f.dtype,
                       self.how in ("left", "full") or f.nullable)
              for f in right.fields]
        return dt.Schema(lf + rf)

    @property
    def schema(self):
        return self._out_schema

    @property
    def output_partitions(self) -> int:
        return 1 if self.how == "full" else \
            self.children[0].output_partitions

    def children_coalesce_goal(self, i: int):
        # the stream side in target-size batches, the build side whole
        return "target" if i == 0 else "single"

    def execute(self) -> List[Partition]:
        # the right child is a TpuBroadcastExchangeExec
        build = self.children[1].materialize()
        stream_parts = self.children[0].execute()
        if self.how == "full":
            # a build row is unmatched only if no stream row of the whole
            # stream side matched it: one pass over one merged batch
            stream_parts = [self._merged(stream_parts)]
        return [self._join_part(p, build, self.children[1].release)
                for p in stream_parts]

    def _merged(self, parts: List[Partition]) -> Partition:
        """Every stream batch of ``parts`` in one batch (possibly
        empty)."""
        yield concat_batches(self.children[0].schema,
                             [b for p in parts for b in p], self.device)

    def _join_part(self, part: Partition, build: ColumnarBatch,
                   release=None) -> Partition:
        """Join every stream batch of ``part`` with ``build``; ``release``
        runs when the stream ends."""
        bkeys = [ex.materialize(e.eval(build), build)
                 for e in self.right_keys]
        sorted_builds: Dict[tuple, join_k.BuildSide] = {}
        try:
            for batch in part:
                skeys = [ex.materialize(e.eval(batch), batch)
                         for e in self.left_keys]
                # the build is sorted once per width of the string key
                # pairs, normally once per partition
                widths = join_k.pair_widths(bkeys, skeys)
                side = sorted_builds.get(widths)
                if side is None:
                    side = sorted_builds[widths] = join_k.sort_build(
                        join_k.widen_keys(bkeys, widths),
                        build.num_rows_raw)
                m = join_k.join_match(bkeys, build.num_rows_raw, skeys,
                                      batch.num_rows_raw, batch.capacity,
                                      build=side,
                                      with_build_matched=self.how == "full")
                yield from self._join_finish(build, batch, m)
        finally:
            if release is not None:
                release()

    def _join_finish(self, build: ColumnarBatch, batch: ColumnarBatch,
                     m: join_k.JoinMatch) -> List[ColumnarBatch]:
        if self.how in ("left_semi", "left_anti"):
            s_out, _b, cnt = join_k.join_gather(
                m, batch.columns, build.columns, batch.capacity, self.how,
                n_stream=batch.num_rows_raw)
            return [ColumnarBatch(self._out_schema, s_out, cnt)]
        if self.how == "inner":
            total = int(m.total_pairs)  # the stream batch's one host read
            how = "inner"
        else:
            # pairs + live stream rows with no match, in one host read
            total = sum(m.totals.tolist())
            how = "left"
        s_out, b_out, _cnt = join_k.join_gather(
            m, batch.columns, build.columns, bucket(max(total, 1)), how,
            n_stream=batch.num_rows_raw)
        out = ColumnarBatch(self._out_schema, s_out + b_out, total)
        if self.condition is not None:
            out = filter_batch(self.condition, out)
        outs = [out] if out is not None else []
        if self.how == "full":
            un_cols, ucnt = join_k.unmatched_build_gather(
                m, build.columns, build.num_rows_raw)
            ucap = un_cols[0].capacity if un_cols else build.capacity
            left_nulls = [Column.full_null(f.dtype, ucap, self.device)
                          for f in self.children[0].schema]
            outs.append(ColumnarBatch(self._out_schema,
                                      left_nulls + un_cols, ucnt))
        return outs

    def _node_string(self):
        cond = f" residual={self.condition!r}" \
            if self.condition is not None else ""
        return f"{self.name}[{self.how}]{cond}"


class TpuShuffledJoinExec(TpuSortMergeJoinExec):
    """Co-partitioned equality join: both children hash-exchange on the
    join keys into the same number of partitions, so stream partition i
    joins build partition i only. Each build partition is one batch,
    sorted once (K2) and probed by its stream partition's batches (K6,
    K7). The build side is never whole on the device, one partition at a
    time is. A full outer join is right per partition pair (the keys'
    partitions are disjoint): each stream partition is merged into one
    batch, joined even when it is empty, so every build row of its
    partition comes out. (The reference's runtime broadcast switch and
    skew split are adaptive execution, not ported.)"""

    @property
    def output_partitions(self) -> int:
        return self.children[0].output_partitions

    def children_coalesce_goal(self, i: int):
        return None          # both children are exchanges

    def execute(self) -> List[Partition]:
        lparts = self.children[0].execute()
        rparts = self.children[1].execute()
        if len(lparts) != len(rparts):
            raise RuntimeError(f"co-partition mismatch: {len(lparts)} vs "
                               f"{len(rparts)} partitions")
        return [self._join_copart(sp, bp) for sp, bp in zip(lparts, rparts)]

    def _join_copart(self, stream_part: Partition,
                     build_part: Partition) -> Partition:
        build = concat_batches(self.children[1].schema, list(build_part),
                               self.device)
        if self.how == "full":
            stream_part = self._merged([stream_part])
        yield from self._join_part(stream_part, build)


class TpuCrossJoinExec(TpuExec):
    """Cartesian product: the right side whole in one batch, each left
    batch crossed with it (K15 indices, then gathers); the condition, if
    any, is a post-filter (K5), and empty outputs are dropped."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 condition: Optional[ex.Expression] = None):
        super().__init__(left, right)
        self._out_schema = dt.Schema(
            list(left.schema.fields) + list(right.schema.fields))
        self.condition = bind_refs(condition, self._out_schema) \
            if condition is not None else None

    @property
    def schema(self):
        return self._out_schema

    def execute(self) -> List[Partition]:
        right = concat_batches(
            self.children[1].schema,
            [b for p in self.children[1].execute() for b in p], self.device)
        return [self._map(p, right) for p in self.children[0].execute()]

    def _map(self, part: Partition, right: ColumnarBatch) -> Partition:
        for batch in part:
            resolve_counts([batch])
            total = batch.num_rows * right.num_rows
            if total == 0:
                continue
            l_out, r_out, cnt = join_k.cross_join_gather(
                batch.columns, batch.num_rows, right.columns,
                right.num_rows, bucket(total))
            out = ColumnarBatch(self._out_schema, l_out + r_out, total)
            if self.condition is not None:
                out = filter_batch(self.condition, out)
                if out is None or out.num_rows == 0:
                    continue
            yield out


# ---------------------------------------------------------------------------
# Sort / Limit
# ---------------------------------------------------------------------------

class TpuSortExec(TpuExec):
    """Sort of each partition (K2 lanes + stable torch.sort). A global sort
    has one partition below it, or a range exchange (then
    ``is_global=False``: each partition's rows sort on their own, and the
    partitions' order makes the total order)."""

    def __init__(self, child: TpuExec, orders: List[lp.SortOrder],
                 is_global: bool = True):
        super().__init__(child)
        self.is_global = is_global
        self.orders = [lp.SortOrder(bind_refs(o.child, child.schema),
                                    o.ascending, o.nulls_first)
                       for o in orders]

    @property
    def schema(self):
        return self.children[0].schema

    def children_coalesce_goal(self, i: int):
        return "single"

    def execute(self) -> List[Partition]:
        return [self._sort(p) for p in self.children[0].execute()]

    def _node_string(self):
        return self.name if self.is_global else f"{self.name}[local]"

    def _sort(self, part: Partition) -> Partition:
        batches = list(part)
        if not batches:
            return
        batch = concat_batches(self.schema, batches, self.device)
        keys = [K.SortKey(ex.materialize(o.child.eval(batch), batch),
                          o.ascending, o.nulls_first) for o in self.orders]
        idx = K.sort_indices(keys, batch.num_rows, batch.capacity)
        cols = [K.gather_column(c, idx) for c in batch.columns]
        yield ColumnarBatch(self.schema, cols, batch.num_rows)


class TpuGenerateExec(TpuExec):
    """explode/posexplode (GpuGenerateExec): the child's columns repeated
    per element, then ``pos`` (posexplode) and the element. An array runs
    K25 in array mode; ``explode(split(s, d))`` runs K26's count mode, K25's
    index mode and K26's place mode, without the intermediate
    array<string>. K25 reads the output size from the device once per
    batch (the reference reads it there too, then once more for its row
    count, which the port does not)."""

    def __init__(self, child: TpuExec, plan: lp.Generate):
        super().__init__(child)
        gen = plan.generator
        self.pos = gen.pos
        inner = gen.children[0]
        if isinstance(inner, ar_ops.StringSplit):
            self.split_delim = inner.delimiter
            inner = inner.children[0]
        else:
            self.split_delim = None
        self.gen_input = bind_refs(inner, child.schema)
        self._schema = plan.schema

    @property
    def schema(self):
        return self._schema

    def execute(self) -> List[Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: Partition) -> Partition:
        for batch in part:
            arr = ex.materialize(self.gen_input.eval(batch), batch)
            live = batch.row_mask_raw()
            if self.split_delim is not None:
                out, elem, pos = ar_ops.split_explode(
                    arr, ord(self.split_delim), live)
            else:
                out, elem, pos = ar_ops.explode_array(arr, live)
            if out.count == 0:
                continue
            src = out.src.to(torch.int64)
            out_live = out.live()
            cols = [K.gather_column(c, src, out_valid=out_live)
                    for c in batch.columns]
            cols += ([pos] if self.pos else []) + [elem]
            yield ColumnarBatch(self._schema, cols, out.count)

    def _node_string(self):
        what = f"split {self.split_delim!r}" if self.split_delim is not None \
            else "array"
        return f"TpuGenerateExec [{what}{', pos' if self.pos else ''}]"


class TpuLimitExec(TpuExec):
    """The first ``n`` rows, taken across the child's partitions in order
    (a global limit: one output partition)."""

    def __init__(self, child: TpuExec, n: int):
        super().__init__(child)
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def output_partitions(self) -> int:
        return 1

    def execute(self) -> List[Partition]:
        return [self._take(self.children[0].execute())]

    def _take(self, parts: List[Partition]) -> Partition:
        remaining = self.n
        for part in parts:
            for b in part:
                if remaining <= 0:
                    return
                take = min(remaining, b.num_rows)
                if take < b.num_rows:
                    cols = [K.rebucket_column(c, take, bucket(take))
                            for c in b.columns]
                    b = ColumnarBatch(self.schema, cols, take)
                remaining -= take
                yield b
