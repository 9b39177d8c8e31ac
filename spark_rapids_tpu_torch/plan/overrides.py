"""Planner: the port of the main-path rules of spark_rapids_tpu/plan/overrides.py.

Converts an analyzed logical plan into execs: scan, filter, project,
aggregate (with the filter/project chain below it folded in, a single
filter with stage fusion off; partial -> hash exchange -> final above
more than one partition), equi-join (inner,
left, right, full, left semi, left anti; broadcast at or under
``autoBroadcastJoinThreshold``, else both sides hash-exchanged into a
shuffled join; a right join is a left join with the sides swapped under
a column reorder), cross join (also a join with no equality key), sort (a
range exchange and local sorts above more than one partition), limit and
repartition, then collapses the remaining filter/project chains into
whole stages (plan/stage_compiler.py), inserts the batch-coalescing
transitions and attaches each fused unit's generated kernel. These are
the reference's plans without adaptive execution and without a device
mesh.
The port has no CPU engine yet, so anything else raises
NotImplementedError naming the operator: nothing runs on the host in its
place. So does an ``incompat`` expression (Upper, Lower, InitCap: ASCII-only
case mapping) while ``spark.rapids.tpu.sql.incompatibleOps.enabled`` is
off, where the reference sends it to its host engine.
"""

from __future__ import annotations

import copy
from typing import Optional

from .. import config as cfg
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..ops import expressions as ex
from ..ops import predicates as pr
from ..ops.cast import Cast
from ..shuffle.exchange import (TpuBroadcastExchangeExec, TpuHashExchangeExec,
                                TpuRangeExchangeExec, TpuShuffleExchangeExec)
from . import logical as lp
from . import physical as ph
from . import stage_compiler as sc


class Overrides:
    def __init__(self, conf: cfg.TorchConf, device,
                 scan_cache: Optional[ph.ScanCache] = None):
        self.conf = conf
        self.device = device
        self.scan_cache = scan_cache

    @property
    def batch_rows(self) -> int:
        return int(self.conf.get(cfg.BATCH_ROWS))

    @property
    def shuffle_partitions(self) -> int:
        return int(self.conf.get(cfg.SHUFFLE_PARTITIONS))

    @property
    def split_depth(self) -> int:
        return int(self.conf.get(cfg.SHUFFLE_PIPELINE_DEPTH))

    def apply(self, plan: lp.LogicalPlan) -> ph.TpuExec:
        """The plan of ``plan``; ``self.decisions`` records the stage
        compiler's decisions."""
        self._check_incompat(plan)
        plan = _prune_scan_columns(plan)
        self.decisions = sc.FusionDecisions()
        node = self._convert(plan)
        # stages collapse before coalesce insertion, so batch coalescing
        # lands below a fused stage, on the raw scan stream (the reference)
        if sc.fusion_enabled(self.conf):
            node = sc.fuse_stages(node, self.decisions)
        node = self._insert_coalesce(node)
        sc.generate_kernels(node, self.conf, self.decisions)
        return node

    def _check_incompat(self, p: lp.LogicalPlan) -> None:
        """The reference's incompat rule (plan/overrides.py:104-106,
        179-185): an expression whose results differ from Spark's in
        corner cases runs only with INCOMPATIBLE_OPS on."""
        if self.conf.get(cfg.INCOMPATIBLE_OPS):
            return
        for e in p.expressions():
            for node in e.collect(lambda x: getattr(x, "incompat", False)):
                raise NotImplementedError(
                    f"{type(node).__name__} is incompatible (ASCII-only case "
                    f"mapping); enable it with {cfg.INCOMPATIBLE_OPS.key} "
                    "(the reference runs it on its host engine, which the "
                    "PyTorch engine does not have)")
        for c in p.children:
            self._check_incompat(c)

    def _convert(self, p: lp.LogicalPlan) -> ph.TpuExec:
        kids = [self._convert(c) for c in p.children]
        if isinstance(p, lp.LocalScan):
            return ph.TpuLocalScanExec(p.data, p.schema, self.device,
                                       batch_rows=self.batch_rows,
                                       cache=self.scan_cache)
        if isinstance(p, lp.Project):
            return ph.TpuProjectExec(kids[0], p.exprs)
        if isinstance(p, lp.Filter):
            return ph.TpuFilterExec(kids[0], p.condition)
        if isinstance(p, lp.Aggregate):
            return self._make_aggregate(p, kids[0])
        if isinstance(p, lp.Join):
            return self._convert_join(p, kids)
        if isinstance(p, lp.Sort):
            if kids[0].output_partitions > 1:
                # distributed sort: range-partition on sampled bounds, then
                # sort each partition: partition order + local order =
                # total order
                n = min(self.shuffle_partitions,
                        max(2, kids[0].output_partitions))
                exch = TpuRangeExchangeExec(kids[0], n, p.orders,
                                            split_depth=self.split_depth)
                return ph.TpuSortExec(exch, p.orders, is_global=False)
            return ph.TpuSortExec(kids[0], p.orders)
        if isinstance(p, lp.Limit):
            return ph.TpuLimitExec(kids[0], p.n)
        if isinstance(p, lp.Repartition):
            return TpuShuffleExchangeExec(kids[0], p.num_partitions, p.by,
                                          split_depth=self.split_depth)
        raise NotImplementedError(
            f"{p.name} is not ported to the PyTorch engine yet")

    def _make_aggregate(self, p: lp.Aggregate,
                        child: ph.TpuExec) -> ph.TpuExec:
        leaves = [l for e in p.aggregate_exprs for l in e.collect(
            lambda x: isinstance(x, lp.AggregateExpression))]
        if any(l.distinct for l in leaves):
            raise NotImplementedError(
                "DISTINCT aggregates are not ported to the PyTorch engine "
                "yet")
        # the fusable chain below folds into the update (stage fusion on);
        # with it off, the reference folds a single filter only
        members = []
        if sc.fusion_enabled(self.conf):
            child, pre_stage, members = sc.peel_for_aggregate(
                child, self.decisions)
        else:
            child, pre_stage = sc.fold_single_filter(child)
        kw = dict(allow_matmul=cfg.matmul_agg_enabled(self.conf, self.device),
                  pipeline_depth=int(self.conf.get(cfg.AGG_PIPELINE_DEPTH)))

        def mark(agg: ph.TpuHashAggregateExec) -> ph.TpuHashAggregateExec:
            if members:
                agg._fusion_stage = self.decisions.next_stage_id()
                agg._fusion_members = list(members)
                self.decisions.note(
                    f"stage #{agg._fusion_stage}: {'+'.join(members)} "
                    f"folded into TpuHashAggregateExec[{agg.mode}]")
            return agg

        if child.output_partitions <= 1:
            return mark(ph.TpuHashAggregateExec(
                child, p.grouping, p.aggregate_exprs, pre_stage=pre_stage,
                **kw))
        # partial (update) -> exchange on the keys -> final (merge) per
        # exchange partition; a global aggregate meets on one partition
        partial = mark(ph.TpuHashAggregateExec(
            child, p.grouping, p.aggregate_exprs, pre_stage=pre_stage,
            mode="partial", **kw))
        if p.grouping:
            keys = [ex.ColumnRef(f"_k{i}") for i in range(len(p.grouping))]
            exch = TpuHashExchangeExec(partial, self.shuffle_partitions, keys,
                                       split_depth=self.split_depth)
        else:
            exch = TpuShuffleExchangeExec(partial, 1,
                                          split_depth=self.split_depth)
        return ph.TpuHashAggregateExec(exch, p.grouping, p.aggregate_exprs,
                                       mode="final", per_partition_final=True,
                                       **kw)

    def _convert_join(self, p: lp.Join, kids) -> ph.TpuExec:
        """A cross join, or a join with no condition or no equality key,
        is a TpuCrossJoinExec (the condition a post-filter). An equi-join
        streams the left side against the right side as the build; a
        right join streams the right side against the left one as a left
        join and reorders the columns. A residual condition is taken on
        inner joins only: the reference runs the others on its host
        engine, which the port does not have."""
        lnames = p.children[0].schema.names()
        rnames = p.children[1].schema.names()
        lk, rk, residual = _extract_equi_keys(p.condition, lnames, rnames)
        if residual is not None and p.how not in ("inner", "cross"):
            raise NotImplementedError(
                f"a residual condition on a {p.how} join is not ported to "
                "the PyTorch engine (the reference runs it on its host "
                "engine)")
        left, right = kids
        if p.how == "cross" or p.condition is None or not lk:
            return ph.TpuCrossJoinExec(left, right, p.condition)
        if p.how == "right":
            inner = self._plan_equi_join(
                right, left, "left", rk, lk, None,
                build_stats=p.children[0].stats_bytes())
            return _ReorderExec(inner, p.schema, len(rnames))
        return self._plan_equi_join(left, right, p.how, lk, rk, residual,
                                    build_stats=p.children[1].stats_bytes())

    def _plan_equi_join(self, stream: ph.TpuExec, build: ph.TpuExec,
                        how: str, stream_keys, build_keys, residual,
                        build_stats: int) -> ph.TpuExec:
        """A build side whose size estimate is at or under
        ``autoBroadcastJoinThreshold`` (-1: never) is broadcast; a larger
        one hash-exchanges both sides into a co-partitioned shuffled
        join."""
        threshold = int(self.conf.get(cfg.AUTO_BROADCAST_JOIN_THRESHOLD))
        if 0 <= threshold and build_stats <= threshold:
            return ph.TpuSortMergeJoinExec(
                stream, TpuBroadcastExchangeExec(build), how, stream_keys,
                build_keys, residual)
        # murmur3 depends on the type: both sides hash one type per key.
        # As in the reference, the first pair with no common numeric type
        # ends the promotion; it and the pairs after it hash as they are.
        pk_stream, pk_build = list(stream_keys), list(build_keys)
        try:
            for i, (a, b) in enumerate(zip(stream_keys, build_keys)):
                if a.dtype != b.dtype:
                    t = dt.promote(a.dtype, b.dtype)
                    pk_stream[i] = a if a.dtype == t else Cast(a, t)
                    pk_build[i] = b if b.dtype == t else Cast(b, t)
        except ValueError:
            pass
        n = self.shuffle_partitions
        return ph.TpuShuffledJoinExec(
            TpuHashExchangeExec(stream, n, pk_stream,
                                split_depth=self.split_depth),
            TpuHashExchangeExec(build, n, pk_build,
                                split_depth=self.split_depth),
            how, stream_keys, build_keys, residual)

    def _insert_coalesce(self, node: ph.TpuExec) -> ph.TpuExec:
        """Shuffle and broadcast exchanges are exempt: they already emit
        one batch per partition."""
        for i, child in enumerate(node.children):
            child = self._insert_coalesce(child)
            goal = node.children_coalesce_goal(i)
            if goal is not None and not isinstance(
                    child, (ph.TpuCoalesceBatchesExec, TpuShuffleExchangeExec,
                            TpuBroadcastExchangeExec)):
                child = ph.TpuCoalesceBatchesExec(
                    child, goal=goal, target_rows=self.batch_rows)
            node.children[i] = child
        return node


class _ReorderExec(ph.TpuExec):
    """The columns of a right join planned as a swapped left join, put
    back in the right join's order (the left side's columns first)."""

    def __init__(self, child: ph.TpuExec, schema: dt.Schema, n_right: int):
        super().__init__(child)
        self._schema = schema
        self.n_right = n_right

    @property
    def schema(self):
        return self._schema

    def execute(self):
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part):
        for b in part:
            cols = b.columns[self.n_right:] + b.columns[:self.n_right]
            yield ColumnarBatch(self._schema, cols, b.num_rows_raw)


def _extract_equi_keys(cond, lnames, rnames):
    """(left keys, right keys, residual): the conjuncts of ``cond`` that
    equate an expression over the left columns with one over the right
    columns, and the AND of the rest (None when there is none). A copy of
    spark_rapids_tpu/cpu/engine.py:_extract_equi_keys."""
    lkeys, rkeys = [], []
    residual = None
    if cond is None:
        return lkeys, rkeys, None

    def visit(e):
        nonlocal residual
        if isinstance(e, pr.And):
            visit(e.children[0])
            visit(e.children[1])
            return
        if isinstance(e, pr.EqualTo):
            l, r = e.children
            lrefs = {c.col_name for c in l.collect(
                lambda x: isinstance(x, ex.ColumnRef))}
            rrefs = {c.col_name for c in r.collect(
                lambda x: isinstance(x, ex.ColumnRef))}
            if lrefs <= set(lnames) and rrefs <= set(rnames):
                lkeys.append(l)
                rkeys.append(r)
                return
            if lrefs <= set(rnames) and rrefs <= set(lnames):
                lkeys.append(r)
                rkeys.append(l)
                return
        residual = e if residual is None else pr.And(residual, e)

    visit(cond)
    return lkeys, rkeys, residual


def _walk(p: lp.LogicalPlan):
    yield p
    for c in p.children:
        yield from _walk(c)


def _prune_scan_columns(root: lp.LogicalPlan) -> lp.LogicalPlan:
    """Keep at the scans only the columns some expression references, plus
    the root's output (by name, as the reference does)."""
    referenced = set(root.schema.names())
    for p in _walk(root):
        for e in p.expressions():
            for n in e.collect(lambda x: isinstance(x, ex.ColumnRef)):
                referenced.add(n.col_name)

    def rewrite(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if isinstance(p, lp.LocalScan):
            names = p.schema.names()
            keep = [n for n in names if n in referenced] or names[:1]
            if len(keep) < len(names):
                return lp.LocalScan(p.data.select(keep))
            return p
        kids = [rewrite(c) for c in p.children]
        if all(k is c for k, c in zip(kids, p.children)):
            return p
        out = copy.copy(p)
        out.children = kids
        out._schema = None
        return out

    return rewrite(root)
