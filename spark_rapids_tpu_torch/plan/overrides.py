"""Planner: the port of the main-path rules of spark_rapids_tpu/plan/overrides.py.

Converts an analyzed logical plan into execs: scan, filter, project,
aggregate (with the filter/project chain below it folded in; partial ->
hash exchange -> final above more than one partition), equi-join
(broadcast at or under ``autoBroadcastJoinThreshold``, else both sides
hash-exchanged into a shuffled join), sort (a range exchange and local
sorts above more than one partition), limit and repartition, then inserts
the batch-coalescing transitions. These are the reference's plans without
adaptive execution and without a device mesh. The port has no CPU engine
yet, so anything else raises NotImplementedError naming the operator:
nothing runs on the host in its place.
"""

from __future__ import annotations

import copy
from typing import Optional

from .. import config as cfg
from ..columnar import dtypes as dt
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
        plan = _prune_scan_columns(plan)
        node = self._convert(plan)
        return self._insert_coalesce(node)

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
        child, pre_stage = sc.peel_for_aggregate(child)
        kw = dict(allow_matmul=cfg.matmul_agg_enabled(self.conf, self.device),
                  pipeline_depth=int(self.conf.get(cfg.AGG_PIPELINE_DEPTH)))
        if child.output_partitions <= 1:
            return ph.TpuHashAggregateExec(
                child, p.grouping, p.aggregate_exprs, pre_stage=pre_stage,
                **kw)
        # partial (update) -> exchange on the keys -> final (merge) per
        # exchange partition; a global aggregate meets on one partition
        partial = ph.TpuHashAggregateExec(
            child, p.grouping, p.aggregate_exprs, pre_stage=pre_stage,
            mode="partial", **kw)
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
        """An equi-join: the left side streams, the right side is the
        build. A build side whose size estimate is at or under
        ``autoBroadcastJoinThreshold`` (-1: never) is broadcast; a larger
        one hash-exchanges both sides into a co-partitioned shuffled
        join."""
        lk, rk, residual = _extract_equi_keys(
            p.condition, p.children[0].schema.names(),
            p.children[1].schema.names())
        if not lk:
            raise NotImplementedError(
                f"{p.how} join without an equality key (a cross or "
                "non-equi join) is not ported to the PyTorch engine yet")
        left, right = kids
        threshold = int(self.conf.get(cfg.AUTO_BROADCAST_JOIN_THRESHOLD))
        if 0 <= threshold and p.children[1].stats_bytes() <= threshold:
            return ph.TpuSortMergeJoinExec(
                left, TpuBroadcastExchangeExec(right), p.how, lk, rk,
                residual)
        # murmur3 depends on the type: both sides hash one type per key.
        # As in the reference, the first pair with no common numeric type
        # ends the promotion; it and the pairs after it hash as they are.
        pk_left, pk_right = list(lk), list(rk)
        try:
            for i, (a, b) in enumerate(zip(lk, rk)):
                if a.dtype != b.dtype:
                    t = dt.promote(a.dtype, b.dtype)
                    pk_left[i] = a if a.dtype == t else Cast(a, t)
                    pk_right[i] = b if b.dtype == t else Cast(b, t)
        except ValueError:
            pass
        n = self.shuffle_partitions
        return ph.TpuShuffledJoinExec(
            TpuHashExchangeExec(left, n, pk_left,
                                split_depth=self.split_depth),
            TpuHashExchangeExec(right, n, pk_right,
                                split_depth=self.split_depth),
            p.how, lk, rk, residual)

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
