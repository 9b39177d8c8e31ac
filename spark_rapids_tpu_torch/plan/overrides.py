"""Planner: the port of the main-path rules of spark_rapids_tpu/plan/overrides.py.

Converts an analyzed logical plan into execs: scan, filter, project,
aggregate (with the filter/project chain below it folded in, a single
filter with stage fusion off; partial -> hash exchange -> final above
more than one partition), equi-join (inner,
left, right, full, left semi, left anti; broadcast at or under
``autoBroadcastJoinThreshold``, else both sides hash-exchanged into a
shuffled join; a right join is a left join with the sides swapped under
a column reorder), cross join (also a join with no equality key), sort (a
range exchange and local sorts above more than one partition), limit,
repartition, window (plan/window_exec.py), generate (explode, posexplode,
explode(split())) and the DISTINCT aggregates (the reference's two-level
plan), with struct columns read only through their fields shredded into
flat scan columns and the reference's nested type gate, then collapses
the remaining filter/project chains into whole stages
(plan/stage_compiler.py), inserts the batch-coalescing transitions and
attaches each fused unit's generated kernel. With a mesh active
(``spark.rapids.tpu.sql.mesh.enabled``, parallel/mesh.py) a supported
group-by, a global sort and a shuffled join each become one SPMD stage
(parallel/mesh_exec.py), and exchanges take the mesh's plane per
``spark.rapids.tpu.sql.shuffle.plane``. These are the reference's plans
without adaptive execution.
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
from ..columnar.column import device_capable
from ..ops import arithmetic as ar
from ..ops import expressions as ex
from ..ops import predicates as pr
from ..ops import window as W
from ..ops.cast import Cast
from ..shuffle.exchange import (TpuBroadcastExchangeExec, TpuHashExchangeExec,
                                TpuRangeExchangeExec, TpuShuffleExchangeExec)
from . import logical as lp
from . import physical as ph
from . import stage_compiler as sc
from .window_exec import TpuWindowExec


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
        plan = _prune_scan_columns(_shred_struct_columns(plan))
        _check_nested(plan)
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
            leaves = [l for e in p.aggregate_exprs for l in e.collect(
                lambda x: isinstance(x, lp.AggregateExpression))]
            if any(l.distinct for l in leaves):
                return self._convert_distinct_agg(p, kids[0], leaves)
            return self._make_aggregate(kids[0], p.grouping,
                                        p.aggregate_exprs,
                                        p.children[0].stats_bytes())
        if isinstance(p, lp.Join):
            return self._convert_join(p, kids)
        if isinstance(p, lp.Sort):
            # (the port's Sort is always global)
            mesh = self._mesh_for_stage(p.children[0].stats_bytes())
            if mesh is not None:
                # SPMD sort: sample -> bounds -> all_to_all -> local sort
                from ..parallel.mesh_exec import TpuMeshSortExec
                return TpuMeshSortExec(kids[0], p.orders, mesh)
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
            return TpuShuffleExchangeExec(
                kids[0], p.num_partitions, p.by,
                **self._exchange_kwargs(p.children[0].stats_bytes()))
        if isinstance(p, lp.Window):
            _check_window(p, kids[0])
            return TpuWindowExec(kids[0], p.window_exprs)
        if isinstance(p, lp.Generate):
            return ph.TpuGenerateExec(kids[0], p)
        raise NotImplementedError(
            f"{p.name} is not ported to the PyTorch engine yet")

    def _mesh(self):
        """The active mesh, if mesh execution is on (once per plan). A
        forced 'true' that cannot build one raises."""
        if not hasattr(self, "_mesh_cache"):
            from ..parallel.mesh import maybe_mesh
            self._mesh_cache = maybe_mesh(self.conf, self.device)
        return self._mesh_cache

    def _mesh_for_stage(self, *stats: int):
        """The mesh for a stage whose inputs are estimated at ``stats``
        bytes: None above mesh.maxStageBytes (the SPMD stage stages its
        whole input and sizes receive windows at workers x cap)."""
        mesh = self._mesh()
        if mesh is None:
            return None
        if sum(stats) > int(self.conf.get(cfg.MESH_MAX_STAGE_BYTES)):
            return None
        return mesh

    def _exchange_kwargs(self, *stats: int) -> dict:
        """Plan-time plane of one exchange (spark.rapids.tpu.sql.shuffle.
        plane): 'auto' hands the exchange the mesh when the stage is small
        enough (it resolves the plane per run), 'ici' forces the mesh and
        raises at plan time without one, 'dcn' pins the local split."""
        plane = self.conf.get(cfg.SHUFFLE_PLANE)
        if plane == "dcn":
            mesh = None
        elif plane == "ici":
            mesh = self._mesh()            # forced: the size gate yields
            if mesh is None:
                raise RuntimeError(
                    f"{cfg.SHUFFLE_PLANE.key}=ici but no mesh is active: "
                    f"enable {cfg.MESH_ENABLED.key} or use auto/dcn")
        else:
            mesh = self._mesh_for_stage(*stats)
        return dict(plane=plane, mesh=mesh, split_depth=self.split_depth)

    def _try_mesh_aggregate(self, child: ph.TpuExec, grouping, outputs,
                            stats_bytes: int) -> Optional[ph.TpuExec]:
        """A supported group-by as one SPMD stage: keyed, non-distinct,
        each output a grouping column or a bare sum/count/avg/min/max leaf
        (first/last stay on the local plan: their distributed result
        would depend on the shard order). Above mesh.maxStageBytes it
        streams (fixed-width inputs; string keys through their words)."""
        mesh = self._mesh_for_stage(stats_bytes)
        window_rows = None
        if mesh is None:
            mesh = self._mesh()
            if mesh is None:
                return None
            window_rows = int(self.conf.get(cfg.MESH_STREAM_WINDOW_ROWS))
        if not grouping:
            return None
        from ..parallel import mesh_exec as me
        for e in outputs:
            inner = e.children[0] if isinstance(e, ex.Alias) else e
            if isinstance(inner, lp.AggregateExpression):
                if inner.distinct or inner.op not in me.MESH_AGG_OPS:
                    return None
                if inner.children and inner.children[0].dtype == dt.STRING \
                        and inner.op not in ("count",):
                    return None
            else:
                try:
                    me._grouping_index(inner, grouping)
                except ValueError:
                    return None
        if window_rows is not None:
            for g in grouping:
                if g.dtype.var_width and g.dtype != dt.STRING:
                    return None
            for e in outputs:
                inner = e.children[0] if isinstance(e, ex.Alias) else e
                if isinstance(inner, lp.AggregateExpression) and \
                        inner.children and inner.children[0].dtype.var_width:
                    return None
        return me.TpuMeshGroupByExec(child, grouping, outputs, mesh,
                                     window_rows=window_rows)

    def _make_aggregate(self, child: ph.TpuExec, grouping, outputs,
                        stats_bytes: int) -> ph.TpuExec:
        mesh_exec = self._try_mesh_aggregate(child, grouping, outputs,
                                             stats_bytes)
        if mesh_exec is not None:
            return mesh_exec
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
                child, grouping, outputs, pre_stage=pre_stage, **kw))
        # partial (update) -> exchange on the keys -> final (merge) per
        # exchange partition; a global aggregate meets on one partition
        partial = mark(ph.TpuHashAggregateExec(
            child, grouping, outputs, pre_stage=pre_stage, mode="partial",
            **kw))
        xkw = self._exchange_kwargs(stats_bytes)
        if grouping:
            keys = [ex.ColumnRef(f"_k{i}") for i in range(len(grouping))]
            exch = TpuHashExchangeExec(partial, self.shuffle_partitions, keys,
                                       **xkw)
        else:
            exch = TpuShuffleExchangeExec(partial, 1, **xkw)
        return ph.TpuHashAggregateExec(exch, grouping, outputs,
                                       mode="final", per_partition_final=True,
                                       **kw)

    def _convert_distinct_agg(self, p: lp.Aggregate, child: ph.TpuExec,
                              leaves) -> ph.TpuExec:
        """DISTINCT aggregates as the reference plans them
        (plan/overrides.py:_convert_distinct_agg): two aggregates.

          inner: group by (keys..., v), which dedupes the distinct column
                 while computing the non-distinct aggregates per (keys, v)
          outer: group by keys; the distinct aggregates run over the now
                 unique v values, the non-distinct ones merge their inner
                 partials (count -> sum, sum -> sum, avg -> sum / count)

        One distinct column set, and count, sum, avg, min and max only:
        anything else raises, as the reference tags it will_not_work."""
        d_leaves = [l for l in leaves if l.distinct]
        nd_leaves = [l for l in leaves if not l.distinct]
        bad = [l.op for l in d_leaves
               if l.op not in ("count", "sum", "avg", "min", "max")]
        if bad:
            raise NotImplementedError(
                f"DISTINCT {bad[0]}: only count/sum/avg/min/max take "
                "DISTINCT (the reference's will_not_work)")
        if len({repr(l.children[0]) for l in d_leaves if l.children}) > 1:
            raise NotImplementedError(
                "more than one DISTINCT aggregate column set (the "
                "reference's will_not_work)")
        v_expr = d_leaves[0].children[0]
        inner_grouping = list(p.grouping) + [v_expr]
        inner_outputs = [ex.Alias(g, f"_g{i}")
                         for i, g in enumerate(p.grouping)]
        inner_outputs.append(ex.Alias(v_expr, "_v"))
        nd_parts = {}
        for i, l in enumerate(nd_leaves):
            if l.op == "avg":
                c = l.children[0]
                inner_outputs += [
                    ex.Alias(lp.AggregateExpression("sum", c), f"_nd{i}_s"),
                    ex.Alias(lp.AggregateExpression("count", c),
                             f"_nd{i}_c")]
                nd_parts[i] = [f"_nd{i}_s", f"_nd{i}_c"]
            else:
                inner_outputs.append(ex.Alias(lp.AggregateExpression(
                    l.op, l.children[0] if l.children else None,
                    ignore_nulls=l.ignore_nulls), f"_nd{i}"))
                nd_parts[i] = [f"_nd{i}"]
        stats = p.children[0].stats_bytes()
        inner = self._make_aggregate(child, inner_grouping, inner_outputs,
                                     stats)

        def ref(name: str) -> ex.ColumnRef:
            return ex.ColumnRef(name).resolve(inner.schema)

        def merge_leaf(i: int, l) -> ex.Expression:
            names = nd_parts[i]
            if l.op == "avg":
                s = lp.AggregateExpression("sum", ref(names[0]))
                c = lp.AggregateExpression("sum", ref(names[1]))
                num = s if s.dtype == dt.FLOAT64 else Cast(s, dt.FLOAT64)
                return ar.Divide(num, Cast(c, dt.FLOAT64))
            if l.op in ("count", "count_star", "sum"):
                return lp.AggregateExpression("sum", ref(names[0]))
            return lp.AggregateExpression(l.op, ref(names[0]),
                                          ignore_nulls=l.ignore_nulls)

        def rewrite(e: ex.Expression) -> ex.Expression:
            def fn(node):
                for l in d_leaves:
                    if node is l:
                        return lp.AggregateExpression(l.op, ref("_v"))
                for i, l in enumerate(nd_leaves):
                    if node is l:
                        return merge_leaf(i, l)
                for gi, g in enumerate(p.grouping):
                    if node is g or (
                            isinstance(node, ex.ColumnRef) and
                            isinstance(g, ex.ColumnRef) and
                            node.col_name == g.col_name):
                        return ref(f"_g{gi}")
                return None
            # top-down: leaves match by identity, which a bottom-up pass
            # would break by copying nodes whose children were rewritten
            return e.transform_down(fn)

        outer_grouping = [ref(f"_g{i}") for i in range(len(p.grouping))]
        outer_outputs = [ex.Alias(rewrite(e), ex.output_name(e, i))
                         for i, e in enumerate(p.aggregate_exprs)]
        return self._make_aggregate(inner, outer_grouping, outer_outputs,
                                    stats)

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
        lstats = p.children[0].stats_bytes()
        rstats = p.children[1].stats_bytes()
        if p.how == "right":
            inner = self._plan_equi_join(
                right, left, "left", rk, lk, None, build_stats=lstats,
                stream_stats=rstats)
            return _ReorderExec(inner, p.schema, len(rnames))
        return self._plan_equi_join(left, right, p.how, lk, rk, residual,
                                    build_stats=rstats, stream_stats=lstats)

    def _plan_equi_join(self, stream: ph.TpuExec, build: ph.TpuExec,
                        how: str, stream_keys, build_keys, residual,
                        build_stats: int, stream_stats: int) -> ph.TpuExec:
        """A build side whose size estimate is at or under
        ``autoBroadcastJoinThreshold`` (-1: never) is broadcast; a larger
        one hash-exchanges both sides into a co-partitioned shuffled
        join, or, with a mesh active and both sides under
        mesh.maxStageBytes, is one SPMD join (TpuMeshJoinExec)."""
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
        mesh = self._mesh_for_stage(build_stats, stream_stats)
        if mesh is not None:
            # SPMD co-partition: one all_to_all per side
            from ..parallel.mesh_exec import TpuMeshJoinExec
            return TpuMeshJoinExec(stream, build, how, stream_keys,
                                   build_keys, residual, mesh, pk_stream,
                                   pk_build)
        n = self.shuffle_partitions
        xkw = self._exchange_kwargs(build_stats, stream_stats)
        return ph.TpuShuffledJoinExec(
            TpuHashExchangeExec(stream, n, pk_stream, **xkw),
            TpuHashExchangeExec(build, n, pk_build, **xkw),
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
        exprs = list(p.expressions())
        if isinstance(p, lp.Window):
            # the spec's keys are not children of the window expression
            exprs += [k for _n, w in p.window_exprs
                      for k in w.spec.key_expressions()]
        for e in exprs:
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


# Java's String.split takes a one-character pattern literally unless it is
# one of these (its fast path): Spark's split(str, regex) is
# String.split(regex, -1)
_REGEX_META = set(".$|()[{^?*+\\")


def _host_engine(reason: str) -> NotImplementedError:
    return NotImplementedError(
        f"{reason} (the reference runs it on its host engine, ROADMAP A6, "
        "which the PyTorch engine does not have yet)")


def _check_nested_expr(e: ex.Expression, in_generator: bool) -> None:
    """The reference's expression type gate for nested types
    (plan/overrides.py:185-215)."""
    from ..ops import arrays as AR
    from ..ops import maps as MP
    for node in e.collect(lambda x: True):
        if isinstance(node, lp.AggregateExpression) or \
                isinstance(node, W.WindowExpression):
            continue
        if isinstance(node, AR.StringSplit) and in_generator:
            continue
        if isinstance(node, (AR.StringSplit, AR.Explode)) and \
                not in_generator:
            raise _host_engine("split()/explode() outside a generate "
                               "position")
        if isinstance(node, MP.CreateMap):
            if any(c.dtype.is_floating for c in node.children):
                raise _host_engine(
                    "create_map with floating keys or values")
        if isinstance(node, (MP.GetMapValue, MP.GetItem)) and \
                dt.is_map(node.children[0].dtype):
            key_t = node.children[1].dtype
            kt = node.children[0].dtype.key
            if (key_t.numpy_dtype is None) != (kt.numpy_dtype is None) or \
                    key_t.var_width != kt.var_width:
                raise _host_engine(f"map key lookup type {key_t} does not "
                                   f"match map key type {kt}")
        t = node.dtype
        if not device_capable(t) and not isinstance(node, AR.StringSplit):
            raise _host_engine(f"unsupported output type {t}")


def _check_nested(p: lp.LogicalPlan) -> None:
    """The reference's nested-type tagging (plan/overrides.py:117-130,
    185-215, 277-330, 365-390): where it sends a plan to its host engine,
    the port raises with its reason."""
    for c in p.children:
        _check_nested(c)
    for f in p.schema.fields:
        if not device_capable(f.dtype):
            raise _host_engine(f"unsupported column type {f.dtype} for "
                               f"{f.name}")
    if isinstance(p, lp.Generate):
        from ..ops import arrays as AR
        inner = p.generator.children[0]
        if isinstance(inner, AR.StringSplit):
            d = inner.delimiter
            if not (isinstance(d, str) and len(d) == 1 and ord(d) < 128):
                raise _host_engine("explode(split()) needs a single-byte "
                                   "literal delimiter")
            if d in _REGEX_META:
                # the reference splits on the byte itself: Spark's split
                # takes a regex, where '.' or '|' means another split
                raise _host_engine(
                    f"explode(split()) on {d!r}, a regex metacharacter "
                    "(Spark splits on the regex, not on the byte)")
            if inner.children[0].dtype != dt.STRING:
                raise _host_engine("split() of a non-string")
        elif not dt.is_array(inner.dtype) or inner.dtype.element.var_width:
            raise _host_engine(f"explode over {inner.dtype} (needs "
                               "ARRAY<primitive> or split())")
        _check_nested_expr(p.generator.children[0], True)
    else:
        for e in p.expressions():
            _check_nested_expr(e, False)
    key_exprs = []
    if isinstance(p, lp.Sort):
        key_exprs = [o.child for o in p.orders]
    elif isinstance(p, lp.Aggregate):
        key_exprs = list(p.grouping)
    elif isinstance(p, lp.Repartition):
        key_exprs = list(p.by or [])
    elif isinstance(p, lp.Join) and p.condition is not None:
        key_exprs = [p.condition]
    for e in key_exprs:
        if e.collect(lambda x: dt.is_struct(x.dtype)):
            raise _host_engine("struct-typed keys (sort, group, partition, "
                               "join)")


def _shred_struct_columns(root: lp.LogicalPlan) -> lp.LogicalPlan:
    """STRUCT shredding (the reference's plan/overrides.py:1058): when
    every use of a scan's struct column goes through ``GetField``, the
    referenced fields become flat scan columns named ``s.f`` and the
    accesses plain column refs, so the query holds no struct at all. A
    whole-struct use anywhere keeps the struct column (a StructColumn)."""
    from ..ops.structs import GetField
    struct_cols = {f.name for p in _walk(root) if isinstance(p, lp.LocalScan)
                   for f in p.schema.fields if dt.is_struct(f.dtype)}
    if not struct_cols:
        return root
    field_uses: dict = {}
    whole_uses: set = set()

    def scan_expr(e: ex.Expression) -> None:
        if isinstance(e, GetField) and isinstance(e.children[0],
                                                  ex.ColumnRef) and \
                e.children[0].col_name in struct_cols:
            field_uses.setdefault(e.children[0].col_name, set()).add(e.field)
            return
        if isinstance(e, ex.ColumnRef) and e.col_name in struct_cols:
            whole_uses.add(e.col_name)
        for c in e.children:
            scan_expr(c)

    # only the nodes whose expressions the rewrite below handles may shred
    rewritable = (lp.Project, lp.Filter, lp.Aggregate, lp.Sort, lp.Join)
    for p in _walk(root):
        for e in p.expressions():
            if isinstance(p, rewritable):
                scan_expr(e)
            else:
                whole_uses.update(
                    r.col_name for r in e.collect(
                        lambda x: isinstance(x, ex.ColumnRef))
                    if r.col_name in struct_cols)
        if isinstance(p, lp.Window):
            whole_uses.update(
                r.col_name for _n, w in p.window_exprs
                for k in w.spec.key_expressions()
                for r in k.collect(lambda x: isinstance(x, ex.ColumnRef))
                if r.col_name in struct_cols)
    whole_uses.update(n for n in root.schema.names() if n in struct_cols)
    shred = {n: sorted(fs) for n, fs in field_uses.items()
             if n not in whole_uses}
    if not shred:
        return root

    def rewrite_plan(p: lp.LogicalPlan) -> lp.LogicalPlan:
        if isinstance(p, lp.LocalScan):
            if not any(f.name in shred for f in p.schema.fields):
                return p
            return lp.LocalScan(p.data.shredded(shred))
        kids = [rewrite_plan(c) for c in p.children]
        out = copy.copy(p)
        out.children = kids
        out._schema = None
        return out

    def rewrite_expr(e: ex.Expression) -> ex.Expression:
        def fn(node):
            if isinstance(node, GetField) and isinstance(
                    node.children[0], ex.ColumnRef) and \
                    node.children[0].col_name in shred:
                return ex.ColumnRef(
                    f"{node.children[0].col_name}.{node.field}")
            return None
        return e.transform_down(fn)

    new_root = rewrite_plan(root)
    for p in _walk(new_root):
        if isinstance(p, lp.Project):
            p.exprs = [rewrite_expr(e) for e in p.exprs]
        elif isinstance(p, lp.Filter):
            p.condition = rewrite_expr(p.condition)
        elif isinstance(p, lp.Aggregate):
            # an output that is a grouping key stays the same object
            # (analyze matches computed keys by identity)
            keys = {id(g): rewrite_expr(g) for g in p.grouping}
            p.aggregate_exprs = [
                rewrite_expr(e.transform_down(lambda n: keys.get(id(n))))
                for e in p.aggregate_exprs]
            p.grouping = [keys[id(g)] for g in p.grouping]
        elif isinstance(p, lp.Sort):
            p.orders = [lp.SortOrder(rewrite_expr(o.child), o.ascending,
                                     o.nulls_first) for o in p.orders]
        elif isinstance(p, lp.Join) and p.condition is not None:
            p.condition = rewrite_expr(p.condition)
    # the rewritten refs are new: resolve the plan again
    return lp.analyze(new_root)


def _check_window(p: lp.Window, child: ph.TpuExec) -> None:
    """The reference's window tagging (plan/overrides.py:392-410): a RANGE
    frame takes one ascending order key of at most 32 bits. Where the
    reference sends a window elsewhere, the port raises (it has no CPU
    engine). It also raises where the input holds more than one partition
    not clustered on the window's partition keys: the reference computes
    each partition apart there, and a window partition split over two
    input partitions gets wrong rows."""
    for _name, w in p.window_exprs:
        frame, orders = w.spec.frame, w.spec.order_by
        if frame is not None and frame.is_range:
            if len(orders) != 1:
                raise NotImplementedError(
                    "a RANGE frame needs exactly one order key (the "
                    "reference runs it on its CPU engine)")
            if not orders[0].ascending:
                raise NotImplementedError(
                    "a RANGE frame over a descending order key (the "
                    "reference runs it on its CPU engine)")
            if orders[0].child.dtype not in W.RANGE_KEY_TYPES:
                raise NotImplementedError(
                    f"a RANGE frame over a {orders[0].child.dtype} order "
                    "key: it takes at most 32-bit integral or date keys "
                    "(the reference runs it on its CPU engine)")
        f = w.function
        if isinstance(f, lp.AggregateExpression) and f.op not in \
                W.FRAME_OPS and orders and not (
                    frame is None or frame.is_whole_partition):
            raise NotImplementedError(
                f"{f.op} over a running or bounded window frame (the "
                "reference takes count, sum, avg, min and max there)")
        keys = {e.col_name for e in w.spec.partition_by
                if isinstance(e, ex.ColumnRef)}
        if not _clustered_on(child, keys):
            raise NotImplementedError(
                f"a window over {child.output_partitions} input partitions "
                "that are not clustered on its partition keys: the "
                "reference computes each partition apart (wrong rows when "
                "a window partition spans two)")


def _clustered_on(node: ph.TpuExec, keys) -> bool:
    """Whether all rows of one value of the columns ``keys`` lie in one
    output partition of ``node``: one partition, or a hash partitioning
    on a subset of them (a final aggregate over its exchange, a hash
    exchange), seen through filters and coalescing."""
    if node.output_partitions <= 1:
        return True
    while isinstance(node, (ph.TpuFilterExec, ph.TpuCoalesceBatchesExec)):
        node = node.children[0]
    if isinstance(node, ph.TpuHashAggregateExec) and node.mode == "final" \
            and node.per_partition_final:
        g = node.grouping_src
        return bool(g) and all(isinstance(e, ex.ColumnRef) and
                               e.col_name in keys for e in g)
    if isinstance(node, TpuShuffleExchangeExec) and node.by:
        return all(isinstance(b, ex.BoundReference) and b.col_name in keys
                   for b in node.by)
    return False
