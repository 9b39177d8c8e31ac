"""TpuWindowExec: the port of spark_rapids_tpu/plan/window_exec.py.

Each partition arrives as one batch (``children_coalesce_goal`` "single",
the reference's RequireSingleBatch). Per window expression the batch is
sorted by (partition keys, order keys) (K2 lanes + stable ``torch.sort``),
K3 gives the segments over the sorted partition keys, the function runs on
the sorted rows, and one scatter (the inverse permutation) and a gather put
the result back in input order, so window columns append positionally.
The dispatch is the reference's:

* row_number, rank, dense_rank -> K21 (rank and dense_rank also take K3's
  peer groups over partition + order keys);
* lead, lag -> K21's offset mode + ``gather_column``;
* an aggregate with no order keys or an unbounded..unbounded frame -> K4 +
  gather;
* ROWS UNBOUNDED PRECEDING..CURRENT ROW -> K22;
* any other ROWS or RANGE frame -> K23 bounds, K22's running sum and
  count, K24.

Expressions over one partition/order spec share its sort and segments.
The pandas window UDF (the reference's GpuWindowInPandasExec analog) is not
ported: it raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column
from ..ops import expressions as ex
from ..ops import kernels as K
from ..ops import window as W
from . import logical as lp
from .physical import Partition, TpuExec, bind_refs, concat_batches


class _Sorted:
    """One spec's sorted batch: the permutation, its inverse, the sorted
    keys and K3's segments (peer groups made on first use)."""

    def __init__(self, batch: ColumnarBatch, part_exprs, orders):
        cap, n = batch.capacity, batch.num_rows
        device = batch.columns[0].device
        self.n = n
        pkeys = [ex.materialize(e.eval(batch), batch) for e in part_exprs]
        okeys = [ex.materialize(o.child.eval(batch), batch) for o in orders]
        sort_keys = [K.SortKey(c) for c in pkeys] + \
            [K.SortKey(c, o.ascending, o.nulls_first)
             for c, o in zip(okeys, orders)]
        if sort_keys:
            self.order = K.sort_indices(sort_keys, n, cap)
        else:
            self.order = torch.arange(cap, device=device)
        self.live = torch.arange(cap, device=device) < n
        self.pkeys = [K.gather_column(c, self.order) for c in pkeys]
        self.okeys = [K.gather_column(c, self.order) for c in okeys]
        if self.pkeys:
            _s, self.seg_ids, self.n_groups, self.first_row = \
                K.segment_bounds(self.pkeys, n, cap)
        else:
            self.seg_ids = torch.zeros(cap, dtype=torch.int32, device=device)
            self.first_row = torch.zeros(cap, dtype=torch.int32,
                                         device=device)
            self.n_groups = 1
        self.inverse = torch.empty(cap, dtype=torch.int64, device=device)
        self.inverse.scatter_(0, self.order,
                              torch.arange(cap, device=device))
        self._peers = None

    def peers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(peer ids, peer first rows): K3 over partition + order keys."""
        if self._peers is None:
            cap = self.seg_ids.shape[0]
            _s, ids, _g, first = K.segment_bounds(self.pkeys + self.okeys,
                                                  self.n, cap)
            self._peers = (ids, first)
        return self._peers


class TpuWindowExec(TpuExec):
    def __init__(self, child: TpuExec,
                 window_exprs: List[Tuple[str, W.WindowExpression]]):
        super().__init__(child)
        self.window_exprs = window_exprs
        cs = child.schema
        self._schema = dt.Schema(list(cs.fields) + [
            dt.Field(name, w.dtype, True) for name, w in window_exprs])
        self._bound = []
        for name, w in window_exprs:
            fn = bind_refs(w.function, cs)
            part = [bind_refs(e, cs) for e in w.spec.partition_by]
            orders = [lp.SortOrder(bind_refs(o.child, cs), o.ascending,
                                   o.nulls_first) for o in w.spec.order_by]
            self._bound.append((name, fn, part, orders, w.spec.frame))

    @property
    def schema(self):
        return self._schema

    def children_coalesce_goal(self, i: int):
        # a window partition must lie in one batch (RequireSingleBatch)
        return "single"

    def execute(self) -> List[Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: Partition) -> Partition:
        batches = list(part)
        if not batches:
            return
        batch = concat_batches(self.children[0].schema, batches, self.device)
        if batch.num_rows == 0:
            return
        out_cols = list(batch.columns)
        specs: Dict[str, _Sorted] = {}
        for _name, fn, part_exprs, orders, frame in self._bound:
            key = repr((part_exprs, [(o.child, o.ascending, o.nulls_first)
                                     for o in orders]))
            if key not in specs:
                specs[key] = _Sorted(batch, part_exprs, orders)
            s = specs[key]
            result = self._fn_on_sorted(batch, fn, s, frame, orders)
            out_cols.append(K.gather_column(result, s.inverse,
                                            out_valid=s.live))
        yield ColumnarBatch(self._schema, out_cols, batch.num_rows)

    def _fn_on_sorted(self, batch: ColumnarBatch, fn, s: _Sorted, frame,
                      orders) -> Column:
        cap = batch.capacity
        if isinstance(fn, W.RowNumber):     # Rank, DenseRank too
            kind = {W.Rank: "rank", W.DenseRank: "dense_rank"}.get(
                type(fn), "row_number")
            peer_ids, peer_first = s.peers() if kind != "row_number" \
                else (None, None)
            data = W.window_rank(kind, s.seg_ids, s.first_row, s.n,
                                 peer_ids, peer_first)
            return Column(dt.INT32, data, s.live)
        if isinstance(fn, W.Lead):          # Lag too
            col = K.gather_column(
                ex.materialize(fn.children[0].eval(batch), batch), s.order)
            off = -fn.offset if isinstance(fn, W.Lag) else fn.offset
            return W.shift_in_segment(col, s.seg_ids, off, fn.default, s.n)
        if isinstance(fn, lp.AggregateExpression):
            col = None
            if fn.children:
                col = K.gather_column(
                    ex.materialize(fn.children[0].eval(batch), batch),
                    s.order)
            if frame is None or frame.is_whole_partition or not s.okeys:
                return W.whole_partition_agg(fn.op, col, s.seg_ids, s.live,
                                             cap, fn.ignore_nulls)
            if frame.is_unbounded_to_current:
                return W.segmented_scan(fn.op, col, s.seg_ids, s.n)[0]
            key = s.okeys[0] if frame.is_range else None
            lo, hi = W.frame_bounds(s.seg_ids, s.first_row, s.n_groups, s.n,
                                    frame.lower, frame.upper, key,
                                    orders[0].nulls_first)
            return W.frame_aggregate(fn.op, col, s.seg_ids, s.n, lo, hi,
                                     *W.frame_prefix(fn.op, col, s.seg_ids,
                                                     s.n))
        raise NotImplementedError(
            f"window function {type(fn).__name__} is not ported to the "
            "PyTorch engine (the pandas window UDF waits for the pandas "
            "UDF execs)")
