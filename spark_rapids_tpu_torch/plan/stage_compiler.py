"""Stage chains: the port of spark_rapids_tpu/plan/stage_compiler.py
(``StageChain``, ``chain_of_filter``, ``peel_for_aggregate``).

A chain is the filter/project steps below an aggregate, folded into it.
Filters accumulate a live-row MASK instead of compacting, so the
aggregate's kernels take the mask and no row is moved. The chain is
evaluated eagerly with torch ops; generating one fused kernel per stage
(B10) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Scalar
from ..ops import expressions as ex
from . import physical as ph


class StageChain:
    """Ordered filter/project steps, bottom-up. steps: [("filter",
    bound_condition) | ("project", bound_exprs, out_schema)], each bound to
    the previous step's output schema."""

    def __init__(self, steps: List[tuple], in_schema: dt.Schema,
                 out_schema: dt.Schema):
        self.steps = list(steps)
        self.in_schema = in_schema
        self.out_schema = out_schema

    def exprs(self) -> List[ex.Expression]:
        out: List[ex.Expression] = []
        for step in self.steps:
            if step[0] == "filter":
                out.append(step[1])
            else:
                out.extend(step[1])
        return out

    def describe(self) -> str:
        return "->".join("filter" if s[0] == "filter"
                         else f"project[{len(s[1])}]" for s in self.steps)

    def eval(self, b: ColumnarBatch
             ) -> Tuple[ColumnarBatch, Optional[torch.Tensor]]:
        """(post-chain batch, live-row mask or None when the chain has no
        filter). Dead rows keep whatever the projections computed for
        them; consumers mask them."""
        mask = None
        for step in self.steps:
            if step[0] == "filter":
                pred = step[1].eval(b)
                if isinstance(pred, Scalar):
                    m = torch.full((b.capacity,), pred.value is True,
                                   dtype=torch.bool, device=b.device)
                else:
                    m = pred.data & pred.validity
                mask = m if mask is None else (mask & m)
            else:
                _tag, exprs, out_schema = step
                cols = [ex.materialize(e.eval(b), b) for e in exprs]
                b = ColumnarBatch(out_schema, cols, b.num_rows_raw)
        if mask is not None:
            mask = mask & b.row_mask_raw()
        return b, mask


def chain_of_filter(condition: ex.Expression,
                    schema: dt.Schema) -> StageChain:
    return StageChain([("filter", condition)], schema, schema)


def _step_of(node: ph.TpuExec) -> tuple:
    if isinstance(node, ph.TpuFilterExec):
        return ("filter", node.condition)
    return ("project", node.exprs, node.schema)


def peel_for_aggregate(child: ph.TpuExec
                       ) -> Tuple[ph.TpuExec, Optional[StageChain]]:
    """Fold the filter/project chain directly below an aggregate into it.
    Returns (new child, chain or None)."""
    steps_top_down: List[tuple] = []
    node = child
    while isinstance(node, (ph.TpuFilterExec, ph.TpuProjectExec)):
        steps_top_down.append(_step_of(node))
        node = node.children[0]
    if not steps_top_down:
        return child, None
    chain = StageChain(list(reversed(steps_top_down)), node.schema,
                       child.schema)
    return node, chain
