"""Whole-stage fusion: the port of spark_rapids_tpu/plan/stage_compiler.py.

A pipeline STAGE, not an operator, is the unit of compiled execution:

* :class:`StageChain`: filter/project steps, bottom-up. Filters build up a
  live-row MASK instead of compacting, so a whole stage compacts once, at
  its boundary (K5), and an aggregate takes the mask into its kernels.
  ``eval`` is the eager torch evaluation, the plain version of the
  generated kernels.
* :func:`fuse_stages` / :func:`peel_for_aggregate`: the planner passes,
  with the reference's decisions and decline reasons, gated by
  ``spark.rapids.tpu.sql.fusion.wholeStage`` and the master key
  ``spark.rapids.tpu.sql.wholeStageFusion.enabled`` (both on by default).
  A chain of two or more filters/projects becomes a
  :class:`TpuWholeStageExec`; the chain below an aggregate folds into it.
* :func:`generate_kernels`: after the plan is built, every fused unit (a
  whole stage, a single filter or project, an aggregate's update) gets
  its generated kernel (plan/stage_codegen.py: K19 ``fused_stage``, K20
  ``fused_reduce``), or a recorded reason why the generator does not
  cover it; that unit then runs its eager torch ops. Decided at plan
  time, from the expression classes: nothing at run time moves a CUDA
  batch from a kernel to the eager ops, and a kernel that fails to build
  or launch raises.

The reference's ``tuned_batch_rows`` (batch size from its telemetry) waits
for the port's telemetry (ROADMAP A8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import config as cfg
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Scalar
from ..ops import expressions as ex
from ..ops import kernels as K
from . import physical as ph
from . import stage_codegen as sg


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

    def fusable(self) -> bool:
        return exprs_fusable(self.exprs())

    def cache_key(self) -> Optional[tuple]:
        """Structural key of the whole chain, or None when an expression is
        unkeyable (the reference then leaves the stage unfused). The
        generated kernel's own key is the hash of its source, which holds
        no literal value."""
        parts: List[tuple] = []
        for step in self.steps:
            if step[0] == "filter":
                k = expr_cache_key(step[1])
                if k is None:
                    return None
                parts.append(("filter", k))
            else:
                ks = [expr_cache_key(e) for e in step[1]]
                if any(k is None for k in ks):
                    return None
                parts.append(("project", tuple(ks),
                              tuple(f.dtype.name for f in step[2])))
        return tuple(parts)

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


def exprs_fusable(exprs: List[ex.Expression]) -> bool:
    """Every tree fusable and nothing stateful (the reference's gate)."""
    return all(e.tree_fusable() for e in exprs) and not any(
        e.collect(lambda x: not x.side_effect_free) for e in exprs)


def expr_cache_key(e: ex.Expression):
    """The reference's _expr_cache_key (physical.py:666): every instance
    attribute by repr; None when one is opaque. Only its None-ness decides
    anything (a plan decision)."""
    parts: list = [type(e).__name__]
    for k, v in sorted(vars(e).items()):
        if k in ("children", "_literals"):
            continue
        if isinstance(v, ex.Expression):
            sub = expr_cache_key(v)
            if sub is None:
                return None
            parts.append((k, sub))
            continue
        r = repr(v)
        if " at 0x" in r:
            return None
        parts.append((k, r))
    for c in e.children:
        sub = expr_cache_key(c)
        if sub is None:
            return None
        parts.append(sub)
    return tuple(parts)


def chain_of_filter(condition: ex.Expression,
                    schema: dt.Schema) -> StageChain:
    """A one-filter chain: the fold below an aggregate with stage fusion
    off (the reference's ``pre_filter``)."""
    return StageChain([("filter", condition)], schema, schema)


# ---------------------------------------------------------------------------
# The whole-stage exec
# ---------------------------------------------------------------------------

class TpuWholeStageExec(ph.TpuExec):
    """A fused filter/project chain as one exec: per CUDA batch, one K19
    launch evaluates every member's expressions and the live mask, then
    K5 compacts once at the stage boundary (the count stays on the
    device). Without a generated kernel (or on the CPU) the chain runs
    its eager ops, with the same one compaction."""

    def __init__(self, child: ph.TpuExec, chain: StageChain,
                 members: List[str], stage_id: int = 0):
        super().__init__(child)
        self.chain = chain
        self.members = members          # bottom-up member exec names
        self.stage_id = stage_id
        self.kernel: Optional[sg.StageKernel] = None
        self._has_filter = any(s[0] == "filter" for s in chain.steps)

    @property
    def schema(self) -> dt.Schema:
        return self.chain.out_schema

    def stage_exprs(self):
        filters, cols = sg.inline_chain(self.chain, self.chain.in_schema)
        return self.chain.in_schema, filters, cols

    def execute(self) -> List[ph.Partition]:
        return [self._map(p) for p in self.children[0].execute()]

    def _map(self, part: ph.Partition) -> ph.Partition:
        for batch in part:
            out = self._run(batch)
            if out is not None:
                yield out

    def _run(self, batch: ColumnarBatch) -> Optional[ColumnarBatch]:
        if self.kernel is not None and ph.on_card(batch):
            cols, mask = self.kernel.launch(batch)
        else:
            b, mask = self.chain.eval(batch)
            cols = b.columns
        if not self._has_filter:
            return ColumnarBatch(self.schema, cols, batch.num_rows_raw)
        cols, count = K.compact_columns(cols, mask)
        return ColumnarBatch(self.schema, cols, count)

    def _node_string(self) -> str:
        return (f"TpuWholeStageExec[#{self.stage_id} "
                f"{'+'.join(self.members)}]")

    def operator_tree(self, depth: int = 0) -> str:
        return "\n".join(["  " * depth + self._node_string()] +
                         [c.operator_tree(depth + 1) for c in self.children])


# ---------------------------------------------------------------------------
# The planner passes
# ---------------------------------------------------------------------------

def master_enabled(conf: cfg.TorchConf) -> bool:
    """The master key: per-operator fused stages at all."""
    return bool(conf.get(cfg.WHOLESTAGE_FUSION))


def fusion_enabled(conf: cfg.TorchConf) -> bool:
    # the master key gates the per-operator fused stages too: turning it
    # off must disable stage-level fusion, or an A/B of "fusion off" would
    # still get fused chains (the reference's rule)
    return bool(conf.get(cfg.FUSION_WHOLE_STAGE)) and master_enabled(conf)


def _node_decline_reason(node: ph.TpuExec) -> Optional[str]:
    """Why this filter/project exec cannot join a fused stage (None when
    it can): the reference's reasons."""
    if isinstance(node, ph.TpuProjectExec):
        exprs = node.exprs
    elif isinstance(node, ph.TpuFilterExec):
        exprs = [node.condition]
    else:
        return f"not a stage operator ({type(node).__name__})"
    for e in exprs:
        bad = e.collect(lambda x: not x.side_effect_free)
        if bad:
            return f"stateful expression ({type(bad[0]).__name__})"
        if not e.tree_fusable():
            nf = e.collect(lambda x: not x.fusable)
            which = type(nf[0]).__name__ if nf else type(e).__name__
            return f"expression not fusable ({which})"
        if expr_cache_key(e) is None:
            return "unkeyable expression (per-exec jit only)"
    return None


def _step_of(node: ph.TpuExec) -> tuple:
    if isinstance(node, ph.TpuFilterExec):
        return ("filter", node.condition)
    return ("project", node.exprs, node.schema)


class FusionDecisions:
    """Per-query record of what the stage compiler did: stage membership
    for fused nodes, decline reasons for the rest (the reference's), and
    the port's own: which units got a generated kernel (``generated``:
    label, mode, source key) and which run eagerly because the generator
    does not cover them (``declined``: label, reason)."""

    def __init__(self):
        self.notes: List[str] = []     # plan-level summary lines
        self.generated: List[Tuple[str, str, str]] = []
        self.declined: List[Tuple[str, str]] = []
        self._n = 0

    def next_stage_id(self) -> int:
        self._n += 1
        return self._n

    def note(self, line: str) -> None:
        self.notes.append(line)


def peel_for_aggregate(child: ph.TpuExec, decisions: FusionDecisions
                       ) -> Tuple[ph.TpuExec, Optional[StageChain],
                                  List[str]]:
    """Walk down the fusable filter/project chain directly below an
    aggregate and fold it into the aggregate's update. Returns (new child,
    chain or None, member names bottom-up)."""
    steps_top_down: List[tuple] = []
    members_top_down: List[str] = []
    node = child
    while isinstance(node, (ph.TpuFilterExec, ph.TpuProjectExec)):
        reason = _node_decline_reason(node)
        if reason is not None:
            node._fusion_decline = reason
            break
        steps_top_down.append(_step_of(node))
        members_top_down.append(type(node).__name__)
        node = node.children[0]
    if not steps_top_down:
        return child, None, []
    chain = StageChain(list(reversed(steps_top_down)), node.schema,
                       child.schema)
    if chain.cache_key() is None:
        return child, None, []
    return node, chain, list(reversed(members_top_down))


def fold_single_filter(child: ph.TpuExec
                       ) -> Tuple[ph.TpuExec, Optional[StageChain]]:
    """With stage fusion off, the reference folds only a single fusable
    filter below an aggregate (its ``pre_filter``)."""
    if isinstance(child, ph.TpuFilterExec) and \
            child.condition.tree_fusable() and \
            not child.condition.collect(lambda x: not x.side_effect_free):
        return child.children[0], chain_of_filter(
            child.condition, child.children[0].schema)
    return child, None


def fuse_stages(root: ph.TpuExec, decisions: FusionDecisions) -> ph.TpuExec:
    """Collapse every remaining maximal filter/project chain (length >= 2)
    into a :class:`TpuWholeStageExec`. Single operators keep their
    per-operator fused stage."""

    def rec(node: ph.TpuExec) -> ph.TpuExec:
        if isinstance(node, (ph.TpuFilterExec, ph.TpuProjectExec)):
            run: List[ph.TpuExec] = []
            cur = node
            while isinstance(cur, (ph.TpuFilterExec, ph.TpuProjectExec)):
                reason = _node_decline_reason(cur)
                if reason is not None:
                    cur._fusion_decline = reason
                    break
                run.append(cur)
                cur = cur.children[0]
            if len(run) >= 2:
                steps = [_step_of(n) for n in reversed(run)]
                members = [type(n).__name__ for n in reversed(run)]
                chain = StageChain(steps, run[-1].children[0].schema,
                                   run[0].schema)
                if chain.cache_key() is not None:
                    ws = TpuWholeStageExec(rec(run[-1].children[0]), chain,
                                           members,
                                           decisions.next_stage_id())
                    decisions.note(
                        f"stage #{ws.stage_id}: {'+'.join(members)} -> "
                        f"one fused program per batch")
                    return ws
                run[0]._fusion_decline = \
                    "unkeyable expression in chain (per-exec jit only)"
            elif run:
                run[0]._fusion_single = True
        for i, c in enumerate(node.children):
            node.children[i] = rec(c)
        return node

    return rec(root)


def fusion_annotations(root: ph.TpuExec) -> Dict[str, List[str]]:
    """Per-node annotations keyed by the root->node class-name path (the
    reference's): fused-stage membership, folded aggregates, decline
    reasons, single-op stages. The port's own line, ``* not generated:
    <reason>``, marks a unit that runs its eager ops because the
    generator does not cover it."""
    out: Dict[str, List[str]] = {}

    def walk(node, path: str, idx: Optional[int] = None) -> None:
        name = type(node).__name__
        here = f"{path}/{idx}.{name}" if path else name
        lines: List[str] = []
        if isinstance(node, TpuWholeStageExec):
            lines.append(
                f"* fused stage #{node.stage_id}: "
                f"{'+'.join(node.members)} compiled into one program")
        stage = getattr(node, "_fusion_stage", None)
        if stage is not None:
            members = getattr(node, "_fusion_members", [])
            lines.append(
                f"* fused stage #{stage}: {'+'.join(members)} folded into "
                f"this aggregate's update program")
        reason = getattr(node, "_fusion_decline", None)
        if reason is not None:
            lines.append(f"* fusion declined: {reason}")
        if getattr(node, "_fusion_single", False):
            lines.append("* single-op stage (per-op fused program)")
        gen = getattr(node, "_generated_decline", None)
        if gen is not None:
            lines.append(f"* not generated: {gen}")
        if lines:
            out[here] = lines
        for i, c in enumerate(getattr(node, "children", ())):
            walk(c, here, i)

    walk(root, "")
    return out


# ---------------------------------------------------------------------------
# Generated kernels, decided at plan time
# ---------------------------------------------------------------------------

def _unit_of(node: ph.TpuExec):
    """(label, mode, in_schema, filters, outputs, specs) of a fused unit,
    or None when the node is none."""
    if isinstance(node, TpuWholeStageExec):
        in_schema, filters, cols = node.stage_exprs()
        return (f"stage #{node.stage_id}", "stage", in_schema, filters,
                cols, ())
    if isinstance(node, ph.TpuProjectExec):
        in_schema = node.children[0].schema
        return ("project", "stage", in_schema, [],
                [sg.Materialize(e) for e in node.exprs], ())
    if isinstance(node, ph.TpuFilterExec):
        return ("filter", "stage", node.children[0].schema,
                [node.condition], [], ())
    if isinstance(node, ph.TpuHashAggregateExec) and node.mode != "final":
        return node.update_unit()
    return None


def _fusable_unit(node: ph.TpuExec) -> bool:
    """The reference's per-unit gate (FusedStage.maybe, the aggregate's
    _fused_dispatch): every tree fusable, nothing stateful."""
    if isinstance(node, TpuWholeStageExec):
        return node.chain.fusable()
    if isinstance(node, ph.TpuHashAggregateExec):
        return (node.pre_stage is None or node.pre_stage.fusable()) and \
            all(e.tree_fusable() for e in node.grouping) and \
            all(b.tree_fusable() for b in node.bound_leaf_inputs
                if b is not None)
    return exprs_fusable(node.exprs if isinstance(node, ph.TpuProjectExec)
                         else [node.condition])


def generate_kernels(root: ph.TpuExec, conf: cfg.TorchConf,
                     decisions: FusionDecisions) -> None:
    """Attach its generated kernel to every fused unit of the plan, or
    record why the generator declines it (the unit then runs eagerly).
    Nothing is compiled here: a kernel builds at its first CUDA launch."""
    if not master_enabled(conf):
        return

    def visit(node: ph.TpuExec) -> None:
        for c in node.children:
            visit(c)
        unit = _unit_of(node)
        if unit is None:
            return
        label, mode, in_schema, filters, outputs, specs = unit
        if not _fusable_unit(node):
            return
        if isinstance(node, ph.TpuFilterExec) and sg.fold_constants(
                [node.condition]).get(id(node.condition)) is not None:
            return          # a constant predicate keeps or drops batches
        try:
            kernel = sg.StageKernel(mode, in_schema, filters, outputs,
                                    specs)
        except sg.Declined as e:
            node._generated_decline = str(e)
            decisions.declined.append((label, str(e)))
            return
        if kernel.trivial:
            return
        node.kernel = kernel
        which = "K20 fused_reduce" if mode == "reduce" else \
            "K19 fused_stage"
        decisions.generated.append((label, which, kernel.entry))

    visit(root)
