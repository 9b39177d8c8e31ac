"""The port's stage compiler (plan/stage_compiler.py) against the JAX
package's, on the CPU: with whole-stage fusion on (both keys at their
default) and off (both false), the port plans TPC-H q6, q1, q3, q7 and the
headline with the JAX engine's operator tree and the same fusion
annotations (fused stages, folded aggregates, decline reasons, single-op
stages), and q6, q1, q3 and q7 return the JAX engine's rows. Partition
counts stay powers of two (the reference's size-class gate).

The port's own decisions: every fused unit gets a generated kernel
(K19 fused_stage, K20 fused_reduce) or a recorded reason why the
generator does not cover it. These port-only declines are the string
expressions other than a column compared with literals; the reference
traces them into its XLA stage. They are listed here
(``PORT_ONLY_DECLINES``) and are the only annotation lines the reference
lacks. On the CPU every unit runs its eager ops, the kernels' plain
version.
"""

import numpy as np
import pytest

from benchmarks import datagen
from benchmarks import queries as jax_queries
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plan.stage_compiler import \
    fusion_annotations as jax_annotations

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import queries as port_queries
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.plan import physical as ph
from spark_rapids_tpu_torch.plan import stage_compiler as sc

SF = 0.001
ON = {"spark.rapids.tpu.sql.wholeStageFusion.enabled": "true",
      "spark.rapids.tpu.sql.fusion.wholeStage": "true"}
OFF = {"spark.rapids.tpu.sql.wholeStageFusion.enabled": "false",
       "spark.rapids.tpu.sql.fusion.wholeStage": "false"}
SETTINGS = {"on": ON, "off": OFF}
PLAN_QUERIES = ("q6", "q1", "q3", "q7", "headline")
ROW_QUERIES = ("q6", "q1", "q3", "q7")
# the generator's declines in plans whose stages hold other string
# expressions: (query, unit label, reason)
PORT_ONLY_DECLINES = {
    "q22": [("filter", "string expression not generated (Substring)"),
            ("stage #1", "string expression not generated (Substring)"),
            ("stage #2", "string expression not generated (Substring)")],
    "q13": [("filter", "string expression not generated (Contains)")],
}


@pytest.fixture(scope="module")
def tables():
    return {"lineitem": datagen.gen_lineitem(SF),
            "orders": datagen.gen_orders(SF),
            "customer": datagen.gen_customer(SF),
            "supplier": datagen.gen_supplier(SF),
            "partsupp": datagen.gen_partsupp(SF),
            "nation": datagen.gen_nation(), "part": datagen.gen_part(SF),
            "region": datagen.gen_region(),
            "headline": port_queries.headline_table(3000)}


def _jax_frames(tables, conf):
    import pyarrow as pa
    session = JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()
    t = {n: session.createDataFrame(datagen.to_arrow(c))
         for n, c in tables.items() if n != "headline"}
    h = tables["headline"]
    t["headline"] = session.createDataFrame(pa.table({
        "k": h["k"], "v": pa.array(h["v"].filled(0),
                                   mask=np.ma.getmaskarray(h["v"])),
        "flag": h["flag"]}))
    return session, t


def _port_frames(tables, conf):
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    t = {n: session.createDataFrame(c, schema=port_queries.table_schema(c))
         for n, c in tables.items()}
    return session, t


def _jax_headline(t):
    from spark_rapids_tpu.api import functions as JF
    p = t["headline"].filter(JF.col("flag") & (JF.col("v") > JF.lit(0.0))) \
        .select(JF.col("k"), (JF.col("v") * JF.lit(2.0) +
                              JF.lit(1.0)).alias("p"))
    return p.groupBy("k").agg(JF.sum("p").alias("sum_p"),
                              JF.count("p").alias("count_p"),
                              JF.avg("p").alias("avg_p"))


def _jax_query(name, t):
    return _jax_headline(t) if name == "headline" else \
        getattr(jax_queries, name)(t)


def _port_annotations(plan):
    """The port's annotations without its own ``* not generated`` lines
    (the only ones the reference lacks)."""
    out = {}
    for path, lines in sc.fusion_annotations(plan).items():
        kept = [x for x in lines if not x.startswith("* not generated")]
        if kept:
            out[path] = kept
    return out


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("query", PLAN_QUERIES)
def test_plan_and_annotations_equal_the_reference(tables, query, setting):
    conf = SETTINGS[setting]
    js, jt = _jax_frames(tables, conf)
    ps, pt = _port_frames(tables, conf)
    jplan = JaxOverrides(js.conf).apply(_jax_query(query, jt)._analyzed())
    pdf = port_queries.QUERIES[query](pt)
    pplan = ps.plan(pdf._analyzed())
    assert pplan.operator_tree() == str(jplan)
    assert _port_annotations(pplan) == jax_annotations(jplan)
    d = ps.last_fusion_decisions()
    if setting == "off":
        assert not d.generated and not d.declined and not d.notes
        assert all(getattr(n, "kernel", None) is None
                   for n in _nodes(pplan))
    else:
        assert d.generated and not d.declined


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


@pytest.fixture(scope="module")
def jax_rows(tables):
    """(query, setting) -> the JAX engine's rows, each run at first use
    (a worker runs only the queries its tests ask for)."""
    out = {}

    def rows(query, setting):
        if (query, setting) not in out:
            _s, jt = _jax_frames(tables, SETTINGS[setting])
            out[(query, setting)] = _jax_query(query, jt).collect()
        return out[(query, setting)]
    return rows


def _assert_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12, abs=1e-9)
            else:
                assert a == b


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("query", ROW_QUERIES)
def test_rows_equal_the_reference(tables, jax_rows, query, setting):
    _s, pt = _port_frames(tables, SETTINGS[setting])
    _assert_rows(port_queries.QUERIES[query](pt).collect(),
                 jax_rows(query, setting))


@pytest.mark.parametrize("query", sorted(PORT_ONLY_DECLINES))
def test_port_only_string_declines_are_recorded(tables, query):
    """A stage holding a string expression the generator does not cover
    keeps the reference's plan and runs its eager ops; the decision and
    its reason are on the session and in the node's annotations."""
    conf = {**ON, "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.shuffle.partitions": 8}
    ps, pt = _port_frames(tables, conf)
    js, jt = _jax_frames(tables, conf)
    pplan = ps.plan(port_queries.QUERIES[query](pt)._analyzed())
    jplan = JaxOverrides(js.conf).apply(
        getattr(jax_queries, query)(jt)._analyzed())
    assert pplan.operator_tree() == str(jplan)
    assert _port_annotations(pplan) == jax_annotations(jplan)
    d = ps.last_fusion_decisions()
    assert sorted(d.declined) == sorted(PORT_ONLY_DECLINES[query])
    lines = [x for ls in sc.fusion_annotations(pplan).values() for x in ls
             if x.startswith("* not generated")]
    assert len(lines) == len(PORT_ONLY_DECLINES[query])


def test_the_fusion_keys_default_on_and_the_master_key_gates_both():
    assert cfg.WHOLESTAGE_FUSION.default is True
    assert cfg.FUSION_WHOLE_STAGE.default is True
    assert sc.fusion_enabled(cfg.TorchConf())
    assert not sc.fusion_enabled(cfg.TorchConf(
        {cfg.WHOLESTAGE_FUSION.key: "false"}))
    assert not sc.fusion_enabled(cfg.TorchConf(
        {cfg.FUSION_WHOLE_STAGE.key: "false"}))
    assert sc.master_enabled(cfg.TorchConf(
        {cfg.FUSION_WHOLE_STAGE.key: "false"}))


def test_stage_fusion_off_folds_one_filter_and_keeps_per_op_kernels(
        tables):
    """fusion.wholeStage off, the master key on: the aggregate folds a
    single filter (the reference's pre_filter), a project stays its own
    operator, and the per-operator units still get their kernels."""
    ps, pt = _port_frames(tables, {cfg.FUSION_WHOLE_STAGE.key: "false"})
    plan = ps.plan(port_queries.headline(pt)._analyzed())
    aggs = [n for n in _nodes(plan)
            if isinstance(n, ph.TpuHashAggregateExec)]
    projects = [n for n in _nodes(plan) if isinstance(n, ph.TpuProjectExec)]
    assert aggs[0].pre_stage is None and len(projects) == 1
    assert projects[0].kernel is not None
    assert not any(isinstance(n, sc.TpuWholeStageExec) for n in _nodes(plan))
    got = sorted(port_queries.headline(pt).collect())
    ps2, pt2 = _port_frames(tables, ON)
    _assert_rows(got, sorted(port_queries.headline(pt2).collect()))


def test_a_whole_stage_compacts_once_and_matches_per_operator_rows(tables):
    """q7's nation stages (filter -> renames) are TpuWholeStageExec nodes
    with a generated kernel; on the CPU they run the eager chain and
    give the per-operator plan's rows."""
    ps, pt = _port_frames(tables, ON)
    plan = ps.plan(port_queries.q7(pt)._analyzed())
    stages = [n for n in _nodes(plan) if isinstance(n, sc.TpuWholeStageExec)]
    assert len(stages) == 2
    assert all(s.kernel is not None for s in stages)
    assert stages[0].kernel.entry == stages[1].kernel.entry
    for s in stages:
        rows = [b for part in s.execute() for b in part]
        assert sum(b.num_rows for b in rows) == 2     # FRANCE, GERMANY
