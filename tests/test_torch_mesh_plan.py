"""The PyTorch port's mesh planning against the JAX engine's.

Both sessions get the same ``mesh.enabled=true`` and
``autoBroadcastJoinThreshold=-1`` conf (as tests/test_mesh_plan.py gives
the JAX engine, on the 8-device virtual CPU mesh of tests/conftest.py),
with whole-stage fusion off in both;
the port runs 8 mesh workers on the CPU (``spark.rapids.torch.mesh.workers
=8``). The port's plan must hold the mesh exec and equal the JAX engine's
operator tree; its rows must equal the JAX engine's (sorted rows, floats
within 1e-9 relative; in order for a sort).
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession

from golden import _compare_rows
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession

MESH_ON = {"spark.rapids.tpu.sql.mesh.enabled": "true",
           "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
# whole-stage fusion off in both engines: the JAX engine compiles each
# fused stage (seconds per query on the CPU), and the mesh stages are the
# subject here
NO_FUSION = {"spark.rapids.tpu.sql.fusion.wholeStage": "false",
             "spark.rapids.tpu.sql.wholeStageFusion.enabled": "false"}
PORT = {"spark.rapids.torch.device": "cpu",
        "spark.rapids.torch.mesh.workers": 8}


def _sessions(**conf):
    conf = {**MESH_ON, **NO_FUSION, **conf}
    js = JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()
    return TpuSession.builder.config({**PORT, **conf}).getOrCreate(), js


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


def _seeded(n=1500, nkeys=23, seed=13):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, nkeys, n), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.normal(0, 10, n), mask=rng.random(n) < 0.1),
        "j": rng.integers(-4, 4, n)})


def _run_both(query, tables, exec_name, ignore_order=True, **conf):
    """The query's rows on both engines, compared; the port's plan holds
    ``exec_name`` and equals the JAX engine's operator tree. Returns the
    port's session."""
    ps, js = _sessions(**conf)
    got = query(F, {k: ps.createDataFrame(v) for k, v in tables.items()}
                ).collect()
    want = query(JF, {k: js.createDataFrame(v) for k, v in tables.items()}
                 ).collect()
    _compare_rows(want, got, 1e-9, ignore_order)
    tree = ps.last_plan().operator_tree()
    assert exec_name in tree.split() or any(
        line.strip() == exec_name for line in tree.splitlines()), tree
    assert tree == str(js.last_plan())
    return ps


def _groupby(F_, t):
    return t["t"].groupBy("k").agg(
        F_.sum("v").alias("s"), F_.count("v").alias("c"),
        F_.avg("v").alias("a"), F_.min("j").alias("mn"),
        F_.max("j").alias("mx"), F_.count("*").alias("n"))


def test_mesh_groupby_planned_and_matches_jax():
    ps = _run_both(_groupby, {"t": _seeded()}, "TpuMeshGroupByExec")
    (node,) = [n for n in _nodes(ps.last_plan())
               if n.name == "TpuMeshGroupByExec"]
    assert node.window_rows is None and node.mesh.size == 8


@pytest.mark.parametrize("how", ["inner", "left", "full", "left_semi",
                                 "left_anti"])
def test_mesh_join_planned_and_matches_jax(how):
    rng = np.random.default_rng(17)
    left = pa.table({"a": pa.array(rng.integers(0, 40, 300),
                                   mask=rng.random(300) < 0.05),
                     "x": rng.normal(0, 1, 300)})
    # both sides (bigint, double) at one capacity: one JAX exchange program
    right = pa.table({"b": rng.integers(20, 60, 200),
                      "y": rng.integers(0, 36, 200) / 4})
    _run_both(lambda F_, t: t["l"].join(t["r"], on=F_.col("a") == F_.col("b"),
                                        how=how),
              {"l": left, "r": right}, "TpuMeshJoinExec")


def test_mesh_sort_total_order_matches_jax():
    rng = np.random.default_rng(19)
    t = pa.table({"k": rng.permutation(1000), "v": rng.normal(0, 1, 1000)})
    _run_both(lambda F_, t: t["t"].orderBy("k"), {"t": t},
              "TpuMeshSortExec", ignore_order=False)


def test_mesh_sort_desc_with_nulls_matches_jax():
    rng = np.random.default_rng(23)
    k = rng.normal(0, 50, 600)
    t = pa.table({"k": pa.array(k, mask=rng.random(600) < 0.15),
                  "i": np.arange(600)})
    _run_both(lambda F_, t: t["t"].orderBy(F_.col("k").desc(), F_.col("i")),
              {"t": t}, "TpuMeshSortExec", ignore_order=False)


def test_mesh_groupby_then_sort_matches_jax():
    # (the group-by of test_mesh_groupby_planned_and_matches_jax, the sort
    # shapes of test_mesh_sort_total_order_matches_jax)
    ps = _run_both(lambda F_, t: _groupby(F_, t).select("k", "s")
                   .orderBy("k"), {"t": _seeded()}, "TpuMeshSortExec",
                   ignore_order=False)
    assert "TpuMeshGroupByExec" in ps.last_plan().operator_tree()


def test_mesh_groupby_streams_past_max_stage_bytes():
    """Above mesh.maxStageBytes the group-by stays on the mesh, in
    streaming rounds (string keys: tests/test_torch_mesh.py)."""
    rng = np.random.default_rng(5)
    n = 12_000
    t = pa.table({"k": np.where(rng.random(n) < 0.5, 0,
                                rng.integers(0, 40, n)),
                  "v": rng.integers(-12, 12, n) / 4})
    conf = {"spark.rapids.tpu.sql.mesh.maxStageBytes": "4096",
            "spark.rapids.tpu.sql.mesh.streamWindowRows": "1024"}
    ps = _run_both(lambda F_, t: t["t"].groupBy("k").agg(
        F_.sum("v").alias("s"), F_.count("v").alias("c"),
        F_.avg("v").alias("a")), {"t": t}, "TpuMeshGroupByExec", **conf)
    (node,) = [x for x in _nodes(ps.last_plan())
               if x.name == "TpuMeshGroupByExec"]
    assert node.window_rows == 1024


def test_repartition_on_the_ici_plane_matches_jax():
    ps = _run_both(lambda F_, t: t["t"].repartition(8, "k"),
                   {"t": _seeded()}, "TpuShuffleExchangeExec",
                   **{"spark.rapids.tpu.sql.shuffle.plane": "ici"})
    (node,) = [x for x in _nodes(ps.last_plan())
               if x.name == "TpuShuffleExchangeExec"]
    assert node.would_use_ici() and node.mesh.size == 8
    # each partition holds the rows the local split gives it, in the order
    # of their workers (partition p lives on worker p % 8)
    dcn = TpuSession.builder.config({
        **PORT, "spark.rapids.tpu.sql.shuffle.plane": "dcn"}).getOrCreate()
    dcn.createDataFrame(_seeded()).repartition(8, "k").collect()
    (local,) = [x for x in _nodes(dcn.last_plan())
                if x.name == "TpuShuffleExchangeExec"]
    assert not local.would_use_ici()
    for mine, theirs in zip(node.execute(), local.execute()):
        assert sorted((r for b in mine for r in b.rows()), key=repr) == \
            sorted((r for b in theirs for r in b.rows()), key=repr)
    node.release()
    local.release()


def test_ici_plane_without_a_mesh_raises():
    ps = TpuSession.builder.config({
        **PORT, "spark.rapids.tpu.sql.shuffle.plane": "ici"}).getOrCreate()
    df = ps.createDataFrame(_seeded(200)).repartition(4, "k")
    with pytest.raises(RuntimeError, match="plane=ici but no mesh"):
        df.collect()


def test_mesh_enabled_with_one_worker_raises():
    ps = TpuSession.builder.config({
        **PORT, **MESH_ON,
        "spark.rapids.torch.mesh.workers": 1}).getOrCreate()
    df = ps.createDataFrame(_seeded(200)).groupBy("k").count()
    with pytest.raises(RuntimeError, match="at least 2"):
        df.collect()


def test_mesh_auto_plans_no_mesh_on_the_cpu():
    """The default ('auto') gives no mesh on a CPU session, so the plans
    stay the local ones."""
    ps = TpuSession.builder.config(
        {**PORT, "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    ).getOrCreate()
    ps.createDataFrame(_seeded(200)).groupBy("k").count().collect()
    assert "Mesh" not in ps.last_plan().operator_tree()
