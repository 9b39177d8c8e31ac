"""The PyTorch port's first slice end to end: TPC-H q6 and q1 through the
port's TpuSession -> DataFrame -> planner -> execs on the CPU, against the
JAX package's engine on the same lineitem data. Rows must be equal, floats
within 1e-12 relative. Also: the port imports neither jax nor the JAX
package, refuses to start without CUDA unless asked for the CPU, and
fails loudly on operators it has not ported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import datagen
from benchmarks import queries as jax_queries
from spark_rapids_tpu.api.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import queries as port_queries
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.plan import physical as ph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.001


@pytest.fixture(scope="module")
def lineitem():
    return datagen.gen_lineitem(SF)


@pytest.fixture(scope="module")
def jax_rows(lineitem):
    session = JaxSession.builder.config(
        {"spark.rapids.tpu.sql.explain": "NONE"}).getOrCreate()
    t = {"lineitem": session.createDataFrame(datagen.to_arrow(lineitem))}
    return {name: getattr(jax_queries, name)(t).collect()
            for name in ("q1", "q6")}


def _port_tables(data, **conf):
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    df = session.createDataFrame(data,
                                 schema=port_queries.lineitem_schema(data))
    return session, {"lineitem": df}


def assert_rows_equal(got, want, rel=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=0), (g, w)
            else:
                assert x == y, (g, w)


@pytest.mark.parametrize("batch_rows", [1 << 20, 700])
@pytest.mark.parametrize("query", ["q1", "q6"])
def test_query_matches_jax_engine(lineitem, jax_rows, query, batch_rows):
    """One batch, and nine batches (which exercises the merge of pending
    partials and the final merge)."""
    _session, t = _port_tables(
        lineitem, **{"spark.rapids.tpu.sql.reader.batchSizeRows": batch_rows})
    got = port_queries.QUERIES[query](t).collect()
    assert_rows_equal(got, jax_rows[query])


def test_q1_plan_folds_the_filter_and_prunes_the_scan(lineitem):
    session, t = _port_tables(lineitem)
    port_queries.q1(t).collect_batch()
    plan = session.last_plan()
    chain = []
    node = plan
    while node is not None:
        chain.append(type(node).__name__)
        node = node.children[0] if node.children else None
    assert chain == ["TpuSortExec", "TpuCoalesceBatchesExec",
                     "TpuHashAggregateExec", "TpuCoalesceBatchesExec",
                     "TpuLocalScanExec"]
    agg = plan.children[0].children[0]
    assert agg.pre_stage is not None and agg.pre_stage.describe() == "filter"
    scan = agg.children[0].children[0]
    assert sorted(scan.schema.names()) == sorted(
        ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "l_returnflag", "l_linestatus", "l_shipdate"])


def test_repeated_query_reuses_the_device_scan_cache(lineitem):
    session, t = _port_tables(lineitem)
    cache = session.scan_cache
    first = port_queries.q6(t).collect()
    assert cache.bytes > 0
    cached, uploads = cache.bytes, cache.uploads
    assert port_queries.q6(t).collect() == first
    assert (cache.bytes, cache.uploads, cache.refused) == \
        (cached, uploads, 0)


def test_queries_sharing_columns_keep_one_device_copy_of_each(lineitem):
    session, t = _port_tables(lineitem, **{
        "spark.rapids.tpu.sql.reader.batchSizeRows": 2048})
    cache = session.scan_cache
    port_queries.q1(t).collect()
    q1_bytes, q1_uploads = cache.bytes, cache.uploads
    n_batches = -(-len(lineitem["l_orderkey"]) // 2048)
    assert q1_uploads == 7 * n_batches          # q1 reads seven columns
    # q6's four columns are all among q1's: nothing more goes up or is kept
    port_queries.q6(t).collect()
    assert (cache.bytes, cache.uploads, cache.refused) == \
        (q1_bytes, q1_uploads, 0)


def test_scan_cache_refuses_what_does_not_fit_and_the_scan_still_runs(
        lineitem, jax_rows):
    session, t = _port_tables(lineitem)
    session.scan_cache.max_bytes = 1024
    assert_rows_equal(port_queries.q6(t).collect(), jax_rows["q6"])
    assert (session.scan_cache.bytes, session.scan_cache.refused) == (0, 1)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'spark_rapids_tpu'"
        " or m.startswith('spark_rapids_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_session_without_cuda_and_without_cpu_asked_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession.builder.getOrCreate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession.builder.config("spark.rapids.torch.device",
                                  "cuda:0").getOrCreate()
    s = TpuSession.builder.config("spark.rapids.torch.device",
                                  "cpu").getOrCreate()
    assert s.device.type == "cpu"


def test_unported_operators_fail_loudly(lineitem):
    _session, t = _port_tables(lineitem)
    l = t["lineitem"]
    with pytest.raises(NotImplementedError, match="string comparison"):
        l.filter(F.col("l_shipmode") == F.lit("MAIL")).agg(
            F.count("*")).collect()
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        l.agg(F._agg("count", "l_orderkey", distinct=True)).collect()
    with pytest.raises(NotImplementedError, match="over strings"):
        l.agg(F.min("l_shipmode")).collect()


def test_select_withcolumn_limit_orderby(lineitem):
    session, t = _port_tables(lineitem)
    df = (t["lineitem"].withColumn("rev", F.col("l_extendedprice") *
                                   F.col("l_discount"))
          .select("l_orderkey", "rev")
          .orderBy(F.col("rev").desc(), "l_orderkey").limit(5))
    rows = df.collect()
    rev = lineitem["l_extendedprice"] * lineitem["l_discount"]
    order = np.lexsort((lineitem["l_orderkey"], -rev))[:5]
    assert [r[0] for r in rows] == [int(k) for k in
                                    lineitem["l_orderkey"][order]]
    assert isinstance(session.last_plan(), ph.TpuExec)
