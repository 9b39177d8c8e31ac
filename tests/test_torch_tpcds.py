"""TPC-DS q12, q20, q98 (an item's share of its class's revenue: a window
sum over the whole i_class partition) and q89 (a monthly sum against its
category/brand/store average: a window avg) through the PyTorch port's
session on the CPU, against the JAX package's engine on
benchmarks/datagen.py's TPC-DS tables at SF 0.01 (store_sales 28 800
rows; q89 keeps rows there). Rows must be equal, floats within 1e-9
relative, and each plan must be the JAX engine's (every dimension
broadcast, so the window sees one partition)."""

import pytest

from benchmarks import datagen
from benchmarks import tpcds_queries as jax_queries
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.plan.overrides import Overrides

from spark_rapids_tpu_torch import queries as port_queries
from spark_rapids_tpu_torch.api.session import TpuSession

SF = 0.01
QUERIES = ("tpcds_q12", "tpcds_q20", "tpcds_q98", "tpcds_q89")


@pytest.fixture(scope="module")
def engines():
    js = JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false"}).getOrCreate()
    jt = datagen.register_tpcds_tables(js, SF)
    ps = TpuSession.builder.config(
        "spark.rapids.torch.device", "cpu").getOrCreate()
    pt = {n: ps.createDataFrame(c) for n, c in port_queries.tpcds_tables(
        SF, channels=("store_sales", "catalog_sales", "web_sales")).items()}
    return js, jt, ps, pt


@pytest.mark.parametrize("query", QUERIES)
def test_tpcds_window_query_matches_jax_engine(engines, query):
    js, jt, ps, pt = engines
    jdf = getattr(jax_queries, query)(jt)
    want = jdf.collect()
    got = port_queries.QUERIES[query](pt).collect()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0), (g, w)
            else:
                assert x == y, (g, w)
    tree = ps.last_plan().operator_tree()
    assert tree == str(Overrides(js.conf).apply(jdf._analyzed()))
    assert "TpuWindowExec" in tree
