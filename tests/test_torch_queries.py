"""TPC-H q22, q2 and q17 (string expressions, withColumnRenamed), q5,
q10, q14, q18, q19 and q20 (a six-way join, a many-group aggregate,
disjunctive string IN lists), q7, q8 and q9 (``F.year`` over joined
nations, parts and partsupp) and q16 and q21 (count DISTINCT) through the
PyTorch port's session on the
CPU, against the JAX package's engine on the same benchmarks/datagen.py
tables. Rows must be equal, floats within 1e-12 relative. Each query runs
on its default plan (small tables broadcast); q22, q2 and q17 also on the
shuffled plan (broadcast off, 8 partitions), where the port's operator
tree must equal the JAX engine's plan. That plan is taken with the JAX
engine's stage fusion on: the port folds the whole filter/project chain
below an aggregate into it (q22's substring filters and its cntrycode
projection), as the reference does with fusion on; with fusion off the
reference folds a single filter only."""

import numpy as np
import pytest

from benchmarks import datagen
from benchmarks import queries as jax_queries
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.plan.overrides import Overrides

from spark_rapids_tpu_torch import queries as port_queries
from spark_rapids_tpu_torch.api.session import TpuSession

SF = 0.001
STRING_QUERIES = ("q22", "q2", "q17")
QUERIES = STRING_QUERIES + ("q5", "q10", "q14", "q18", "q19", "q20",
                            "q7", "q8", "q9", "q16", "q21")
SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.shuffle.partitions": 8}


@pytest.fixture(scope="module")
def tables():
    return {"lineitem": datagen.gen_lineitem(SF),
            "orders": datagen.gen_orders(SF),
            "customer": datagen.gen_customer(SF),
            "supplier": datagen.gen_supplier(SF),
            "partsupp": datagen.gen_partsupp(SF),
            "nation": datagen.gen_nation(), "part": datagen.gen_part(SF),
            "region": datagen.gen_region()}


def _jax_session(**conf):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()


def _jax_tables(session, tables):
    return {n: session.createDataFrame(datagen.to_arrow(c))
            for n, c in tables.items()}


@pytest.fixture(scope="module")
def jax_rows(tables):
    """Each query once on the JAX engine (its rows do not depend on the
    join form)."""
    t = _jax_tables(_jax_session(), tables)
    return {q: getattr(jax_queries, q)(t).collect() for q in QUERIES}


def _port(tables, **conf):
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    return session, {n: session.createDataFrame(
        c, schema=port_queries.table_schema(c)) for n, c in tables.items()}


def assert_rows_equal(got, want, rel=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=0), (g, w)
            else:
                assert x == y, (g, w)


@pytest.mark.parametrize("query", QUERIES)
def test_query_matches_jax_engine(tables, jax_rows, query):
    _session, t = _port(tables)
    got = port_queries.QUERIES[query](t).collect()
    assert len(got) == len(jax_rows[query]) > 0
    assert_rows_equal(got, jax_rows[query])


@pytest.mark.parametrize("query", STRING_QUERIES)
def test_string_query_on_the_shuffled_plan_matches_jax_engine(
        tables, jax_rows, query):
    session, t = _port(tables, **SHUFFLED)
    got = port_queries.QUERIES[query](t).collect()
    assert_rows_equal(got, jax_rows[query])
    tree = session.last_plan().operator_tree()
    js = _jax_session(**SHUFFLED)
    jdf = getattr(jax_queries, query)(_jax_tables(js, tables))
    assert tree == str(Overrides(js.conf).apply(jdf._analyzed()))
    assert "TpuShuffledJoinExec" in tree
    if query == "q22":
        assert "TpuCrossJoinExec" in tree


def test_q22_keeps_the_seven_country_codes(tables):
    """q22's substring filter and group key against numpy."""
    _session, t = _port(tables)
    rows = port_queries.q22(t).collect()
    c, o = tables["customer"], tables["orders"]
    code = np.array([p[:2] for p in c["c_phone"]])
    keep = np.isin(code, port_queries.Q22_CODES)
    bal = c["c_acctbal"]
    avg = bal[keep & (bal > 0)].mean()
    sel = keep & (bal > avg) & ~np.isin(c["c_custkey"], o["o_custkey"])
    want = [(k, int((code[sel] == k).sum()), float(bal[sel & (code == k)]
                                                  .sum()))
            for k in sorted(set(code[sel]))]
    assert [r[:2] for r in rows] == [w[:2] for w in want]
    assert_rows_equal(rows, want, rel=1e-9)
