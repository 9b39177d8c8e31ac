"""DISTINCT aggregates in the PyTorch port on the CPU, against the JAX
package's engine on the same tables.

The port plans them as the reference does (plan/overrides.py
_convert_distinct_agg): an aggregate grouped by (keys..., v) dedupes the
distinct column, and a second grouped by the keys runs the distinct
aggregates over the unique values while the plain ones merge their
partials. Rows must be equal (counts exactly, floats within 1e-9
relative), and over an exchange the port's plan must be the reference's.
More than one DISTINCT column set, or DISTINCT on another aggregate than
count/sum/avg/min/max, raises NotImplementedError (the reference tags it
will_not_work).
"""

import numpy as np
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.plan import logical as jlp
from spark_rapids_tpu.plan.overrides import Overrides

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.column import Col
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.plan import logical as lp


def _data(seed=0, n=300):
    rng = np.random.default_rng(seed)
    words = np.array(["a", "b", "c", "dd", "eee"])
    return {
        "k": rng.integers(0, 6, n).astype(np.int64),
        "j": np.ma.masked_array(rng.integers(0, 25, n).astype(np.int64),
                                mask=rng.random(n) < 0.15),
        "i": rng.integers(-50, 50, n).astype(np.int64),
        "f": np.round(rng.normal(0, 10, n), 3),
        "s": np.ma.masked_array(words[rng.integers(0, 5, n)],
                                mask=rng.random(n) < 0.1)}


def _arrow(data):
    import pyarrow as pa
    cols = {}
    for k, v in data.items():
        if isinstance(v, np.ma.MaskedArray):
            vals = [None if m else x for x, m in
                    zip(v.data.tolist(), np.ma.getmaskarray(v))]
        else:
            vals = v.tolist()
        cols[k] = pa.array(vals)
    return pa.table(cols)


def _distinct(Fm, name, c):
    """DISTINCT avg/min/max on either API: an AggregateExpression with
    distinct set (pyspark spells them avg(DISTINCT c))."""
    mod = jlp if Fm is JF else lp
    wrap = Fm.Col if Fm is JF else Col
    return wrap(mod.AggregateExpression(name, Fm.col(c).expr,
                                        distinct=True))


QUERIES = {
    "count_distinct_string": lambda Fm, df: df.groupBy("k").agg(
        Fm.countDistinct("s").alias("cd")),
    "count_distinct_nulls": lambda Fm, df: df.groupBy("k").agg(
        Fm.countDistinct("j").alias("cd")),
    "sum_distinct": lambda Fm, df: df.groupBy("s").agg(
        Fm.sumDistinct("i").alias("sd")),
    "mixed_with_plain": lambda Fm, df: df.groupBy("s").agg(
        Fm.countDistinct("j").alias("cd"), Fm.sum("i").alias("si"),
        Fm.avg("f").alias("af"), Fm.count("i").alias("ci"),
        Fm.min("i").alias("mi"), Fm.max("f").alias("mf"),
        Fm.count("*").alias("n")),
    "no_grouping": lambda Fm, df: df.agg(
        Fm.countDistinct("j").alias("cd"), Fm.sum("i").alias("si")),
    "agg_on_grouping_column": lambda Fm, df: df.groupBy("k").agg(
        Fm.countDistinct("s").alias("cd"), Fm.sum("k").alias("sk")),
    "avg_min_max_distinct": lambda Fm, df: df.groupBy("k").agg(
        _distinct(Fm, "avg", "j").alias("ad"),
        _distinct(Fm, "min", "j").alias("mnd"),
        _distinct(Fm, "max", "j").alias("mxd"),
        Fm.countDistinct("j").alias("cd"), Fm.avg("i").alias("ai")),
    "arithmetic_over_distinct": lambda Fm, df: df.groupBy("k").agg(
        (Fm.sumDistinct("j") * 2 + Fm.count("*")).alias("x")),
}


def _jax_session(**conf):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()


def _port_session(**conf):
    return TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()


def _key(row):
    return tuple((x is None, x) for x in row)


def assert_rows(got, want, rel=1e-9):
    assert len(got) == len(want) > 0
    for g, w in zip(sorted(got, key=_key), sorted(want, key=_key)):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-12), (g, w)
            else:
                assert x == y, (g, w)


@pytest.fixture(scope="module")
def tables():
    data = _data()
    return (data, _jax_session().createDataFrame(_arrow(data)),
            _port_session().createDataFrame(data))


@pytest.mark.parametrize("name", list(QUERIES))
def test_distinct_aggregates_match_jax_engine(tables, name):
    _data_, jdf, pdf = tables
    want = QUERIES[name](JF, jdf).collect()
    got = QUERIES[name](F, pdf).collect()
    assert_rows(got, want)


def test_count_distinct_skips_nulls_and_duplicates():
    """(1,a),(1,a),(1,b),(2,c),(2,NULL): count(DISTINCT v) is 2 and 1."""
    df = _port_session().createDataFrame({
        "k": np.array([1, 1, 1, 2, 2], np.int64),
        "v": np.ma.masked_array(np.array(["a", "a", "b", "c", "c"]),
                                mask=[0, 0, 0, 0, 1])})
    rows = df.groupBy("k").agg(F.countDistinct("v").alias("cd")).collect()
    assert sorted(rows) == [(1, 2), (2, 1)]


@pytest.mark.parametrize("name", ["mixed_with_plain", "no_grouping"])
def test_distinct_over_an_exchange_matches_jax_plan(name):
    """Over 4 hash partitions both aggregates go partial -> exchange ->
    final, as the reference plans them (8 shuffle partitions)."""
    data = _data(seed=1)
    conf = {"spark.rapids.tpu.sql.shuffle.partitions": 8}
    js = _jax_session(**conf)
    jdf = QUERIES[name](JF, js.createDataFrame(_arrow(data))
                        .repartition(4, "k"))
    ps = _port_session(**conf)
    got = QUERIES[name](F, ps.createDataFrame(data).repartition(4, "k"))
    assert_rows(got.collect(), jdf.collect())
    tree = ps.last_plan().operator_tree()
    assert tree == str(Overrides(js.conf).apply(jdf._analyzed()))
    assert tree.count("TpuHashAggregateExec") == 4


def test_distinct_outside_the_reference_scope_raises(tables):
    _data_, _jdf, pdf = tables
    with pytest.raises(NotImplementedError, match="more than one DISTINCT"):
        pdf.groupBy("k").agg(F.countDistinct("i"),
                             F.countDistinct("j")).collect()
    first = Col(lp.AggregateExpression("first", F.col("i").expr,
                                       distinct=True))
    with pytest.raises(NotImplementedError, match="DISTINCT first"):
        pdf.groupBy("k").agg(first).collect()
