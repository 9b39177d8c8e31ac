"""The PyTorch port's slices end to end: TPC-H q6, q1, q3, q12, q4, q13,
q11 and q15 through the port's TpuSession -> DataFrame -> planner -> execs
on the CPU, against the JAX package's engine on the same TPC-H data. Rows
must be equal, floats within 1e-12 relative. Also: the port imports
neither jax nor the JAX package, refuses to start without CUDA unless
asked for the CPU, picks the JAX engine's join strategy (broadcast at or
under autoBroadcastJoinThreshold, else the shuffled plan, operator for
operator), keeps warm runs in its scan cache, and fails loudly on
operators it has not ported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import datagen
from benchmarks import queries as jax_queries
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import queries as port_queries
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.plan import physical as ph
from spark_rapids_tpu_torch.shuffle.exchange import TpuBroadcastExchangeExec

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


@pytest.fixture(scope="module")
def tpch(lineitem):
    return {"lineitem": lineitem, "orders": datagen.gen_orders(SF),
            "customer": datagen.gen_customer(SF)}


@pytest.fixture(scope="module")
def jax_join_rows(tpch):
    session = JaxSession.builder.config(
        {"spark.rapids.tpu.sql.explain": "NONE"}).getOrCreate()
    t = {name: session.createDataFrame(datagen.to_arrow(cols))
         for name, cols in tpch.items()}
    return {name: getattr(jax_queries, name)(t).collect()
            for name in ("q3", "q12", "q4")}


def _port_tables(data, **conf):
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    df = session.createDataFrame(data,
                                 schema=port_queries.table_schema(data))
    return session, {"lineitem": df}


def _port_tpch(tables, **conf):
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    return session, {name: session.createDataFrame(
        cols, schema=port_queries.table_schema(cols))
        for name, cols in tables.items()}


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


@pytest.mark.parametrize("batch_rows", [1 << 20, 700])
@pytest.mark.parametrize("query", ["q3", "q12", "q4"])
def test_join_query_matches_jax_engine(tpch, jax_join_rows, query,
                                       batch_rows):
    """One scan batch per table, and many (several stream batches probe
    one build, and the build is concatenated from many batches)."""
    _session, t = _port_tpch(
        tpch, **{"spark.rapids.tpu.sql.reader.batchSizeRows": batch_rows})
    got = port_queries.QUERIES[query](t).collect()
    assert len(got) == len(jax_join_rows[query]) > 0
    assert_rows_equal(got, jax_join_rows[query])


# ---------------------------------------------------------------------------
# The shuffled plans: hash exchanges, shuffled joins, partial -> final
# aggregates and the range-partitioned sort
# ---------------------------------------------------------------------------

JOIN_QUERIES = ("q3", "q12", "q4")
NO_BROADCAST = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}


def _jax_session(**conf):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()


def _jax_plan(session, df) -> str:
    """The JAX engine's plan of ``df``, planned but not run."""
    from spark_rapids_tpu.plan.overrides import Overrides
    return str(Overrides(session.conf).apply(df._analyzed()))


@pytest.fixture(scope="module")
def jax_shuffled_rows(tpch):
    """q3, q12 and q4 on the JAX engine's shuffled plan, 8 partitions."""
    session = _jax_session(**NO_BROADCAST, **{
        "spark.rapids.tpu.sql.shuffle.partitions": 8})
    t = {name: session.createDataFrame(datagen.to_arrow(cols))
         for name, cols in tpch.items()}
    return {name: getattr(jax_queries, name)(t).collect()
            for name in JOIN_QUERIES}


@pytest.mark.parametrize("parts,batch_rows", [(8, 1 << 20), (3, 700)])
@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_join_query_on_the_shuffled_plan_matches_jax_engine(
        tpch, jax_shuffled_rows, query, parts, batch_rows):
    """Broadcast off in both engines: the port's plan names the JAX
    engine's operators in the same tree, and the rows equal the JAX
    engine's shuffled run."""
    conf = {**NO_BROADCAST, "spark.rapids.tpu.sql.shuffle.partitions": parts}
    session, t = _port_tpch(tpch, **conf, **{
        "spark.rapids.tpu.sql.reader.batchSizeRows": batch_rows})
    got = port_queries.QUERIES[query](t).collect()
    assert len(got) == len(jax_shuffled_rows[query]) > 0
    assert_rows_equal(got, jax_shuffled_rows[query])
    tree = session.last_plan().operator_tree()
    js = _jax_session(**conf)
    jt = {name: js.createDataFrame(datagen.to_arrow(cols))
          for name, cols in tpch.items()}
    assert tree == _jax_plan(js, getattr(jax_queries, query)(jt))
    for op in ("TpuShuffledJoinExec", "TpuHashExchangeExec",
               "TpuRangeExchangeExec"):
        assert op in tree
    assert "TpuBroadcastExchangeExec" not in tree
    assert "TpuHashAggregateExec[partial]" in session.last_plan() \
        .tree_string()


# ---------------------------------------------------------------------------
# Outer and cross joins, string predicates: q13, q11, q15
# ---------------------------------------------------------------------------

OUTER_QUERIES = ("q13", "q11", "q15")
# whole-stage fusion off in both engines for the plan comparison (both
# keys: the master key gates the stage compiler in each)
NO_FUSION = {"spark.rapids.tpu.sql.fusion.wholeStage": "false",
             "spark.rapids.tpu.sql.wholeStageFusion.enabled": "false"}


@pytest.fixture(scope="module")
def tpch_outer(tpch):
    return {**tpch, "supplier": datagen.gen_supplier(SF),
            "partsupp": datagen.gen_partsupp(SF),
            "nation": datagen.gen_nation()}


@pytest.fixture(scope="module")
def jax_outer_rows(tpch_outer):
    """q13, q11 and q15 once on the JAX engine (their rows do not depend
    on the join form)."""
    session = _jax_session()
    t = {name: session.createDataFrame(datagen.to_arrow(cols))
         for name, cols in tpch_outer.items()}
    return {name: getattr(jax_queries, name)(t).collect()
            for name in OUTER_QUERIES}


@pytest.mark.parametrize("form,conf", [
    ("broadcast", {}),
    ("shuffled", {**NO_BROADCAST,
                  "spark.rapids.tpu.sql.shuffle.partitions": 8})])
@pytest.mark.parametrize("query", OUTER_QUERIES)
def test_outer_and_cross_join_query_matches_jax_engine(
        tpch_outer, jax_outer_rows, query, form, conf):
    """q13 (a left outer join under a string-predicate filter), q11 and
    q15 (cross-joined scalar subqueries): rows equal to the JAX engine's,
    and the plan's operator tree equal to the JAX engine's plan in the
    same join form, whole-stage fusion off in both."""
    session, t = _port_tpch(tpch_outer, **conf, **NO_FUSION)
    got = port_queries.QUERIES[query](t).collect()
    assert len(got) == len(jax_outer_rows[query]) > 0
    assert_rows_equal(got, jax_outer_rows[query])
    tree = session.last_plan().operator_tree()
    js = _jax_session(**conf, **NO_FUSION)
    jt = {name: js.createDataFrame(datagen.to_arrow(cols))
          for name, cols in tpch_outer.items()}
    assert tree == _jax_plan(js, getattr(jax_queries, query)(jt))
    if query == "q13":
        joins = _join_nodes(session.last_plan())
        assert [j.how for j in joins] == ["left"]
        assert ("TpuShuffledJoinExec" in tree) == (form == "shuffled")
    else:
        assert "TpuCrossJoinExec" in tree


def _build_sizes(plan, prune, join_cls):
    """stats_bytes of every join's build side, after the scan pruning."""
    out = []

    def walk(p):
        if isinstance(p, join_cls):
            out.append(p.children[1].stats_bytes())
        for c in p.children:
            walk(c)
    walk(prune(plan))
    return out


@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_both_engines_pick_the_same_join_strategy(tpch, query):
    """Tiny tables broadcast at the default threshold in both engines; at
    half the smallest build's size every join is shuffled in both. Both
    count a build's bytes as arrow does."""
    from spark_rapids_tpu.plan import logical as jlp
    from spark_rapids_tpu.plan.overrides import \
        _prune_scan_columns as jax_prune
    from spark_rapids_tpu_torch.plan import logical as plp
    from spark_rapids_tpu_torch.plan.overrides import \
        _prune_scan_columns as port_prune
    js = _jax_session()
    jt = {name: js.createDataFrame(datagen.to_arrow(cols))
          for name, cols in tpch.items()}
    session, t = _port_tpch(tpch)
    pdf = port_queries.QUERIES[query](t)
    jdf = getattr(jax_queries, query)(jt)
    sizes = _build_sizes(pdf._analyzed(), port_prune, plp.Join)
    assert sizes == _build_sizes(jdf._analyzed(), jax_prune, jlp.Join)
    assert max(sizes) <= 10 << 20
    tree = session.plan(pdf._analyzed()).operator_tree()
    assert tree == _jax_plan(js, jdf)
    assert "TpuBroadcastExchangeExec" in tree and "Shuffled" not in tree
    half = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
            min(sizes) // 2}
    js = _jax_session(**half)
    jt = {name: js.createDataFrame(datagen.to_arrow(cols))
          for name, cols in tpch.items()}
    session, t = _port_tpch(tpch, **half)
    tree = session.plan(
        port_queries.QUERIES[query](t)._analyzed()).operator_tree()
    assert tree == _jax_plan(js, getattr(jax_queries, query)(jt))
    assert "TpuShuffledJoinExec" in tree and "Broadcast" not in tree


def test_scan_size_estimate_counts_bytes_as_arrow_does():
    import pyarrow as pa
    rng = np.random.default_rng(8)
    n = 1000
    s = np.array(["", "a", "héllo", "TRUCK"], dtype=object)[
        rng.integers(0, 4, n)]
    s[::17] = None
    v = np.ma.masked_array(rng.normal(size=n), mask=rng.random(n) < 0.1)
    data = {"i": rng.integers(0, 9, n), "b": rng.random(n) < 0.5,
            "d": rng.integers(0, 9, n).astype(np.int32), "s": s, "v": v}
    session = TpuSession.builder.config(
        "spark.rapids.torch.device", "cpu").getOrCreate()
    df = session.createDataFrame(data, schema={"d": "date"})
    arrow = pa.table({"i": data["i"], "b": data["b"],
                      "d": pa.array(data["d"], pa.date32()),
                      "s": pa.array(list(s)),
                      "v": pa.array(v.filled(0), mask=np.ma.getmaskarray(v))})
    assert df._plan.stats_bytes() == arrow.nbytes
    for cols in (["i"], ["b", "s"], ["d", "v"]):
        assert df._plan.data.select(cols).nbytes() == \
            arrow.select(cols).nbytes


def _residual_on(F_):
    """The order key AND a cross-side inequality (about half the key
    matches of the TPC-H data pass it)."""
    return (F_.col("o_orderkey") == F_.col("l_orderkey")) & \
        (F_.col("o_orderdate") < F_.col("l_shipdate"))


def _residual_join(F_, o, l):
    """Orders x lineitem on ``_residual_on``, counted and summed by order
    priority."""
    return (o.join(l, on=_residual_on(F_)).groupBy("o_orderpriority")
            .agg(F_.count("*").alias("n"),
                 F_.sum("l_extendedprice").alias("s"))
            .orderBy("o_orderpriority"))


@pytest.fixture(scope="module")
def jax_residual_rows(tpch):
    session = JaxSession.builder.config(
        {"spark.rapids.tpu.sql.explain": "NONE"}).getOrCreate()
    t = {name: session.createDataFrame(datagen.to_arrow(tpch[name]))
         for name in ("orders", "lineitem")}
    return _residual_join(JF, t["orders"], t["lineitem"]).collect()


@pytest.mark.parametrize("batch_rows", [1 << 20, 700])
def test_inner_join_residual_condition_matches_jax_engine(
        tpch, jax_residual_rows, batch_rows):
    """The conjunct that is not an equality is a post-filter over the
    joined pairs (bound over the left + right schema, compacted by K5)."""
    session, t = _port_tpch(
        tpch, **{"spark.rapids.tpu.sql.reader.batchSizeRows": batch_rows})
    o, l = t["orders"], t["lineitem"]
    got = _residual_join(F, o, l).collect()
    assert_rows_equal(got, jax_residual_rows)
    joins = _join_nodes(session.last_plan())
    assert len(joins) == 1 and joins[0].condition is not None
    # the residual removes pairs: fewer rows than the key matches alone
    on = F.col("o_orderkey") == F.col("l_orderkey")
    n_keys = o.join(l, on=on).agg(F.count("*")).collect()[0][0]
    assert 0 < sum(r[1] for r in got) < n_keys
    with pytest.raises(NotImplementedError, match="residual condition"):
        o.join(l, on=_residual_on(F), how="left_semi").collect()


def _join_nodes(plan):
    out = [plan] if isinstance(plan, ph.TpuSortMergeJoinExec) else []
    for c in plan.children:
        out.extend(_join_nodes(c))
    return out


def test_q3_plans_two_broadcast_joins_over_filtered_scans(tpch):
    session, t = _port_tpch(tpch)
    port_queries.q3(t).collect_batch()
    joins = _join_nodes(session.last_plan())
    assert [j.how for j in joins] == ["inner", "inner"]
    for j in joins:
        stream, build = j.children
        assert isinstance(stream, ph.TpuCoalesceBatchesExec) and \
            stream.goal == "target"
        assert isinstance(build, TpuBroadcastExchangeExec)
        assert isinstance(build.children[0], ph.TpuFilterExec)
        assert build._batch is None          # released after the query


def test_scan_cache_evicts_least_recently_used_columns_of_other_queries(
        tpch):
    """Two tables whose columns together exceed the cap: each query's
    cold run evicts the other's columns, every warm run is served from
    the cache, and the evictions are counted."""
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 2048}
    sizes = {}
    for name in ("q6", "q4"):           # q6 and q4 share no column
        session, t = _port_tpch(tpch, **conf)
        port_queries.QUERIES[name](t).collect()
        sizes[name] = session.scan_cache.bytes
    session, t = _port_tpch(tpch, **conf)
    cache = session.scan_cache
    cache.max_bytes = max(sizes.values()) + min(sizes.values()) // 2
    for name in ("q6", "q4", "q6", "q4"):
        query = port_queries.QUERIES[name]
        cold = query(t).collect()
        state = (cache.bytes, cache.uploads, cache.evicted)
        assert cache.bytes <= cache.max_bytes
        assert query(t).collect() == cold
        assert (cache.bytes, cache.uploads, cache.evicted) == state
    assert cache.evicted > 0 and cache.refused == 0


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


def test_unported_operators_fail_loudly(tpch):
    """What the port plans runs, and what it does not plan raises
    NotImplementedError: a residual condition on an outer join, a join on
    column names. DISTINCT, once among them, runs."""
    session, t = _port_tpch(tpch)
    l, o, c = t["lineitem"], t["orders"], t["customer"]
    on = F.col("o_orderkey") == F.col("l_orderkey")
    # the outer joins run; their row counts against numpy
    ok, lk = tpch["orders"]["o_orderkey"], tpch["lineitem"]["l_orderkey"]
    pairs = int(np.isin(lk, ok).sum())
    lonely_o = int((~np.isin(ok, lk)).sum())
    lonely_l = int((~np.isin(lk, ok)).sum())
    want = {"inner": pairs, "left": pairs + lonely_o,
            "right": pairs + lonely_l, "full": pairs + lonely_o + lonely_l}
    for how, n in want.items():
        assert o.join(l, on=on, how=how).agg(F.count("*")).collect() == \
            [(n,)], how
    joins = _join_nodes(session.last_plan())
    assert len(joins) == 1 and all(
        isinstance(j.children[1], TpuBroadcastExchangeExec) for j in joins)
    # cross and non-equi joins run, on small filtered inputs
    o20 = o.filter(F.col("o_orderkey") <= 20)
    c10 = c.filter(F.col("c_custkey") <= 10)
    assert o20.crossJoin(c10).agg(F.count("*")).collect() == [(200,)]
    oc = tpch["orders"]["o_custkey"][:20]
    assert o20.join(c10, on=F.col("o_custkey") < F.col("c_custkey")) \
        .agg(F.count("*")).collect() == \
        [(int((oc[:, None] < np.arange(1, 11)[None, :]).sum()),)]
    with pytest.raises(NotImplementedError, match="residual condition"):
        o.join(l, on=on & (F.col("o_orderdate") < F.col("l_shipdate")),
               how="left").collect()
    with pytest.raises(NotImplementedError, match="column names"):
        o.join(l, on="o_orderkey")
    # DISTINCT aggregates and string MIN/MAX are ported: what used to
    # raise here now runs
    assert l.agg(F._agg("count", "l_orderkey", distinct=True)).collect() \
        == [(len(np.unique(tpch["lineitem"]["l_orderkey"])),)]
    modes = tpch["lineitem"]["l_shipmode"]
    assert l.agg(F.min("l_shipmode"), F.max("l_shipmode")).collect() == \
        [(min(modes), max(modes))]


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


# ---------------------------------------------------------------------------
# bench.py's headline through both sessions
# ---------------------------------------------------------------------------

HEADLINE_ROWS = 12_000          # three 2^12-row scan batches
_JAX_MATMUL_ENV = \
    "SPARK_RAPIDS_TPU_CONF__SPARK__RAPIDS__TPU__SQL__AGG__MATMUL__ENABLED"


def _jax_headline(monkeypatch, data):
    """The headline on the JAX engine with its matmul (dense) route on. The
    reference reads that key from a fresh TpuConf (physical.py:40), which
    sees the environment's overrides, so the test sets both."""
    import pyarrow as pa
    monkeypatch.setenv(_JAX_MATMUL_ENV, "true")
    session = JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.agg.matmul.enabled": "true",
        "spark.rapids.tpu.sql.reader.batchSizeRows": 1 << 12}).getOrCreate()
    v = data["v"]
    df = session.createDataFrame(pa.table({
        "k": data["k"], "v": pa.array(v.filled(0), mask=np.ma.getmaskarray(v)),
        "flag": data["flag"]}))
    p = df.filter(JF.col("flag") & (JF.col("v") > JF.lit(0.0))) \
        .select(JF.col("k"), (JF.col("v") * JF.lit(2.0) +
                              JF.lit(1.0)).alias("p"))
    return sorted(p.groupBy("k").agg(JF.sum("p").alias("sum_p"),
                                     JF.count("p").alias("count_p"),
                                     JF.avg("p").alias("avg_p")).collect())


def test_headline_matches_jax_engine_on_the_dense_route(monkeypatch):
    """filter -> project -> dense group-by over three 2^12-row batches,
    agg.matmul.enabled on both engines: keys and counts equal, sums and
    averages within 1e-5 relative (the reference's dense route sums through
    a hi/lo f32 split, aggregates.py:275). The port's updates, merges and
    final all take the dense route."""
    from spark_rapids_tpu_torch.ops import aggregates as agg_k
    data = port_queries.headline_table(HEADLINE_ROWS)
    want = _jax_headline(monkeypatch, data)
    calls = []
    dense = agg_k.groupby_dense
    monkeypatch.setattr(agg_k, "groupby_dense",
                        lambda *a, **k: calls.append(1) or dense(*a, **k))
    session = TpuSession.builder.config({
        "spark.rapids.torch.device": "cpu",
        "spark.rapids.tpu.sql.agg.matmul.enabled": "true",
        "spark.rapids.tpu.sql.reader.batchSizeRows": 1 << 12}).getOrCreate()
    t = {"headline": session.createDataFrame(data)}
    got = sorted(port_queries.headline(t).collect())
    assert_rows_equal(got, want, rel=1e-5)
    assert len(calls) == 3 + 1 + 1      # three updates, a merge, the final
    plan = session.last_plan().tree_string()
    assert "TpuHashAggregateExec[complete] dense-candidate " \
           "pre_stage=filter->project[2]" in plan


def test_headline_inputs_are_the_root_bench_inputs():
    import bench
    for a, b in zip(port_queries.build_inputs(3000, 4096),
                    bench.build_inputs(3000, 4096)):
        np.testing.assert_array_equal(a, b)
