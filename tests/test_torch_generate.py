"""Nested-type queries through the PyTorch port's session against the JAX
engine: the JAX package's cases of tests/test_arrays.py, test_maps.py and
test_structs.py (explode, posexplode and explode(split()), array and map
access, create_map, STRUCT shredding and whole structs through joins and
sorts), each run through both sessions (the port's on the CPU) with the
rows compared; nested payload columns through a fused filter, the hash,
round-robin and range exchanges, and the map width harmonisation of a
concat. Where the JAX engine sends a query to its host engine, the port
raises NotImplementedError with the reason (its host engine is ROADMAP
A6)."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession

from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import StructColumn
from spark_rapids_tpu_torch.plan.physical import concat_batches

QUIET = {"spark.rapids.tpu.sql.explain": "NONE"}


def _array_table():
    return pa.table({
        "k": [1, 2, 3, 4, 5],
        "a": pa.array([[1, 2, 3], [], None, [7], [8, 9]],
                      type=pa.list_(pa.int64()))})


def _map_table():
    return pa.table({
        "k": [1, 2, 3, 4],
        "m": pa.array([[(1, 5.0), (2, 6.5)], [(2, 7.0)], None, []],
                      type=pa.map_(pa.int64(), pa.float64()))})


def _struct_table():
    return pa.table({
        "id": [1, 2, 3, 4],
        "s": pa.array([{"x": 1, "y": 2.5}, {"x": 3, "y": 4.5}, None,
                       {"x": 7, "y": None}],
                      type=pa.struct([("x", pa.int64()),
                                      ("y", pa.float64())]))})


def _random_arrays():
    rng = np.random.default_rng(31)
    arrays = [None if rng.random() < 0.1 else
              [int(x) for x in rng.integers(0, 100, rng.integers(0, 6))]
              for _ in range(800)]
    return pa.table({"k": list(range(800)),
                     "a": pa.array(arrays, type=pa.list_(pa.int64()))})


def _null_elements():
    return pa.table({"id": [1, 2, 3, 4],
                     "a": pa.array([[1, None, 3], None, [None], [4, 5]],
                                   type=pa.list_(pa.int64()))})


def _map_groupby_data():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 8, 2000)
    return {"g": [int(x) for x in keys % 4],
            "m": [{int(k): float(k) * 2 + 1, 99: -1.0} for k in keys]}


# name -> query(session, F): the JAX package's nested cases
CASES = {
    "explode_array": lambda s, F: s.createDataFrame(_array_table()).select(
        F.col("k"), F.explode(F.col("a")).alias("v")),
    "posexplode_array": lambda s, F: s.createDataFrame(
        _array_table()).select(F.col("k"), F.posexplode(F.col("a"))),
    "get_array_item_and_size": lambda s, F: s.createDataFrame(
        _array_table()).select(F.col("k"),
                               F.get_item(F.col("a"), 1).alias("second"),
                               F.size(F.col("a")).alias("n")),
    "explode_split_fused": lambda s, F: s.createDataFrame(
        {"id": [1, 2, 3, 4, 5], "s": ["a,bb,ccc", "", None, "x", ",y,"]}
    ).select(F.col("id"), F.explode(F.split(F.col("s"), ",")).alias("w")),
    "posexplode_split_positions": lambda s, F: s.createDataFrame(
        {"s": ["one two", "three", "a b c d"]}).select(
        F.posexplode(F.split(F.col("s"), " "))),
    "explode_then_groupby": lambda s, F: s.createDataFrame(
        {"s": ["a,b,a", "b,c", "a"]}).select(
        F.explode(F.split(F.col("s"), ",")).alias("w")).groupBy("w").agg(
        F.count("*").alias("n")),
    "explode_large_random": lambda s, F: s.createDataFrame(
        _random_arrays()).select(F.col("k"), F.posexplode(F.col("a"))),
    "null_elements_collect": lambda s, F: s.createDataFrame(
        _null_elements()),
    "null_elements_element_at": lambda s, F: s.createDataFrame(
        _null_elements()).select(F.col("id"),
                                 F.element_at(F.col("a"), 2).alias("e")),
    "null_elements_explode": lambda s, F: s.createDataFrame(
        _null_elements()).select(F.col("id"),
                                 F.explode(F.col("a")).alias("v")),
    "element_at_negative_index": lambda s, F: s.createDataFrame(
        {"a": [[1, 2, 3], [7], None, []]}).select(
        F.element_at(F.col("a"), -1).alias("last"),
        F.element_at(F.col("a"), 1).alias("first")),
    "map_roundtrip": lambda s, F: s.createDataFrame(_map_table()),
    "get_map_value": lambda s, F: s.createDataFrame(_map_table()).select(
        F.col("k"), F.get_item(F.col("m"), 2).alias("two"),
        F.element_at(F.col("m"), 1).alias("one")),
    "map_keys_values_size": lambda s, F: s.createDataFrame(
        _map_table()).select(F.col("k"), F.map_keys(F.col("m")).alias("ks"),
                             F.map_values(F.col("m")).alias("vs"),
                             F.size(F.col("m")).alias("n")),
    "create_map": lambda s, F: s.createDataFrame(
        {"a": [1, 2, 3, 2], "b": [10, 20, None, 40]}).select(
        F.create_map(F.col("a"), F.col("b")).alias("m")),
    "create_map_last_win_dedup": lambda s, F: s.createDataFrame(
        {"a": [7, 7], "x": [1, 2], "y": [3, 4]}).select(
        F.create_map(F.col("a"), F.col("x"), F.col("a"),
                     F.col("y")).alias("m")),
    "create_map_first_position_last_value": lambda s, F: s.createDataFrame(
        {"a": [2, 5], "x": [1, 2], "y": [3, 4]}).select(
        F.map_keys(F.create_map(F.lit(1), F.col("x"), F.col("a"), F.col("y"),
                                F.lit(1), F.col("x") + F.lit(10))).alias("ks"),
        F.map_values(F.create_map(F.lit(1), F.col("x"), F.col("a"),
                                  F.col("y"), F.lit(1),
                                  F.col("x") + F.lit(10))).alias("vs")),
    "map_then_filter_groupby": lambda s, F: s.createDataFrame(
        _map_groupby_data()).select(
        F.col("g"), F.get_item(F.col("m"), 99).alias("v")).groupBy("g").agg(
        F.sum("v").alias("sv"), F.count("*").alias("c")),
    "float_key_map": lambda s, F: s.createDataFrame(
        {"m": [{1.5: 10}, {2.5: 20}, None]}).select(
        F.get_item(F.col("m"), 1.5).alias("x")),
    "get_item_numpy_key": lambda s, F: s.createDataFrame(
        {"m": [{1: 2.0}, {3: 4.0}]}).select(
        F.get_item(F.col("m"), np.int64(1)).alias("x"),
        F.element_at(F.col("m"), np.int64(3)).alias("y")),
    "empty_map_only_column": lambda s, F: s.createDataFrame(
        {"m": [{}, None]}).select(F.size(F.col("m")).alias("n")),
    "float_lookup_key_on_int_map": lambda s, F: s.createDataFrame(
        {"m": [{1: 2}, {2: 3}]}).select(
        F.get_item(F.col("m"), 1.5).alias("x")),
    "map_infer_widens_across_rows": lambda s, F: s.createDataFrame(
        {"m": [{1: 1}, {2: 2.5}]}),
    "bigint_lookup_on_narrow_key_map": lambda s, F: s.createDataFrame(
        {"m": [{1: 10}, {(1 << 32) + 1: 20}]}).select(
        F.get_item(F.col("m"), F.lit((1 << 32) + 1)).alias("x")),
    "struct_collect": lambda s, F: s.createDataFrame(_struct_table()),
    "struct_getfield_filter": lambda s, F: s.createDataFrame(
        _struct_table()).select(
        F.col("id"), F.col("s").getField("x").alias("x"),
        F.col("s").getField("y").alias("y")).filter(F.col("x") > 0),
    "struct_getfield_aggregate": lambda s, F: s.createDataFrame(
        _struct_table()).groupBy(F.col("s").getField("x").alias("x")).agg(
        F.count("*").alias("c")),
    "struct_whole_use": lambda s, F: s.createDataFrame(
        _struct_table()).filter(F.col("id") <= 2).select(F.col("s")),
    "nested_struct_collect": lambda s, F: s.createDataFrame(pa.table({
        "id": [1, 2],
        "s": pa.array([{"p": {"a": 5}}, {"p": {"a": 6}}],
                      type=pa.struct([("p", pa.struct([("a",
                                                          pa.int64())]))]))})),
    "struct_device_getfield_no_shred": lambda s, F: s.createDataFrame(
        _struct_table()).join(
        s.createDataFrame({"rid": [1, 3], "w": [1.0, 3.0]}),
        on=(F.col("id") == F.col("rid"))).select(
        F.col("s").getField("x").alias("sx"), F.col("w")),
}


def _f(side):
    return JF if side == "jax" else PF


def _port(conf=None):
    return TpuSession.builder.config({**QUIET, **(conf or {}),
                                      "spark.rapids.torch.device": "cpu"}
                                     ).getOrCreate()


def _jax(conf=None):
    return JaxSession.builder.config({**QUIET, **(conf or {})}).getOrCreate()


def _rows(df):
    return sorted(df.collect(), key=repr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_nested_query_matches_jax(name):
    q = CASES[name]
    want = _rows(q(_jax(), JF))
    got = _rows(q(_port(), PF))
    assert repr(got) == repr(want), f"{name}:\nport {got}\njax  {want}"


def test_struct_shreds_and_survives_a_shuffled_join():
    """getField-only use shreds the struct into flat scan columns; a whole
    struct rides a shuffled join and a sort as a StructColumn."""
    s = _port()
    df = CASES["struct_getfield_filter"](s, PF)
    assert df.collect() == [(1, 1, 2.5), (2, 3, 4.5), (4, 7, None)]
    scans = [n for n in str(s.last_plan()).splitlines() if "Scan" in n]
    assert scans and all("s.x" in n and "s.y" in n for n in scans), scans
    conf = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": "-1",
            "spark.rapids.tpu.sql.shuffle.partitions": "2"}
    rows = {}
    for side, sess in (("jax", _jax(conf)), ("port", _port(conf))):
        F = _f(side)
        left = sess.createDataFrame(_struct_table())
        right = sess.createDataFrame({"rid": [1, 2, 4, 9],
                                      "w": [10.0, 20.0, 40.0, 90.0]})
        df = left.join(right, on=(F.col("id") == F.col("rid")),
                       how="inner").orderBy(F.col("id").desc())
        rows[side] = df.collect()
        if side == "port":
            batch = df.collect_batch()
            assert isinstance(batch.columns[1], StructColumn)
            assert "TpuShuffledJoinExec" in str(sess.last_plan())
    assert rows["port"] == rows["jax"] == [
        (4, {"x": 7, "y": None}, 4, 40.0),
        (2, {"x": 3, "y": 4.5}, 2, 20.0),
        (1, {"x": 1, "y": 2.5}, 1, 10.0)]


PAYLOAD_ROWS = 128     # two full batches of 64: every concat a power of two


def _payload_table(n=PAYLOAD_ROWS, with_map=True):
    """Row id ``i``, a key and ARRAY, STRUCT (and MAP) payloads. The JAX
    engine gets no MAP column: its concat of a map's 3W-wide lanes leaves
    a width that is no power of two in its compiled signatures, which
    tests/test_zz_recompile_gate.py flags; the port's maps are checked
    against the input rows instead."""
    rng = np.random.default_rng(5)
    arrays = [None if i % 11 == 0 else
              [int(x) for x in rng.integers(0, 50, i % 4)]
              for i in range(n)]
    structs = [None if i % 7 == 0 else {"u": int(i), "v": f"r{i % 9}"}
               for i in range(n)]
    cols = {
        "i": list(range(n)),
        "k": [int(x) for x in rng.integers(0, 40, n)],
        "a": pa.array(arrays, type=pa.list_(pa.int64())),
        "st": pa.array(structs, type=pa.struct([("u", pa.int64()),
                                                ("v", pa.string())]))}
    if with_map:
        cols["m"] = pa.array([None if m is None else list(m.items())
                              for m in _payload_maps(n)],
                             type=pa.map_(pa.int64(), pa.float64()))
    return pa.table(cols)


def _payload_maps(n):
    return [None if i % 13 == 0 else {int(i % 5): float(i), 7: None}
            for i in range(n)]


EXCHANGES = {
    "hash": lambda df, F: df.repartition(2, F.col("k")),
    "round_robin": lambda df, F: df.repartition(2),
    "range": lambda df, F: df.repartition(2).orderBy(F.col("k")),
    "fused_filter": lambda df, F: df.filter(F.col("k") > 5).filter(
        F.col("k") < 30),
}


@pytest.mark.parametrize("name", sorted(EXCHANGES))
def test_nested_payloads_through_exchanges(name):
    """ARRAY, MAP and STRUCT payload columns ride the hash, round-robin
    and range splits and a fused filter (K19's mask, K5's compaction)
    that does not read them."""
    conf = {"spark.rapids.tpu.sql.shuffle.partitions": "2",
            "spark.rapids.tpu.sql.reader.batchSizeRows": "64"}
    want = _rows(EXCHANGES[name](_jax(conf).createDataFrame(
        _payload_table(with_map=False)), JF))
    sess = _port(conf)
    got = EXCHANGES[name](sess.createDataFrame(_payload_table()),
                          PF).collect()
    if name == "fused_filter":
        d = sess.last_fusion_decisions()
        assert [g[1] for g in d.generated] == ["K19 fused_stage"]
    maps = _payload_maps(PAYLOAD_ROWS)
    assert all(r[4] == maps[r[0]] for r in got)
    assert repr(sorted((r[:4] for r in got), key=repr)) == repr(want)


def test_map_width_harmonization_concat():
    """Interleaved map lanes survive the right-padding of a concat (in the
    map's own int64 dtype)."""
    sch = pdt.Schema([pdt.Field("m", pdt.MAP(pdt.INT64, pdt.INT64))])
    narrow = ColumnarBatch.from_numpy_dict({"m": [{1: 10}]}, sch, "cpu")
    wide = ColumnarBatch.from_numpy_dict(
        {"m": [{i: i * 2 for i in range(7)}]}, sch, "cpu")
    assert narrow.columns[0].data.shape[1] < wide.columns[0].data.shape[1]
    out = concat_batches(sch, [narrow, wide], "cpu")
    assert out.rows() == [({1: 10},), ({i: i * 2 for i in range(7)},)]


# what the JAX engine runs on its host engine: the port raises
RAISES = {
    "create_map_float": (lambda s, F: s.createDataFrame(
        {"a": [1, 2], "x": [1.5, 2.5]}).select(
        F.create_map(F.col("a"), F.col("x")).alias("m")), "floating"),
    "split_outside_generate": (lambda s, F: s.createDataFrame(
        {"s": ["a,b", "c"]}).select(
        F.size(F.split(F.col("s"), ",")).alias("n")), "outside a generate"),
    "string_key_map": (lambda s, F: s.createDataFrame(
        {"m": [{"a": 1}, None]}).select(
        F.get_item(F.col("m"), F.lit("a")).alias("x")), "A6"),
    "regex_delimiter_dot": (lambda s, F: s.createDataFrame(
        {"s": ["a.b"]}).select(F.explode(F.split(F.col("s"), "."))),
        "regex metacharacter"),
    "regex_delimiter_bar": (lambda s, F: s.createDataFrame(
        {"s": ["a|b"]}).select(F.explode(F.split(F.col("s"), "|"))),
        "regex metacharacter"),
    "struct_group_key": (lambda s, F: s.createDataFrame(
        _struct_table()).groupBy(F.col("s")).agg(F.count("*")),
        "struct-typed keys"),
}


@pytest.mark.parametrize("name", sorted(RAISES))
def test_host_engine_cases_raise(name):
    q, match = RAISES[name]
    with pytest.raises(NotImplementedError, match=match):
        q(_port(), PF).collect()


def test_regex_split_is_a_reference_fault():
    """Spark's split takes a regex: split('a.b', '.') gives four empty
    strings ('.' matches every character), where the reference splits on
    the byte. The reference's answer, recorded in ROADMAP queue C."""
    got = _jax().createDataFrame({"s": ["a.b"]}).select(
        JF.explode(JF.split(JF.col("s"), ".")).alias("w")).collect()
    assert got == [("a",), ("b",)]
