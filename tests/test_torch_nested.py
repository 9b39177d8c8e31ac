"""ARRAY, MAP and STRUCT columns of the PyTorch port against the JAX package.

The kernels' level, on the CPU where the wrappers run their plain twins:
K25 ``explode_expand`` against ``explode_indices`` / ``explode_array``, K26
``split_count`` / ``split_place`` against ``split_part_counts`` /
``split_explode``, K27 ``map_lookup`` against ``GetMapValue``, K28
``map_build`` against ``CreateMap``, and ``GetArrayItem``, ``Size``,
``MapKeys``, ``MapValues`` and ``GetField`` against the JAX expressions, on
the same padded numpy inputs (through ``interop.batch_from_numpy``).
Integers, string bytes, lengths and validity are exact; floats are
compared bit for bit. The interop round trips of ARRAY, MAP and STRUCT
batches hold the port's flat arrays to the JAX batch's.
"""

import zlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.ops import arrays as JA
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.ops import maps as JM
from spark_rapids_tpu.ops import structs as JS

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import (Column, HostNested,
                                                    StructColumn)
from spark_rapids_tpu_torch.columnar.interop import (batch_from_numpy,
                                                     batch_to_numpy)
from spark_rapids_tpu_torch.ops import arrays as PA
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import maps as PM
from spark_rapids_tpu_torch.ops import structs as PS

ELEM_TYPES = ("boolean", "tinyint", "smallint", "int", "bigint", "float",
              "double", "date", "timestamp")


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _values(rng, tname: str, n: int):
    if tname == "boolean":
        return [bool(x) for x in rng.integers(0, 2, n)]
    if tname in ("float", "double"):
        v = (rng.integers(-400, 400, n) / 4).astype(np.float64)
        v[rng.random(n) < 0.05] = np.nan
        v[rng.random(n) < 0.05] = -0.0
        return [float(x) for x in v]
    lo, hi = {"tinyint": (-128, 128), "smallint": (-3000, 3000)}.get(
        tname, (-10 ** 6, 10 ** 6))
    return [int(x) for x in rng.integers(lo, hi, n)]


def _arrays(rng, tname: str, n: int, max_len: int):
    """Python arrays: NULL arrays, empty arrays and NULL elements."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.1:
            out.append(None)
        elif r < 0.2:
            out.append([])
        else:
            vals = _values(rng, tname, int(rng.integers(1, max_len + 1)))
            out.append([None if rng.random() < 0.1 else v for v in vals])
    return out


def _pair_batch(py: dict, schema):
    """(JAX batch, port batch) of the same padded arrays."""
    jb = JBatch.from_pydict(py, jdt.Schema(schema))
    fields = [(f.name, f.dtype.name) for f in jb.schema]
    pb = batch_from_numpy(fields, [np.asarray(a) for a in jb.flat_arrays()],
                          jb.num_rows)
    return jb, pb


def _same(got: torch.Tensor, want, what: str) -> None:
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    if g.dtype.kind == "f":
        it = np.int64 if g.itemsize == 8 else np.int32
        g, w = g.view(it), w.astype(g.dtype).view(it)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_column(got: Column, want, what: str) -> None:
    _same(got.validity, want.validity, f"{what} validity")
    _same(got.data, want.data, f"{what} data")
    if want.lengths is not None:
        _same(got.lengths, want.lengths, f"{what} lengths")
    if want.elem_validity is not None:
        _same(got.elem_validity, want.elem_validity, f"{what} elements")


# ---------------------------------------------------------------------------
# K25
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tname", ELEM_TYPES)
@pytest.mark.parametrize("max_len", [3, 64])
def test_explode_expand_matches_jax(tname, max_len):
    rng = _rng(f"k25 {tname} {max_len}")
    n = 90
    t = f"array<{tname}>"
    jb, pb = _pair_batch({"a": _arrays(rng, tname, n, max_len)}, [("a", t)])
    ja, pa_ = jb.columns[0], pb.columns[0]
    live_np = np.arange(ja.capacity) < n - 7          # some dead rows
    live_np[5] = False
    import jax.numpy as jnp
    total = int(np.where(live_np & np.asarray(ja.validity),
                         np.asarray(ja.lengths), 0).sum())
    from spark_rapids_tpu_torch.columnar.column import bucket
    out_cap = bucket(max(total, 1))
    others, jelem, jpos, jcount = JA.explode_array(
        ja, [], jnp.asarray(live_np), out_cap)
    jsrc, jpos_i, _ = JA.explode_indices(ja.lengths, ja.validity,
                                         jnp.asarray(live_np), out_cap)
    ex = PA.explode_expand(pa_.lengths, pa_.validity,
                           torch.from_numpy(live_np), pa_.data,
                           pa_.elem_validity)
    assert ex.count == int(jcount) == total
    assert ex.out_capacity == out_cap
    _same(ex.src, jsrc, "src")
    _same(ex.pos, jpos_i, "pos")
    _same(ex.values, jelem.data, "elements")
    _same(ex.values_valid, jelem.validity, "element validity")
    _, elem, pos = PA.explode_array(pa_, torch.from_numpy(live_np))
    _same_column(elem, jelem, "explode_array element")
    _same_column(pos, jpos, "explode_array pos")


def test_explode_expand_all_empty():
    ex = PA.explode_expand(torch.zeros(128, dtype=torch.int32),
                           torch.ones(128, dtype=torch.bool),
                           torch.ones(128, dtype=torch.bool))
    assert ex.count == 0 and ex.out_capacity == 128
    assert int(ex.src.abs().sum()) == 0 and int(ex.pos.abs().sum()) == 0


# ---------------------------------------------------------------------------
# K26
# ---------------------------------------------------------------------------

SPLIT_EDGES = ["", ",", ",,", "a,", ",a", "a,,b", "abc", "é,ü,😀", None,
               "x" * 15 + ",", ",," * 7 + "z"]


def _utf8_rows(rng, n: int):
    alphabet = ["a", "b", ",", " ", "é", "😀", "日", "|"]
    return [None if rng.random() < 0.1 else
            "".join(alphabet[i] for i in rng.integers(0, len(alphabet),
                                                      rng.integers(0, 5)))
            for _ in range(n)]


@pytest.mark.parametrize("delim", [",", "a"])
def test_split_parts_matches_jax(delim):
    rng = _rng(f"k26 {delim}")
    rows = SPLIT_EDGES + _utf8_rows(rng, 100)
    jb, pb = _pair_batch({"s": rows}, [("s", "string")])
    jc, pc = jb.columns[0], pb.columns[0]
    assert jc.data.shape[1] == 16        # "x" * 15 + "," fills the width
    d = ord(delim)
    live_np = np.arange(jc.capacity) < len(rows)
    import jax.numpy as jnp
    pre = JA.split_part_counts(jc, d)
    _same(PA.split_count(pc, d), pre[1].astype(jnp.int32), "counts")
    total = int(np.where(live_np, np.asarray(pre[1]), 0).sum())
    from spark_rapids_tpu_torch.columnar.column import bucket
    out_cap = bucket(max(total, 1))
    _others, jelem, jpos, jcount = JA.split_explode(
        jc, d, [], jnp.asarray(live_np), out_cap, precomputed=pre)
    ex, elem, pos = PA.split_explode(pc, d, torch.from_numpy(live_np))
    assert ex.count == int(jcount)
    _same_column(elem, jelem, "parts")
    _same_column(pos, jpos, "positions")


# ---------------------------------------------------------------------------
# K27, K28 and the other map and array expressions
# ---------------------------------------------------------------------------

MAP_CASES = {
    # map type, key values drawn from, lookup keys
    "int_double": ("map<bigint,double>", "bigint", [1, 7, 1 << 40]),
    "int_int": ("map<int,int>", "int", [3, -2, (1 << 32) + 3, 1.5]),
    "double_bigint": ("map<double,bigint>", "double", [0.5, -0.0, 2, 7.25]),
    "float_float": ("map<float,float>", "float", [0.25, 3]),
    "smallint_boolean": ("map<smallint,boolean>", "smallint", [5, 70000]),
    "date_timestamp": ("map<date,timestamp>", "date", [11]),
}


def _maps(rng, mtype: str, ktype: str, n: int):
    vtype = mtype[mtype.index(",") + 1:-1]
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        m = int(rng.integers(0, 9))
        keys = [k if isinstance(k, float) else int(k) % 13 - 3
                for k in _values(rng, ktype, m)]
        if ktype in ("float", "double"):
            keys = [float(int(k * 4) % 12) / 4 for k in keys if k == k]
        vals = [None if rng.random() < 0.15 else v
                for v in _values(rng, vtype, len(keys))]
        out.append(list(zip(keys, vals)))      # duplicate keys: LAST_WIN
    return out


def _bound(i, t, side):
    if side == "jax":
        return JE.BoundReference(i, jdt.of(t))
    return PE.BoundReference(i, pdt.of(t))


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_lookup_matches_jax(case):
    mtype, ktype, lookups = MAP_CASES[case]
    rng = _rng(f"k27 {case}")
    n = 70
    keys_col = [None if rng.random() < 0.1 else v
                for v in _values(rng, ktype, n)]
    if ktype in ("float", "double"):
        keys_col = [None if k is None else
                    k if k != k else float(int(k * 4) % 12) / 4
                    for k in keys_col]
    else:
        keys_col = [None if k is None else int(k) % 13 - 3
                    for k in keys_col]
    jb, pb = _pair_batch({"m": _maps(rng, mtype, ktype, n), "k": keys_col},
                         [("m", mtype), ("k", ktype)])
    keys = [("col", None)] + [("lit", v) for v in lookups]
    for kind, v in keys:
        if kind == "col":
            jk, pk = _bound(1, ktype, "jax"), _bound(1, ktype, "port")
        else:
            jk, pk = JE.Literal(v), PE.Literal(v)
        want = JM.GetMapValue(_bound(0, mtype, "jax"), jk).eval(jb)
        got = PM.GetMapValue(_bound(0, mtype, "port"), pk).eval(pb)
        _same_column(got, want, f"{case} key {v!r}")


@pytest.mark.parametrize("pairs", [2, 5])
def test_map_build_matches_jax(pairs):
    rng = _rng(f"k28 {pairs}")
    n = 100
    types = ["bigint", "int", "smallint", "boolean", "tinyint"]
    py, schema = {}, []
    for j in range(pairs):
        kt, vt = types[j % len(types)], types[(j + 2) % len(types)]
        ks = [int(x) for x in rng.integers(0, 3, n)]
        if kt == "boolean":
            ks = [bool(x % 2) for x in ks]
        py[f"k{j}"] = [None if rng.random() < 0.05 else k for k in ks]
        py[f"v{j}"] = [None if rng.random() < 0.2 else v
                       for v in _values(rng, vt, n)]
        schema += [(f"k{j}", kt), (f"v{j}", vt)]
    jb, pb = _pair_batch(py, schema)
    jkids = [_bound(i, t, "jax") for i, (_n, t) in enumerate(schema)]
    pkids = [_bound(i, t, "port") for i, (_n, t) in enumerate(schema)]
    want = JM.CreateMap(*jkids).eval(jb)
    got = PM.CreateMap(*pkids).eval(pb)
    assert got.dtype.name == want.dtype.name
    _same_column(got, want, f"create_map of {pairs} pairs")


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_map_keys_values_size_match_jax(case):
    mtype, ktype, _lookups = MAP_CASES[case]
    rng = _rng(f"keys {case}")
    jb, pb = _pair_batch({"m": _maps(rng, mtype, ktype, 50)},
                         [("m", mtype)])
    for jcls, pcls in ((JM.MapKeys, PM.MapKeys), (JM.MapValues, PM.MapValues),
                       (JA.Size, PA.Size)):
        want = jcls(_bound(0, mtype, "jax")).eval(jb)
        got = pcls(_bound(0, mtype, "port")).eval(pb)
        _same_column(got, want, f"{case} {pcls.__name__}")


@pytest.mark.parametrize("tname", ["bigint", "double", "boolean", "int"])
def test_array_item_and_size_match_jax(tname):
    rng = _rng(f"item {tname}")
    n = 60
    t = f"array<{tname}>"
    idx = [None if rng.random() < 0.1 else int(x)
           for x in rng.integers(-5, 6, n)]
    jb, pb = _pair_batch({"a": _arrays(rng, tname, n, 5), "i": idx},
                         [("a", t), ("i", "int")])
    cases = [(JE.Literal(v), PE.Literal(v)) for v in (0, 1, 4, -1, None)]
    cases.append((_bound(1, "int", "jax"), _bound(1, "int", "port")))
    for one_based in (False, True):
        for jk, pk in cases:
            want = JA.GetArrayItem(_bound(0, t, "jax"), jk,
                                   one_based=one_based).eval(jb)
            got = PA.GetArrayItem(_bound(0, t, "port"), pk,
                                  one_based=one_based).eval(pb)
            _same_column(got, want, f"{t}[{pk!r}] one_based={one_based}")
    _same_column(PA.Size(_bound(0, t, "port")).eval(pb),
                 JA.Size(_bound(0, t, "jax")).eval(jb), "size")


STRUCT_T = "struct<a:bigint,b:double,c:string,d:array<int>>"


def _structs(rng, n: int):
    out = []
    for i in range(n):
        if rng.random() < 0.15:
            out.append(None)
            continue
        out.append({"a": None if rng.random() < 0.1 else int(i * 7 - 50),
                    "b": float(rng.integers(-9, 9)) / 4,
                    "c": None if rng.random() < 0.2 else "x" * (i % 5),
                    "d": _arrays(rng, "int", 1, 4)[0]})
    return out


def test_get_field_matches_jax():
    rng = _rng("struct")
    jb, pb = _pair_batch({"s": _structs(rng, 80)}, [("s", STRUCT_T)])
    assert isinstance(pb.columns[0], StructColumn)
    for name in ("a", "b", "c", "d"):
        want = JS.GetField(_bound(0, STRUCT_T, "jax"), name).eval(jb)
        got = PS.GetField(_bound(0, STRUCT_T, "port"), name).eval(pb)
        _same_column(got, want, f"s.{name}")


# ---------------------------------------------------------------------------
# Layouts and interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tname", ["array<bigint>", "array<float>",
                                   "map<bigint,double>", "map<int,boolean>",
                                   STRUCT_T, "struct<p:struct<q:int>>"])
def test_interop_round_trip_matches_jax_flat_arrays(tname):
    rng = _rng(f"interop {tname}")
    n = 40
    if tname.startswith("array"):
        vals = _arrays(rng, tname[6:-1], n, 6)
    elif tname.startswith("map"):
        vals = _maps(rng, tname, tname[4:tname.index(",")], n)
    elif tname == STRUCT_T:
        vals = _structs(rng, n)
    else:
        vals = [None if i % 7 == 0 else {"p": None if i % 5 == 0 else
                                         {"q": i}} for i in range(n)]
    jb, pb = _pair_batch({"x": vals, "k": list(range(n))},
                         [("x", tname), ("k", "bigint")])
    assert repr(pb.rows()) == repr(jb.rows())      # NaN != NaN
    fields, flat, rows = batch_to_numpy(pb)
    assert rows == n and fields == [(f.name, f.dtype.name)
                                    for f in jb.schema]
    want = [np.asarray(a) for a in jb.flat_arrays()]
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        np.testing.assert_array_equal(a, b)
    # the port builds the same arrays from the python values itself
    host = HostNested.from_pylist(vals, pdt.of(tname),
                                  width=None)
    port = Column.from_pylist(vals, pdt.of(tname), capacity=jb.capacity)
    for a, b in zip(port.arrays(), jb.columns[0].arrays()):
        _same(a, b, f"{tname} from_pylist")
    assert len(host) == n


def test_unported_nested_types_raise():
    with pytest.raises(NotImplementedError, match="A6"):
        Column.from_pylist([{"a": 1}], pdt.of("map<string,bigint>"))
    with pytest.raises(NotImplementedError, match="A6"):
        Column.from_pylist([["a"]], pdt.ARRAY_STRING)
