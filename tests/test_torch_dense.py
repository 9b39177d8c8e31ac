"""Parity of the PyTorch port's dense-range and single-word group-by
(ops/aggregates.py: dense_key_stats, groupby_dense, groupby_singleword)
with the JAX package's (groupby_aggregate_fast's dispatch is tested in
test_torch_aggregates.py).

The same seeded columns go through the JAX functions (CPU, x64) and the
port on the CPU, where the K8, K9 and K10 wrappers run their plain PyTorch
twins. Tolerances: keys, counts, integer sums, MIN/MAX/FIRST/LAST and
validity bit-exact; dense_key_stats bit-exact; f64 sums and averages
within 1e-5 relative, because the JAX dense route sums through a hi/lo f32
split and is only that good itself (aggregates.py:275).
"""

import zlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import aggregates as JA

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import aggregates as PA

CAP = 1024
KEY_TYPES = ("tinyint", "smallint", "int", "bigint", "boolean", "date",
             "timestamp")


def _pair(values, tname: str, cap: int = CAP):
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=cap)
    return jc, PColumn(pdt.of(tname), *[torch.from_numpy(np.array(a))
                                         for a in jc.arrays()])


def _keys(rng, tname: str, n: int, lo: int = -40, span: int = 80,
          null_frac: float = 0.08):
    if tname == "boolean":
        return [None if rng.random() < null_frac else bool(x)
                for x in rng.integers(0, 2, n)]
    return [None if rng.random() < null_frac else int(lo + x)
            for x in rng.integers(0, span, n)]


def _floats(rng, n: int, nan_frac: float = 0.0, null_frac: float = 0.1,
            mean: float = 0.0):
    v = rng.normal(mean, 10, n)
    v[rng.random(n) < nan_frac] = np.nan
    return [None if rng.random() < null_frac else float(x) for x in v]


def assert_same(got: PColumn, want: JColumn, rel: float, what: str):
    """Validity and every slot's value (NULL slots included) equal;
    floats within ``rel``."""
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity),
                                  err_msg=f"{what}: validity")
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"{what}: NaN")
        fin = ~np.isnan(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=rel, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)
    if want.lengths is not None:
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths), err_msg=what)


def _rel(spec) -> float:
    """f64 results of the JAX hi/lo split: float SUM, and AVG of any type."""
    return 1e-5 if spec.op == "avg" or (
        spec.op == "sum" and spec.column.dtype.is_floating) else 0


# ---------------------------------------------------------------------------
# dense_key_stats (K8)
# ---------------------------------------------------------------------------

STATS_CASES = [(t, c) for t in KEY_TYPES
               for c in ("rows", "mask", "empty", "all_null")]


@pytest.mark.parametrize("tname,case", STATS_CASES)
def test_dense_key_stats_matches_jax_exactly(tname, case):
    rng = np.random.default_rng(zlib.crc32(f"{tname}{case}".encode()))
    n = 700
    lo = -(1 << 40) if tname in ("bigint", "timestamp") else -100
    jk, pk = _pair(_keys(rng, tname, n, lo=lo, span=120,
                         null_frac=1.0 if case == "all_null" else 0.08),
                   tname)
    jf, pf = _pair(_floats(rng, n, nan_frac=0.1), "double")
    f32 = [None if x is None else float(np.float32(x))
           for x in _floats(rng, n, nan_frac=0.1)]
    jg, pg = _pair(f32, "float")
    num_rows = 0 if case == "empty" else n
    jm = pm = None
    if case == "mask":
        m = rng.random(CAP) < 0.5
        jm, pm = m, torch.from_numpy(m)
    jr, jd = JA.dense_key_stats(jk, num_rows, extra_mask=jm,
                                float_cols=[jf, jg, jf])
    pr, pd = PA.dense_key_stats(pk, num_rows, extra_mask=pm,
                                float_cols=[pf, pg, pf])
    assert int(pr) == int(jr)
    np.testing.assert_array_equal(pd.numpy().view(np.int64),
                                  np.asarray(jd).view(np.int64))


# ---------------------------------------------------------------------------
# groupby_dense (K9): the cases of tests/test_aggregates.py
# ---------------------------------------------------------------------------

def _dense_both(jkey, pkey, jspecs, pspecs, num_rows, jmask=None,
                pmask=None):
    jr, jd = JA.dense_key_stats(jkey, num_rows, extra_mask=jmask)
    pr, pd = PA.dense_key_stats(pkey, num_rows, extra_mask=pmask)
    k_slots = 128
    while k_slots < float(np.asarray(jd)[0]) + 2:
        k_slots *= 2
    want = JA.groupby_dense(jkey, jspecs, num_rows, k_slots, jr,
                            extra_mask=jmask)
    got = PA.groupby_dense(pkey, pspecs, num_rows, k_slots, pr,
                           extra_mask=pmask)
    assert int(got[2]) == int(want[2])
    assert_same(got[0][0], want[0][0], 0, "key")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert_same(g, w, _rel(pspecs[i]), f"{pspecs[i].op} #{i}")
    return got


def _mixed_specs(jv, pv, jiv, piv):
    out = []
    for op, jc, pc in (("sum", jv, pv), ("count", jv, pv), ("avg", jv, pv),
                       ("min", jv, pv), ("max", jv, pv),
                       ("count_star", None, None), ("sum", jiv, piv),
                       ("min", jiv, piv), ("max", jiv, piv),
                       ("avg", jiv, piv)):
        out.append((JA.AggSpec(op, jc), PA.AggSpec(op, pc)))
    for op in ("first", "last"):
        for ign in (True, False):
            out.append((JA.AggSpec(op, jv, ign), PA.AggSpec(op, pv, ign)))
    return [s[0] for s in out], [s[1] for s in out]


@pytest.mark.parametrize("tname", KEY_TYPES)
def test_groupby_dense_matches_jax(tname):
    """test_dense_groupby_matches_sort_path's specs over every key type."""
    rng = np.random.default_rng(zlib.crc32(tname.encode()))
    n = 500
    jk, pk = _pair(_keys(rng, tname, n), tname)
    vv = _floats(rng, n, nan_frac=0.05)
    vv = [v if v is None or np.isnan(v) or rng.random() > 0.05 else -0.0
          for v in vv]
    jv, pv = _pair(vv, "double")
    jiv, piv = _pair([None if rng.random() < 0.1 else int(x) for x in
                      rng.integers(-10 ** 6, 10 ** 6, n)], "bigint")
    js, ps = _mixed_specs(jv, pv, jiv, piv)
    _dense_both(jk, pk, js, ps, n)


def test_groupby_dense_int64_sum_wraps_bit_exact():
    big = 3_000_000_000_000_000_000
    jk, pk = _pair([5, 5, 6, 6], "bigint")
    jv, pv = _pair([big, big, -big, 17], "bigint")
    got = _dense_both(jk, pk, [JA.AggSpec("sum", jv)],
                      [PA.AggSpec("sum", pv)], 4)
    exp0 = int(np.int64(np.uint64(big * 2 % (1 << 64))))
    assert got[1][0].data[:2].tolist() == [exp0, -big + 17]


def test_groupby_dense_negative_keys_and_null_group():
    jk, pk = _pair([-3, -1, None, -3], "int")
    jv, pv = _pair([1.0, 2.0, 3.0, 4.0], "double")
    got = _dense_both(jk, pk, [JA.AggSpec("sum", jv)],
                      [PA.AggSpec("sum", pv)], 4)
    assert got[0][0].validity[:3].tolist() == [True, True, False]
    assert got[1][0].data[:3].tolist() == [5.0, 2.0, 3.0]


def test_groupby_dense_extra_mask_folds_the_filter():
    jk, pk = _pair([1, 2, 1, 2], "bigint")
    jv, pv = _pair([10.0, 20.0, 30.0, 40.0], "double")
    m = np.zeros(CAP, bool)
    m[[0, 2]] = True
    got = _dense_both(jk, pk, [JA.AggSpec("sum", jv)],
                      [PA.AggSpec("sum", pv)], 4, m, torch.from_numpy(m))
    assert int(got[2]) == 1 and got[1][0].data[0].item() == 40.0


@pytest.mark.parametrize("case", ["all_null", "empty"])
def test_groupby_dense_all_null_keys_and_empty_input(case):
    n = 0 if case == "empty" else 2
    jk, pk = _pair([None] * n, "bigint")
    jv, pv = _pair([1.0, 2.0][:n], "double")
    got = _dense_both(jk, pk, [JA.AggSpec("sum", jv)],
                      [PA.AggSpec("sum", pv)], n)
    assert int(got[2]) == (1 if n else 0)


def test_groupby_dense_nan_poisons_only_its_group():
    nan = float("nan")
    jk, pk = _pair([1, 1, 2, 2], "bigint")
    jv, pv = _pair([nan, 2.0, 3.0, 4.0], "double")
    got = _dense_both(jk, pk, [JA.AggSpec("sum", jv), JA.AggSpec("avg", jv)],
                      [PA.AggSpec("sum", pv), PA.AggSpec("avg", pv)], 4)
    assert np.isnan(got[1][0].data[0].item())
    assert got[1][0].data[1].item() == 7.0 and got[1][1].data[1].item() == 3.5


def test_groupby_dense_4095_key_slots():
    """The widest span: 4095 keys and the NULL slot fill 4096 slots."""
    rng = np.random.default_rng(5)
    n = 4096
    keys = [None if rng.random() < 0.02 else int(x)
            for x in rng.integers(0, 4095, n)]
    keys[0], keys[1] = 0, 4094
    jk, pk = _pair(keys, "int", cap=n)
    jv, pv = _pair([float(x) for x in rng.integers(-8, 8, n)], "double",
                   cap=n)
    got = _dense_both(jk, pk, [JA.AggSpec("count", jv), JA.AggSpec("sum", jv)],
                      [PA.AggSpec("count", pv), PA.AggSpec("sum", pv)], n)
    assert got[0][0].capacity == 4096


# ---------------------------------------------------------------------------
# groupby_singleword (K10 + K9)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tname", ["tinyint", "int", "bigint", "boolean",
                                   "date"])
def test_groupby_singleword_matches_jax(tname):
    rng = np.random.default_rng(zlib.crc32(tname.encode()))
    n = 600
    span = 2 if tname == "boolean" else 200
    jk, pk = _pair(_keys(rng, tname, n, lo=-90 if tname == "tinyint" else
                         -(1 << 20), span=span), tname)
    jv, pv = _pair(_floats(rng, n), "double")
    m = rng.random(CAP) < 0.8
    specs = [("count_star", None, None), ("count", jv, pv),
             ("sum", jv, pv), ("avg", jv, pv)]
    want = JA.groupby_singleword(jk, [JA.AggSpec(o, j) for o, j, _ in specs],
                                 n, CAP, extra_mask=m)
    got = PA.groupby_singleword(pk, [PA.AggSpec(o, p) for o, _, p in specs],
                                n, CAP, extra_mask=torch.from_numpy(m))
    assert got[2] == want[2]
    assert_same(got[0][0], want[0][0], 0, "keys")
    for (op, _j, _p), g, w in zip(specs, got[1], want[1]):
        assert_same(g, w, 1e-5 if op in ("sum", "avg") else 0, op)


def test_groupby_singleword_none_above_4096_groups_and_empty():
    keys = list(range(5000))
    jk, pk = _pair(keys, "bigint", cap=8192)
    jv, pv = _pair([1.0] * 5000, "double", cap=8192)
    assert JA.groupby_singleword(jk, [JA.AggSpec("count", jv)], 5000,
                                 8192) is None
    assert PA.groupby_singleword(pk, [PA.AggSpec("count", pv)], 5000,
                                 8192) is None
    # exactly 4096 groups still fits
    got = PA.groupby_singleword(pk, [PA.AggSpec("count", pv)], 4096, 8192)
    assert got[2] == 4096
    jz, pz = _pair([], "bigint")
    assert JA.groupby_singleword(jz, [], 0, CAP) == ([], [], 0)
    assert PA.groupby_singleword(pz, [], 0, CAP) == ([], [], 0)


def test_groupby_singleword_int64_extremes_match_numpy():
    """Keys INT64_MAX and INT64_MAX - 1 are groups of their own. The JAX
    function encodes them as its padding and NULL words, so it drops the
    first and merges the second with the NULL group (ROADMAP queue C); the
    port tracks NULL and padding by masks and matches numpy."""
    top = (1 << 63) - 1
    vals = [top, top - 1, 5, None, top, 5, -3]
    jk, pk = _pair(vals, "bigint", cap=128)
    jv, pv = _pair([1.0] * 7, "double", cap=128)
    got = PA.groupby_singleword(pk, [PA.AggSpec("count", pv)], 7, 128)
    assert got[2] == 5
    assert got[0][0].data[:4].tolist() == [-3, 5, top - 1, top]
    assert got[0][0].validity[:5].tolist() == [True] * 4 + [False]
    assert got[1][0].data[:5].tolist() == [1, 2, 1, 2, 1]
    want = JA.groupby_singleword(jk, [JA.AggSpec("count", jv)], 7, 128)
    assert want[2] == 3          # the reference's fault, recorded


def test_slot_features_split_over_launches_when_a_block_cannot_hold_them():
    """K9 holds one 8-byte accumulator per slot and feature in a block's
    227 KB: at 4096 slots seven features fit a launch, so nine take two
    (ints first, each feature once); at 128 slots all sixteen fit one."""
    feats = [PA.SlotFeature(k) for k in ("fsum", "occ", "cnt", "isum", "nan",
                                         "imin", "imax", "fsum", "first")]
    launches = PA._slot_launches(feats, 4096)
    assert [len(x) for x in launches] == [7, 2]
    assert sorted(i for x in launches for i in x) == list(range(9))
    assert [feats[i].kind for i in launches[1]] == ["fsum", "fsum"]
    assert len(PA._slot_launches((feats + feats)[:16], 128)) == 1
    with pytest.raises(ValueError):
        PA._slot_launches(feats[:1], 1 << 15)
