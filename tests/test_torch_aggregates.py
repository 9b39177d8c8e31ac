"""Parity of the PyTorch port's ops/aggregates.py with the JAX package's.

The same seeded columns go through the JAX functions (CPU, x64) and the
port on the CPU, where the wrappers run their plain PyTorch twins of K1
(masked_reduce) and K4 (segment_reduce). Tolerances: counts, integers,
bools and validity bit-exact; f64 sums and averages within 1e-12 relative
of segment_aggregate/reduce_aggregate; 1e-5 relative against
segment_aggregate_matmul, which is only that good itself (hi/lo f32
products, aggregates.py:275).
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

CAP = 512
N = 430
OPS = ("count_star", "count", "sum", "avg", "min", "max", "first", "last")
TYPES = ("bigint", "int", "double", "date", "boolean")


def _values(rng, tname: str, case: str, n: int = N):
    if case == "all_null":
        return [None] * n
    if tname == "double":
        v = rng.integers(-40, 40, n) / 4
        if case == "all_nan":
            v[:] = np.nan
        else:
            v[rng.random(n) < 0.1] = np.nan
        return [None if rng.random() < 0.1 else float(x) for x in v]
    if tname == "boolean":
        return [None if rng.random() < 0.1 else bool(x)
                for x in rng.integers(0, 2, n)]
    lo, hi = (-(1 << 40), 1 << 40) if tname == "bigint" else (-500, 500)
    return [None if rng.random() < 0.1 else int(x)
            for x in rng.integers(lo, hi, n)]


def _pair(values, tname: str):
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=CAP)
    return jc, PColumn(pdt.of(tname), *[torch.from_numpy(np.array(a))
                                         for a in jc.arrays()])


def _specs(jc, pc):
    out = []
    for op in OPS:
        for ign in ((True, False) if op in ("first", "last") else (True,)):
            jcol = None if op == "count_star" else jc
            pcol = None if op == "count_star" else pc
            out.append((f"{op}/{ign}", JA.AggSpec(op, jcol, ign),
                        PA.AggSpec(op, pcol, ign)))
    return out


def assert_column_close(got: PColumn, want: JColumn, rel: float, what: str):
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


REDUCE_CASES = [(t, c) for t in TYPES for c in ("rows", "mask", "empty",
                                                "all_null")] + \
    [("double", "all_nan")]


@pytest.mark.parametrize("tname,case", REDUCE_CASES)
def test_reduce_aggregate_matches_jax(tname, case):
    rng = np.random.default_rng(zlib.crc32(f"{tname}{case}".encode()))
    jc, pc = _pair(_values(rng, tname, case), tname)
    specs = _specs(jc, pc)
    num_rows = 0 if case == "empty" else N
    jmask = pmask = None
    if case == "mask":
        m = (rng.random(CAP) < 0.4) & (np.arange(CAP) < N)
        jmask, pmask = m, torch.from_numpy(m)
    want = JA.reduce_aggregate([s[1] for s in specs], num_rows, CAP,
                               live_mask=jmask)
    got = PA.reduce_aggregate([s[2] for s in specs], num_rows, CAP,
                              live_mask=pmask)
    for (name, _j, _p), g, w in zip(specs, got, want):
        assert g.dtype == pdt.of(w.dtype.name), name
        assert_column_close(g, w, 1e-12, f"{tname}/{case}/{name}")


def _segments(rng, kind: str):
    if kind == "giant":
        ids = np.zeros(N, np.int32)
    elif kind == "singletons":
        ids = np.arange(N, dtype=np.int32)
    else:
        ids = np.sort(rng.integers(0, 40, N)).astype(np.int32)
        ids = np.unique(ids, return_inverse=True)[1].astype(np.int32)
    full = np.full(CAP, ids[-1], np.int32)
    full[:N] = ids
    return full


SEGMENT_CASES = [(t, k, "rows") for t in TYPES
                 for k in ("giant", "singletons", "runs")] + \
    [("bigint", "runs", "all_null"), ("double", "runs", "all_nan"),
     ("double", "giant", "all_nan")]


@pytest.mark.parametrize("tname,kind,case", SEGMENT_CASES)
def test_segment_aggregate_matches_jax(tname, kind, case):
    rng = np.random.default_rng(zlib.crc32(f"{tname}{kind}{case}".encode()))
    jc, pc = _pair(_values(rng, tname, case), tname)
    seg = _segments(rng, kind)
    live = np.arange(CAP) < N
    for name, jspec, pspec in _specs(jc, pc):
        want = JA.segment_aggregate(jspec, seg, live, CAP)
        got = PA.segment_aggregate(pspec, torch.from_numpy(seg),
                                   torch.from_numpy(live), CAP)
        assert_column_close(got, want, 1e-12, f"{tname}/{kind}/{name}")


@pytest.mark.parametrize("masked", [False, True])
def test_groupby_aggregate_matches_jax(masked):
    rng = np.random.default_rng(11 + masked)
    jk1, pk1 = _pair([["A", "N", "R"][i] for i in rng.integers(0, 3, N)],
                     "string")
    jk2, pk2 = _pair(_values(rng, "int", "rows"), "int")
    jv, pv = _pair(_values(rng, "double", "rows"), "double")
    specs = _specs(jv, pv)
    jmask = pmask = None
    if masked:
        m = (rng.random(CAP) < 0.7) & (np.arange(CAP) < N)
        jmask, pmask = m, torch.from_numpy(m)
    jkeys, jaggs, jng = JA.groupby_aggregate(
        [jk1, jk2], [s[1] for s in specs], N, CAP, live_mask=jmask)
    pkeys, paggs, png = PA.groupby_aggregate(
        [pk1, pk2], [s[2] for s in specs], N, CAP, live_mask=pmask)
    assert int(png) == int(jng)
    for g, w in zip(pkeys, jkeys):
        for a, b in zip(g.arrays(), w.arrays()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for (name, _j, _p), g, w in zip(specs, paggs, jaggs):
        assert_column_close(g, w, 1e-12, f"groupby/{name}")


@pytest.mark.parametrize("op", ["count_star", "count", "sum", "avg"])
def test_segment_aggregate_matmul_matches_jax(op):
    rng = np.random.default_rng(zlib.crc32(op.encode()))
    vals = rng.uniform(900, 105000, N)
    vals = [None if rng.random() < 0.1 else float(x) for x in vals]
    jc, pc = _pair(vals, "double")
    seg = _segments(rng, "runs")
    live = np.arange(CAP) < N
    k = 64
    col = (None, None) if op == "count_star" else (jc, pc)
    want = JA.segment_aggregate_matmul(JA.AggSpec(op, col[0]), seg, live, k)
    got = PA.segment_aggregate_matmul(PA.AggSpec(op, col[1]),
                                      torch.from_numpy(seg),
                                      torch.from_numpy(live), k)
    assert_column_close(got, want, 1e-5, f"matmul/{op}")


@pytest.mark.parametrize("op", ["min", "max", "first", "sum"])
def test_string_aggregates_not_ported_raise(op):
    _jc, pc = _pair(["a", "b", None], "string")
    live = torch.arange(CAP) < 3
    seg = torch.zeros(CAP, dtype=torch.int32)
    spec = PA.AggSpec(op, pc)
    for fn in (lambda: PA.masked_reduce(spec, live),
               lambda: PA._masked_reduce_torch(spec, live),
               lambda: PA.segment_reduce(spec, seg, live, 128),
               lambda: PA._segment_reduce_torch(spec, seg, live, 128)):
        with pytest.raises(NotImplementedError):
            fn()


def test_string_count_matches_jax():
    jc, pc = _pair(["a", None, "b", "", None], "string")
    live = np.arange(CAP) < 5
    want = JA.reduce_aggregate([JA.AggSpec("count", jc)], 5, CAP)[0]
    got = PA.reduce_aggregate([PA.AggSpec("count", pc)], 5, CAP)[0]
    assert_column_close(got, want, 0, "count(string)")
    seg = np.zeros(CAP, np.int32)
    want = JA.segment_aggregate(JA.AggSpec("count", jc), seg, live, CAP)
    got = PA.segment_aggregate(PA.AggSpec("count", pc), torch.from_numpy(seg),
                               torch.from_numpy(live), CAP)
    assert_column_close(got, want, 0, "segment count(string)")
