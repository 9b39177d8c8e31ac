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


def _pair(values, tname: str, cap: int = CAP):
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=cap)
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
    """K1 and K4 reduce fixed-width values only: a string MIN/MAX/FIRST/LAST
    reaches them as ranks or row indices (see the string parity tests), and
    handing them string values raises, on the kernel and its twin alike."""
    _jc, pc = _pair(["a", "b", None], "string")
    live = torch.arange(CAP) < 3
    seg = torch.zeros(CAP, dtype=torch.int32)
    spec = PA.AggSpec(op, pc)
    for fn in (lambda: PA.masked_reduce(spec, live),
               lambda: PA._masked_reduce_torch(spec, live),
               lambda: PA.segment_reduce(spec, seg, live, 128),
               lambda: PA._segment_reduce_torch(spec, seg, live, 128)):
        with pytest.raises(TypeError):
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


# ---------------------------------------------------------------------------
# Ids in any order (K9), string MIN/MAX/FIRST/LAST
# ---------------------------------------------------------------------------

def _shuffled_ids(rng, k: int):
    ids = rng.permutation(np.arange(CAP) % k).astype(np.int32)
    ids[rng.random(CAP) < 0.02] = k + 3        # out of range: dropped
    return ids


@pytest.mark.parametrize("op", ["count_star", "count", "sum", "avg"])
def test_segment_aggregate_matmul_shuffled_ids_matches_jax(op):
    """The reference's one-hot form takes ids in any order; so must the
    port on the card (K9), where K4 needs runs."""
    rng = np.random.default_rng(zlib.crc32(f"shuffled{op}".encode()))
    vals = rng.uniform(900, 105000, N)
    jc, pc = _pair([None if rng.random() < 0.1 else float(x) for x in vals],
                   "double")
    seg = _shuffled_ids(rng, 61)
    live = np.arange(CAP) < N
    col = (None, None) if op == "count_star" else (jc, pc)
    want = JA.segment_aggregate_matmul(JA.AggSpec(op, col[0]), seg, live, 64)
    got = PA.segment_aggregate_matmul(PA.AggSpec(op, col[1]),
                                      torch.from_numpy(seg),
                                      torch.from_numpy(live), 64)
    assert_column_close(got, want, 1e-5, f"matmul shuffled/{op}")


def test_segment_aggregate_matmul_nan_stays_in_its_slot():
    """A NaN makes only its own slot's sum NaN. The reference's one-hot
    product multiplies it into every slot of its chunk (0 * NaN), so the
    port is held to numpy here (ROADMAP queue C)."""
    vals = [1.0, float("nan"), 2.0, 4.0, 8.0]
    jc, pc = _pair(vals, "double")
    seg = np.zeros(CAP, np.int32)
    seg[:5] = [0, 1, 2, 0, 2]
    live = np.arange(CAP) < 5
    got = PA.segment_aggregate_matmul(PA.AggSpec("sum", pc),
                                      torch.from_numpy(seg),
                                      torch.from_numpy(live), 4)
    assert got.data[0].item() == 5.0 and got.data[2].item() == 10.0
    assert np.isnan(got.data[1].item())
    want = JA.segment_aggregate_matmul(JA.AggSpec("sum", jc), seg, live, 4)
    assert np.isnan(np.asarray(want.data)[0])      # the reference's fault


@pytest.mark.parametrize("tname", TYPES)
def test_segment_aggregate_shuffled_few_segments_matches_jax(tname):
    """segment_aggregate with at most DENSE_MAX_SLOTS segments takes ids in
    any order (K9 on the card): every op against the scatter reference."""
    rng = np.random.default_rng(zlib.crc32(f"few{tname}".encode()))
    jc, pc = _pair(_values(rng, tname, "rows"), tname)
    seg = _shuffled_ids(rng, 37)
    live = (np.arange(CAP) < N) & (rng.random(CAP) < 0.9)
    for name, jspec, pspec in _specs(jc, pc):
        want = JA.segment_aggregate(jspec, seg, live, CAP, num_segments=40)
        got = PA.segment_aggregate(pspec, torch.from_numpy(seg),
                                   torch.from_numpy(live), CAP,
                                   num_segments=40)
        assert_column_close(got, want, 1e-12, f"{tname}/few/{name}")


MANY_SEGMENTS = 5000           # above DENSE_MAX_SLOTS: the sort route
MANY_CAP = 1 << 14


@pytest.mark.parametrize("tname", TYPES)
def test_segment_aggregate_shuffled_many_segments_matches_jax(tname):
    """Above DENSE_MAX_SLOTS segments the ids may still come in any order,
    as the reference's scatter takes them: the port stable-sorts the live
    rows by id and reduces the runs (K4 on the card). Ids out of range
    and dead rows are dropped; FIRST/LAST keep row order in a segment."""
    assert MANY_SEGMENTS > PA.DENSE_MAX_SLOTS
    rng = np.random.default_rng(zlib.crc32(f"many{tname}".encode()))
    n = MANY_CAP - 300
    jc, pc = _pair(_values(rng, tname, "rows", n), tname, MANY_CAP)
    seg = rng.integers(0, MANY_SEGMENTS, MANY_CAP).astype(np.int32)
    seg[rng.random(MANY_CAP) < 0.02] = -1
    seg[rng.random(MANY_CAP) < 0.02] = MANY_SEGMENTS + 3
    live = (np.arange(MANY_CAP) < n) & (rng.random(MANY_CAP) < 0.9)
    for name, jspec, pspec in _specs(jc, pc):
        want = JA.segment_aggregate(jspec, seg, live, MANY_CAP,
                                    num_segments=MANY_SEGMENTS)
        got = PA.segment_aggregate(pspec, torch.from_numpy(seg),
                                   torch.from_numpy(live), MANY_CAP,
                                   num_segments=MANY_SEGMENTS)
        assert_column_close(got, want, 1e-12, f"{tname}/many/{name}")


def _strings(rng, n: int = N):
    words = np.array(["", "a", "ab", "abc", "b", "ba", "zz", "A", "a\x00",
                      "MAIL", "SHIP", "abcdefghij"])
    return [None if rng.random() < 0.15 else str(words[i])
            for i in rng.integers(0, len(words), n)]


STRING_OPS = [("min", True), ("max", True), ("first", True),
              ("first", False), ("last", True), ("last", False)]


@pytest.mark.parametrize("kind", ["giant", "runs", "shuffled"])
def test_string_min_max_first_last_match_jax(kind):
    """Every slot a live row reaches matches the reference. A slot no row
    reaches is NULL in the port; the reference's string MIN/MAX reads
    segment_min's identity there as a rank and calls the slot valid (a
    group-by never shows it: its slots all hold rows)."""
    rng = np.random.default_rng(zlib.crc32(f"str{kind}".encode()))
    jc, pc = _pair(_strings(rng), "string")
    seg = _shuffled_ids(rng, 29) if kind == "shuffled" else \
        _segments(rng, kind)
    live = (np.arange(CAP) < N) & (rng.random(CAP) < 0.9)
    ns = 32 if kind == "shuffled" else CAP
    inr = live & (seg < ns)
    reached = torch.from_numpy(np.bincount(seg[inr], minlength=ns) > 0)
    for op, ign in STRING_OPS:
        want = JA.segment_aggregate(JA.AggSpec(op, jc, ign), seg, live, CAP,
                                    num_segments=ns)
        got = PA.segment_aggregate(PA.AggSpec(op, pc, ign),
                                   torch.from_numpy(seg),
                                   torch.from_numpy(live), CAP,
                                   num_segments=ns)
        assert not bool((got.validity & ~reached).any())
        want = JColumn(want.dtype, *[np.asarray(a)[reached.numpy()]
                                     for a in want.arrays()])
        got = PColumn(got.dtype, *[a[reached] for a in got.arrays()])
        assert_column_close(got, want, 0, f"{kind}/{op}/{ign}")
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))


def test_string_min_max_first_last_reduce_and_groupby_match_jax():
    rng = np.random.default_rng(99)
    jc, pc = _pair(_strings(rng), "string")
    jspecs = [JA.AggSpec(op, jc, ign) for op, ign in STRING_OPS]
    pspecs = [PA.AggSpec(op, pc, ign) for op, ign in STRING_OPS]
    for w, g in zip(JA.reduce_aggregate(jspecs, N, CAP),
                    PA.reduce_aggregate(pspecs, N, CAP)):
        assert_column_close(g, w, 0, "reduce")
        np.testing.assert_array_equal(g.lengths.numpy(),
                                      np.asarray(w.lengths))
    jk, pk = _pair(_values(rng, "int", "rows"), "int")
    jkeys, jaggs, jng = JA.groupby_aggregate([jk], jspecs, N, CAP)
    pkeys, paggs, png = PA.groupby_aggregate([pk], pspecs, N, CAP)
    assert int(png) == int(jng)
    for g, w in zip(paggs, jaggs):
        assert_column_close(g, w, 0, "groupby")


FAST_CAP = 1024


def _dpair(values, tname: str):
    return _pair(values, tname, cap=FAST_CAP)


def _floats(rng, n: int, null_frac: float = 0.1, mean: float = 0.0):
    return [None if rng.random() < null_frac else float(x)
            for x in rng.normal(mean, 10, n)]


def _rel(spec) -> float:
    """f64 results of the JAX hi/lo split (float SUM, AVG): 1e-5."""
    return 1e-5 if spec.op == "avg" or (
        spec.op == "sum" and spec.column.dtype.is_floating) else 0


# ---------------------------------------------------------------------------
# groupby_aggregate_fast: dispatch and results
# ---------------------------------------------------------------------------

def _fast_both(jkeys, pkeys, jspecs, pspecs, n, state=None):
    want = JA.groupby_aggregate_fast(jkeys, jspecs, n, FAST_CAP,
                                     allow_matmul=True, dense_state=state)
    pstate = None if state is None else {}
    tok, _stats = PA.groupby_fast_dispatch(pkeys, pspecs, n, FAST_CAP,
                                           allow_matmul=True,
                                           dense_state=pstate)
    got = PA.groupby_aggregate_fast(pkeys, pspecs, n, FAST_CAP,
                                    allow_matmul=True, dense_state=pstate)
    assert got[2] == want[2]
    for g, w in zip(got[0], want[0]):
        assert_column_close(g, w, 0, "key")
    for s, g, w in zip(pspecs, got[1], want[1]):
        assert_column_close(g, w, _rel(s), s.op)
    return tok.route, pstate, got


def test_groupby_fast_takes_the_dense_route_and_matches():
    rng = np.random.default_rng(23)
    n = 800
    jk, pk = _dpair([None if rng.random() < 0.05 else int(x)
                     for x in rng.integers(0, 200, n)], "bigint")
    jv, pv = _dpair(_floats(rng, n), "double")
    ops = ("sum", "avg", "count", "min", "max")
    route, _state, _got = _fast_both(
        [jk], [pk], [JA.AggSpec(o, jv) for o in ops],
        [PA.AggSpec(o, pv) for o in ops], n)
    assert route == "dense"


def test_groupby_fast_memo_flips_off_on_a_wide_span():
    jk, pk = _dpair([0, 10_000, 5, 10_000], "bigint")
    jv, pv = _dpair([1.0, 2.0, 3.0, 4.0], "double")
    jstate = {}
    route, pstate, _got = _fast_both([jk], [pk], [JA.AggSpec("sum", jv)],
                                     [PA.AggSpec("sum", pv)], 4, jstate)
    assert route == "dense" and pstate == {"enabled": False} == jstate
    # the next batch of the operator skips the dense stats entirely
    tok, _stats = PA.groupby_fast_dispatch([pk], [PA.AggSpec("sum", pv)], 4,
                                           FAST_CAP, dense_state=pstate)
    assert tok.route == "sort"


def test_groupby_fast_falls_back_on_f32_unsafe_floats():
    jk, pk = _dpair([1, 1, 2, 2], "bigint")
    jv, pv = _dpair([1e40, 3.0, float("inf"), 5.0], "double")
    _route, _state, got = _fast_both([jk], [pk], [JA.AggSpec("sum", jv)],
                                     [PA.AggSpec("sum", pv)], 4)
    assert got[1][0].data[:2].tolist() == [1e40 + 3.0, float("inf")]


def test_groupby_fast_sort_route_few_groups_uses_the_slot_form():
    """String keys: the sort route; few groups and float sums take the
    K9 (segment_aggregate_matmul) form, which both engines share."""
    rng = np.random.default_rng(41)
    n = 900
    jk, pk = _dpair([f"g{int(x)}" for x in rng.integers(0, 23, n)], "string")
    # positive values: the reference's hi/lo sums are good to ~1e-6 of the
    # magnitudes summed, so a relative bound needs sums that do not cancel
    jv, pv = _dpair(_floats(rng, n, mean=50.0), "double")
    ops = ("sum", "count", "avg", "count_star")
    route, _s, got = _fast_both(
        [jk], [pk], [JA.AggSpec(o, None if o == "count_star" else jv)
                     for o in ops],
        [PA.AggSpec(o, None if o == "count_star" else pv) for o in ops], n)
    assert route == "sort" and got[2] == 23
