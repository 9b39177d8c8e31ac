"""Window functions (B15) in the PyTorch port on the CPU, against the JAX
package on the same numpy inputs.

Each B15 function's port (K21 ranks and offsets, K22 running aggregates,
K23 frame bounds, K24 frame aggregates, K4 + gather for whole partitions;
on the CPU their plain twins run) is held to the reference's function
over a sorted batch with padding; integers, ranks, bounds and counts
exactly, floats within 1e-9 relative. TpuWindowExec through the DataFrame
API is held to the JAX engine (ROWS and RANGE frames, count(*), lead/lag
with string defaults, NaN and +-0.0 ties in the order key), and its plan
over an exchange to the reference's plan. Where the reference is at fault
(ROADMAP, queue C's table), the port is held to a numpy oracle of Spark's
rules instead.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JCol
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu.plan.overrides import Overrides
from spark_rapids_tpu.plan.window_exec import TpuWindowExec as JWindowExec

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.api.window import (DefaultRowsFrameWarning,
                                               Window)
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import window as W

REL = 1e-9
CAP = 512
# (rows, segment lengths): random segments, one segment, singletons, one row
SHAPES = {"random": 400, "one_segment": 300, "singletons": 200,
          "one_row": 1}


def _segments(rng, n, shape):
    if shape == "one_segment":
        lens = [n]
    elif shape == "singletons":
        lens = [1] * n
    else:
        lens, left = [], n
        while left:
            k = int(min(left, rng.integers(1, 40)))
            lens.append(k)
            left -= k
    return np.repeat(np.arange(len(lens), dtype=np.int64), lens)


class Sorted:
    """A batch sorted by (segment, order key) with CAP - n padding rows:
    the JAX package's segment arrays and the port's K3 outputs."""

    def __init__(self, rng, shape, okey="double"):
        n = SHAPES[shape]
        self.n = n
        self.pk = _segments(rng, n, shape)
        if okey == "double":
            # ascending per segment, NULLs first, ties, +-0.0 adjacent and
            # NaN last (Spark's order)
            pool = np.array([-2.5, -1.0, -0.0, 0.0, 0.0, 1.5, 1.5, 3.0,
                             np.nan, np.nan])
            vals = pool[rng.integers(0, len(pool), n)]
            valid = rng.random(n) >= 0.1
        else:
            lo, hi = -(1 << 31), (1 << 31) - 1
            pick = rng.integers(0, 3, n)
            vals = np.where(pick == 0, rng.integers(lo, lo + 40, n),
                            np.where(pick == 1, rng.integers(hi - 40, hi, n),
                                     rng.integers(-60, 60, n)))
            vals = vals.astype(np.int32)
            valid = rng.random(n) >= 0.1
        vals = np.where(valid, vals, 0).astype(vals.dtype)
        key = np.where(np.isnan(vals), np.inf, vals) if okey == "double" \
            else vals
        order = np.lexsort((key, valid, self.pk))
        self.ok, self.ok_valid = vals[order], valid[order]
        self.live = np.arange(CAP) < n
        seg = np.full(CAP, self.pk[-1], np.int32)
        seg[:n] = self.pk
        starts = np.zeros(CAP, bool)
        starts[:n] = np.r_[True, self.pk[1:] != self.pk[:-1]]
        self.j_seg, self.j_starts = jnp.asarray(seg), jnp.asarray(starts)
        self.j_live = jnp.asarray(self.live)
        self.j_okey = JCol.from_numpy(self.ok, validity=self.ok_valid,
                                      capacity=CAP)
        pcol = Column.from_numpy(self.pk, capacity=CAP)
        self.okey = Column.from_numpy(self.ok, validity=self.ok_valid,
                                      capacity=CAP)
        _s, self.seg, self.ng, self.first = K.segment_bounds([pcol], n, CAP)
        _s, self.peer, _g, self.peer_first = K.segment_bounds(
            [pcol, self.okey], n, CAP)


def _values(rng, n, dtype):
    if dtype == "double":
        vals = np.round(rng.normal(0, 100, n), 3)
    elif dtype == "float":
        vals = rng.integers(-4000, 4000, n).astype(np.float32) / 4
    elif dtype == "int":
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
    elif dtype == "bigint":
        vals = rng.integers(-10**12, 10**12, n).astype(np.int64)
    else:
        vals = rng.integers(8000, 11000, n).astype(np.int32)
    valid = rng.random(n) >= 0.15
    vals = np.where(valid, vals, 0).astype(vals.dtype)
    jt, pt = (jdt.DATE, pdt.DATE) if dtype == "date" else (None, None)
    return (JCol.from_numpy(vals, jt, valid, CAP),
            Column.from_numpy(vals, pt, valid, capacity=CAP))


def assert_column(got: Column, want: JCol, live, rel=REL, exact=False):
    gv = got.validity.numpy()
    wv = np.asarray(want.validity)
    np.testing.assert_array_equal(gv[live], wv[live])
    m = live & wv
    g = got.data.numpy()[m]
    w = np.asarray(want.data)[m]
    if exact or g.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rel, atol=1e-12)


# ---------------------------------------------------------------------------
# The B15 functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
def test_ranks_match_jax(shape):
    """row_number, rank and dense_rank (K21 with K3's peer groups) against
    row_number_k and rank_k over the reference's tie flags (NaN equals NaN,
    -0.0 equals 0.0, NULL equals NULL)."""
    s = Sorted(np.random.default_rng(1), shape)
    changed = JWindowExec._order_changed(None, [(s.j_okey, None)],
                                         jnp.arange(CAP), CAP)
    want = {"row_number": JW.row_number_k(s.j_seg, s.j_starts, CAP),
            "rank": JW.rank_k(s.j_seg, s.j_starts, changed, CAP, False),
            "dense_rank": JW.rank_k(s.j_seg, s.j_starts, changed, CAP, True)}
    for kind, w in want.items():
        got = W.window_rank(kind, s.seg, s.first, s.n, s.peer, s.peer_first)
        np.testing.assert_array_equal(got.numpy()[s.live],
                                      np.asarray(w)[s.live], err_msg=kind)


@pytest.mark.parametrize("offset", [-3, -1, 1, 2])
@pytest.mark.parametrize("default", [None, 7.5])
def test_shift_in_segment_matches_jax(offset, default):
    """lead/lag (K21's offset mode + gather) against shift_in_segment; with
    a default, the rows whose source falls past the batch's last live row
    are left to the Spark test below (the reference's fault)."""
    rng = np.random.default_rng(2)
    s = Sorted(rng, "random")
    jcol, pcol = _values(rng, s.n, "double")
    want = JW.shift_in_segment(jcol, s.j_seg, offset, default, CAP)
    got = W.shift_in_segment(pcol, s.seg, offset, default, s.n)
    rows = s.live.copy()
    if default is not None:
        idx = np.arange(CAP)
        rows &= ~((idx + offset >= s.n) & (np.asarray(s.j_seg) ==
                                           s.pk[-1]))
    assert_column(got, want, rows, exact=True)


def test_lead_default_past_the_last_row_follows_spark():
    """lead(v, 1, default) on the last row of the last partition is the
    default (Spark); the reference reads the padding row after it as in
    the same segment and returns NULL (ROADMAP, reference faults)."""
    seg = torch.tensor([0, 0, 1, 1, 1, 1, 1, 1], dtype=torch.int32)
    col = Column.from_numpy(np.array([1.0, 2.0, 3.0, 4.0, 5.0]), capacity=8)
    out = W.shift_in_segment(col, seg, 1, -1.0, 5)
    assert out.to_pylist(5) == [2.0, -1.0, 4.0, 5.0, -1.0]
    lag = W.shift_in_segment(col, seg, -1, -1.0, 5)
    assert lag.to_pylist(5) == [-1.0, 1.0, -1.0, 3.0, 4.0]


def test_string_lead_lag_with_default_match_jax():
    rng = np.random.default_rng(3)
    s = Sorted(rng, "random")
    words = np.array(["ab", "abc", "", "zebra crossing", "a"])
    vals = words[rng.integers(0, len(words), s.n)]
    valid = rng.random(s.n) >= 0.2
    items = [str(v) if ok else None for v, ok in zip(vals, valid)]
    jcol = JCol.from_pylist(items, jdt.STRING, capacity=CAP)
    pcol = Column.from_pylist(items, pdt.STRING, capacity=CAP)
    # a default of the column's width bucket (16 bytes): the reference
    # cannot select between two widths (the next test)
    for off in (-2, 1):
        want = JW.shift_in_segment(jcol, s.j_seg, off, "no such row", CAP)
        got = W.shift_in_segment(pcol, s.seg, off, "no such row", s.n)
        rows = s.live & ~((np.arange(CAP) + off >= s.n) &
                          (np.asarray(s.j_seg) == s.pk[-1]))
        g = got.to_pylist(CAP)
        w = want.to_pylist(CAP)
        assert [g[i] for i in np.nonzero(rows)[0]] == \
            [w[i] for i in np.nonzero(rows)[0]]


def test_string_default_wider_than_the_column_follows_spark():
    """A lag default wider than the column's width bucket: the reference's
    jnp.where over (cap, 8) and (cap, 16) byte matrices fails (ROADMAP,
    reference faults); the port pads both to the wider one."""
    seg = torch.tensor([0, 0, 0, 1, 1, 1, 1, 1], dtype=torch.int32)
    col = Column.from_pylist(["a", None, "bb", "c", "dd"], pdt.STRING,
                             capacity=8)
    out = W.shift_in_segment(col, seg, -1, "a longer default", 5)
    assert out.to_pylist(5) == ["a longer default", "a", None,
                                "a longer default", "c"]


RUN_OPS = ["count", "count_star", "sum", "avg", "min", "max"]


@pytest.mark.parametrize("shape", ["random", "one_segment", "one_row"])
@pytest.mark.parametrize("dtype", ["double", "int", "bigint", "float",
                                   "date"])
def test_running_agg_matches_jax(shape, dtype):
    """UNBOUNDED PRECEDING..CURRENT ROW (K22) against running_agg."""
    rng = np.random.default_rng(4)
    s = Sorted(rng, shape)
    jcol, pcol = _values(rng, s.n, dtype)
    for op in RUN_OPS:
        if op in ("sum", "avg") and dtype == "date":
            continue
        if op == "count_star":
            # the reference's exec passes the live mask as a column
            jarg = JCol(jdt.BOOL, s.j_live, s.j_live)
            want = JW.running_agg(op, jarg, s.j_seg, s.j_starts, s.j_live,
                                  CAP)
            got, _c = W.segmented_scan(op, None, s.seg, s.n)
        else:
            want = JW.running_agg(op, jcol, s.j_seg, s.j_starts, s.j_live,
                                  CAP)
            got, _c = W.segmented_scan(op, pcol, s.seg, s.n)
        assert_column(got, want, s.live)


def test_running_sum_stays_exact_per_segment():
    """A segment's running sum is taken over its own rows. The reference
    subtracts the prefix at the segment start from a prefix over the whole
    batch: after 3e16 in the first segment, its second segment's sums of
    1, 2, 3 read 0, 0, 4 (ROADMAP, reference faults)."""
    seg = torch.tensor([0, 0, 0, 1, 1, 1, 1, 1], dtype=torch.int32)
    col = Column.from_numpy(np.array([1e16, 1e16, 1e16, 1.0, 2.0, 3.0]),
                            capacity=8)
    got, count = W.segmented_scan("sum", col, seg, 6)
    assert got.to_pylist(6) == [1e16, 2e16, 3e16, 1.0, 3.0, 6.0]
    assert count[:6].tolist() == [1, 2, 3, 1, 2, 3]


def test_min_max_follow_spark_nan_order():
    """NaN is the largest value (Spark, and the port's K4): a running or
    framed MIN skips it while another value is there, MAX returns it. The
    reference's jnp.minimum returns NaN from the first NaN on (ROADMAP,
    reference faults). A NaN in a wide frame's float sum stays in that
    frame (the reference's batch-wide prefix carries it into every later
    frame)."""
    seg = torch.tensor([0] * 6 + [1] * 2, dtype=torch.int32)
    vals = np.array([1.0, np.nan, 0.5, 2.0, -0.0, 0.0])
    col = Column.from_numpy(vals, capacity=8)
    mn, _ = W.segmented_scan("min", col, seg, 6)
    mx, _ = W.segmented_scan("max", col, seg, 6)
    assert mn.to_pylist(6) == [1.0, 1.0, 0.5, 0.5, 0.0, 0.0]
    assert [math.isnan(x) for x in mx.to_pylist(6)] == \
        [False] + [True] * 5
    n = 200
    seg = torch.zeros(256, dtype=torch.int32)
    x = np.arange(n, dtype=np.float64)
    x[10] = np.nan
    col = Column.from_numpy(x, capacity=256)
    lo, hi = W.frame_bounds(seg, torch.zeros(256, dtype=torch.int32), 1, n,
                            -80, 0)
    total = W.frame_aggregate("sum", col, seg, n, lo, hi,
                              *W.frame_prefix("sum", col, seg, n))
    low = W.frame_aggregate("min", col, seg, n, lo, hi,
                            *W.frame_prefix("min", col, seg, n))
    got, lows = total.to_pylist(n), low.to_pylist(n)
    for i in range(n):
        frame = x[max(0, i - 80):i + 1]
        if np.isnan(frame).any():
            assert math.isnan(got[i])
        else:
            assert got[i] == frame.sum()
        assert lows[i] == np.nanmin(frame)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("specials", [
    {50: np.inf}, {120: -np.inf}, {50: np.inf, 120: -np.inf},
    {50: np.inf, 60: np.nan, 120: -np.inf}, {40: -np.inf, 41: -np.inf}])
def test_wide_frame_sum_takes_nan_and_infinities_from_the_prefix(dtype,
                                                                 specials):
    """A frame wider than the direct loop takes its float sum's NaN and
    infinities from K22's running packed count of them: +inf alone gives
    +inf, -inf alone -inf, both or a NaN give NaN, as a direct sum does;
    the frames around them keep their finite sums (numpy oracle)."""
    n = 300
    x = np.arange(n).astype(dtype)
    for i, v in specials.items():
        x[i] = v
    col = Column.from_numpy(x, capacity=512)
    seg = torch.zeros(512, dtype=torch.int32)
    for lower, upper in ((-80, 0), (-100, 100), (None, 70)):
        lo, hi = W.frame_bounds(seg, torch.zeros(512, dtype=torch.int32), 1,
                                n, lower, upper)
        prefix = W.frame_prefix("sum", col, seg, n)
        total = W.frame_aggregate("sum", col, seg, n, lo, hi, *prefix)
        mean = W.frame_aggregate("avg", col, seg, n, lo, hi, *prefix)
        got, means = total.to_pylist(n), mean.to_pylist(n)
        for i in range(n):
            a = 0 if lower is None else max(0, i + lower)
            frame = x[a:i + upper + 1].astype(np.float64)
            with np.errstate(invalid="ignore"):
                want = frame.sum()
            if np.isnan(want):
                assert math.isnan(got[i]) and math.isnan(means[i]), i
            else:
                assert got[i] == want, (i, got[i], want)
                assert means[i] == want / len(frame), i


ROW_FRAMES =[(-2, 2), (-3, 0), (0, 3), (None, 2), (-2, None), (1, 3),
              (-5, -2), (None, None)]


@pytest.mark.parametrize("lower,upper", ROW_FRAMES)
def test_frame_bounds_rows_match_jax(lower, upper):
    s = Sorted(np.random.default_rng(5), "random")
    jlo, jhi = JW.frame_bounds_rows(s.j_seg, s.j_starts, s.j_live, CAP,
                                    lower, upper)
    lo, hi = W.frame_bounds(s.seg, s.first, s.ng, s.n, lower, upper)
    _assert_bounds(lo, hi, jlo, jhi, s.live)


def _assert_bounds(lo, hi, jlo, jhi, rows):
    lo, hi = lo.numpy().astype(np.int64), hi.numpy().astype(np.int64)
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    empty, jempty = hi < lo, jhi < jlo
    np.testing.assert_array_equal(empty[rows], jempty[rows])
    m = rows & ~empty
    np.testing.assert_array_equal(lo[m], jlo[m])
    np.testing.assert_array_equal(hi[m], jhi[m])


RANGE_FRAMES = [(-10, 10), (-20, 0), (0, 15), (None, 5), (-7, None),
                (0, 0), (-(1 << 40), 3)]


@pytest.mark.parametrize("lower,upper", RANGE_FRAMES)
@pytest.mark.parametrize("shape", ["random", "one_segment"])
def test_frame_bounds_range_match_jax(lower, upper, shape):
    """RANGE bounds over an int32 key at the int32 edges, NULL keys a run
    of their own, against the reference's composite searchsorted."""
    s = Sorted(np.random.default_rng(6), shape, okey="int")
    jlo, jhi = JW.frame_bounds_range(s.j_okey, s.j_seg, s.j_starts,
                                     s.j_live, CAP, lower, upper)
    lo, hi = W.frame_bounds(s.seg, s.first, s.ng, s.n, lower, upper,
                            s.okey)
    _assert_bounds(lo, hi, jlo, jhi, s.live)


FRAME_OPS = ["count", "count_star", "sum", "avg", "min", "max"]


@pytest.mark.parametrize("frame", [("rows", -2, 2), ("rows", None, 3),
                                   ("rows", -60, None), ("rows", 1, 3),
                                   ("range", -10, 10), ("range", None, 5),
                                   ("range", 0, 15)])
@pytest.mark.parametrize("dtype", ["double", "int", "bigint"])
def test_bounded_frame_agg_matches_jax(frame, dtype):
    """K23 + K22's prefixes + K24 against bounded_frame_agg over the
    reference's bounds (narrow frames summed directly, wide ones through
    the prefixes and the min/max table)."""
    kind, lower, upper = frame
    rng = np.random.default_rng(7)
    s = Sorted(rng, "one_segment" if lower == -60 else "random",
               okey="int")
    jcol, pcol = _values(rng, s.n, dtype)
    key = s.okey if kind == "range" else None
    lo, hi = W.frame_bounds(s.seg, s.first, s.ng, s.n, lower, upper, key)
    if kind == "range":
        jlo, jhi = JW.frame_bounds_range(s.j_okey, s.j_seg, s.j_starts,
                                         s.j_live, CAP, lower, upper)
    else:
        jlo, jhi = JW.frame_bounds_rows(s.j_seg, s.j_starts, s.j_live, CAP,
                                        lower, upper)
    for op in FRAME_OPS:
        arg = None if op == "count_star" else pcol
        got = W.frame_aggregate(op, arg, s.seg, s.n, lo, hi,
                                *W.frame_prefix(op, arg, s.seg, s.n))
        want = JW.bounded_frame_agg(op, None if op == "count_star" else jcol,
                                    jlo, jhi, s.j_live, CAP)
        assert_column(got, want, s.live)


@pytest.mark.parametrize("op", ["count", "count_star", "sum", "avg", "min",
                                "max", "first", "last"])
def test_whole_partition_agg_matches_jax(op):
    rng = np.random.default_rng(8)
    s = Sorted(rng, "random")
    jcol, pcol = _values(rng, s.n, "double")
    want = JW.whole_partition_agg(op, None if op == "count_star" else jcol,
                                  s.j_seg, s.j_live, CAP)
    got = W.whole_partition_agg(op, None if op == "count_star" else pcol,
                                s.seg, torch.from_numpy(s.live), CAP)
    assert_column(got, want, s.live)


def test_frames_stay_linear_for_an_unbounded_end():
    """A frame to UNBOUNDED FOLLOWING over one 600-row segment reads each
    row's frame from the prefixes and the min/max table, not row by row:
    the twin's doubling table holds only the levels the widest frame
    needs, and the results equal a numpy oracle."""
    n = 600
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1000, n).astype(np.int64)
    col = Column.from_numpy(x, capacity=1024)
    seg = torch.zeros(1024, dtype=torch.int32)
    lo, hi = W.frame_bounds(seg, torch.zeros(1024, dtype=torch.int32), 1, n,
                            -7, None)
    mx = W.frame_aggregate("max", col, seg, n, lo, hi,
                           *W.frame_prefix("max", col, seg, n))
    sm = W.frame_aggregate("sum", col, seg, n, lo, hi,
                           *W.frame_prefix("sum", col, seg, n))
    want_max = [int(x[max(0, i - 7):].max()) for i in range(n)]
    want_sum = [int(x[max(0, i - 7):].sum()) for i in range(n)]
    assert mx.to_pylist(n) == want_max
    assert sm.to_pylist(n) == want_sum


# ---------------------------------------------------------------------------
# TpuWindowExec through the DataFrame API
# ---------------------------------------------------------------------------

N_DF = 256     # a full power of two: no padding row (see the lead test)


def _frame_data(seed=10):
    rng = np.random.default_rng(seed)
    n = N_DF
    p = rng.integers(0, 9, n).astype(np.int64)
    f = np.array([-1.0, -0.0, 0.0, 2.5, np.nan])[rng.integers(0, 5, n)]
    words = np.array(["ab", "abc", "b", "", "abd"])
    return {
        "p": np.ma.masked_array(p, mask=rng.random(n) < 0.08),
        "o": np.ma.masked_array(rng.integers(0, 120, n).astype(np.int32),
                                mask=rng.random(n) < 0.1),
        "f": np.ma.masked_array(f, mask=rng.random(n) < 0.1),
        "v": np.ma.masked_array(np.round(rng.normal(0, 10, n), 3),
                                mask=rng.random(n) < 0.12),
        "s": np.ma.masked_array(words[rng.integers(0, 5, n)],
                                mask=rng.random(n) < 0.1),
        "u": rng.permutation(n).astype(np.int64)}


def _jax_df(session, data):
    """The same table for the JAX engine: NULLs where masked."""
    import pyarrow as pa

    def arrow(name, v):
        vals = v.tolist() if not isinstance(v, np.ma.MaskedArray) else \
            [None if m else x for x, m in zip(v.data.tolist(),
                                              np.ma.getmaskarray(v))]
        return pa.array(vals, type=pa.int32() if name == "o" else None)
    return session.createDataFrame(pa.table(
        {k: arrow(k, v) for k, v in data.items()}))


def _jax_session(**conf):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()


def _port_session(**conf):
    return TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()


def _windows(Fm, Wn):
    """The same window columns on either API (Fm: functions, Wn: Window)."""
    by_f = Wn.partitionBy("p").orderBy("f")
    by_s = Wn.partitionBy("p").orderBy("s")
    by_u = Wn.partitionBy("p").orderBy("u")
    by_o = Wn.partitionBy("p").orderBy("o")
    c = Fm.col
    return [c("p"), c("u"),
            Fm.row_number().over(by_u).alias("rn"),
            Fm.rank().over(by_f).alias("rk_f"),
            Fm.dense_rank().over(by_f).alias("dr_f"),
            Fm.rank().over(by_s).alias("rk_s"),
            Fm.lag("s", 1, "none").over(by_u).alias("lag_s"),
            Fm.lead("s", 2, "none").over(by_u).alias("lead_s"),
            Fm.lead("v", 1).over(by_u).alias("lead_v"),
            Fm.sum("v").over(by_u.rowsBetween(Wn.unboundedPreceding, 0))
            .alias("run_sum"),
            Fm.max("v").over(by_u.rowsBetween(Wn.unboundedPreceding, 0))
            .alias("run_max"),
            Fm.avg("v").over(by_u.rowsBetween(-2, 2)).alias("avg_22"),
            Fm.min("v").over(by_u.rowsBetween(-1, Wn.unboundedFollowing))
            .alias("min_1u"),
            Fm.count("*").over(by_u.rowsBetween(-3, 1)).alias("cnt_31"),
            Fm.count("v").over(by_u.rowsBetween(1, 3)).alias("cntv_13"),
            Fm.sum("v").over(by_o.rangeBetween(-10, 0)).alias("rsum"),
            Fm.max("v").over(by_o.rangeBetween(Wn.unboundedPreceding, 5))
            .alias("rmax"),
            Fm.sum("v").over(Wn.partitionBy("p")).alias("psum"),
            Fm.max("s").over(Wn.partitionBy("p")).alias("pmax_s"),
            (c("v") * 100 / Fm.sum("v").over(Wn.partitionBy("p")))
            .alias("ratio")]


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: (r[1],))


def assert_rows(got, want, rel=REL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float) and isinstance(x, float):
                if math.isnan(y):
                    assert math.isnan(x), (g, w)
                else:
                    assert x == pytest.approx(y, rel=rel, abs=1e-9), (g, w)
            else:
                assert x == y, (g, w)


def test_windows_through_the_session_match_jax_engine():
    """Ranks over NaN/-0.0/0.0 and string ties, lead/lag with string
    defaults, running, ROWS and RANGE frames, count(*) and whole-partition
    aggregates: the port's rows equal the JAX engine's."""
    data = _frame_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = _jax_session()
        want = _jax_df(js, data).select(*_windows(JF, JWindow)).collect()
        ps = _port_session()
        got = ps.createDataFrame(data).select(
            *_windows(F, Window)).collect()
    assert_rows(_sorted_rows(got), _sorted_rows(want))
    assert "TpuWindowExec" in ps.last_plan().operator_tree()


def test_ranks_equate_nan_signed_zero_and_null_ties():
    """K3's equality gives the reference's tie runs: NaN equals NaN, -0.0
    equals 0.0, NULL equals NULL; strings compare all their bytes and
    their length ("ab" < "abc")."""
    ps = _port_session()
    df = ps.createDataFrame({
        "p": np.zeros(8, np.int64),
        "f": np.ma.masked_array([np.nan, -0.0, 0.0, np.nan, 1.0, 0.0, 2.0,
                                 9.0], mask=[0, 0, 0, 0, 0, 0, 0, 1]),
        "s": np.array(["ab", "abc", "ab", "b", "abc", "a", "ab", "b"])})
    w = Window.partitionBy("p")
    rows = df.select(F.col("f"), F.col("s"),
                     F.rank().over(w.orderBy("f").rowsBetween(
                         Window.unboundedPreceding, 0)).alias("rf"),
                     F.dense_rank().over(w.orderBy("s").rowsBetween(
                         Window.unboundedPreceding, 0)).alias("ds")
                     ).collect()
    rank_f = {}
    for f, _s, rf, _ds in rows:
        key = "null" if f is None else ("nan" if math.isnan(f) else f)
        rank_f.setdefault(key, set()).add(rf)
    assert rank_f == {"null": {1}, 0.0: {2}, 1.0: {5}, 2.0: {6},
                      "nan": {7}}
    dense = {s: d for _f, s, _rf, d in rows}
    assert dense == {"a": 1, "ab": 2, "abc": 3, "b": 4}


def test_window_over_an_exchange_matches_jax_plan_and_rows():
    """A window partitioned by the grouping keys of an aggregate over an
    exchange: the reference's plan (TpuWindowExec -> TpuCoalesceBatchesExec
    -> TpuHashAggregateExec[final] -> TpuHashExchangeExec ...) and its
    rows, with 8 shuffle partitions."""
    rng = np.random.default_rng(11)
    n = 512
    data = {"k": rng.integers(0, 50, n).astype(np.int64),
            "g": rng.integers(0, 6, n).astype(np.int64),
            "v": np.round(rng.normal(0, 5, n), 2)}
    conf = {"spark.rapids.tpu.sql.shuffle.partitions": 8}

    def build(Fm, Wn, df):
        agg = df.repartition(4, "k").groupBy("g").agg(
            Fm.sum("v").alias("sv"), Fm.count("*").alias("c"))
        w = Wn.partitionBy("g")
        return agg.select(Fm.col("g"), Fm.col("sv"),
                          (Fm.col("sv") / Fm.sum("sv").over(w)).alias("t"),
                          Fm.row_number().over(w.orderBy("c").rowsBetween(
                              Wn.unboundedPreceding, 0)).alias("rn"))
    js = _jax_session(**conf)
    jdf = build(JF, JWindow, js.createDataFrame(data))
    want = sorted(jdf.collect())
    ps = _port_session(**conf)
    got = sorted(build(F, Window, ps.createDataFrame(data)).collect())
    assert_rows(got, want)
    tree = ps.last_plan().operator_tree()
    assert tree == str(Overrides(js.conf).apply(jdf._analyzed()))
    assert "TpuHashExchangeExec" in tree and "TpuWindowExec" in tree


def _raises(build, match):
    ps = _port_session()
    df = ps.createDataFrame({"p": np.array([1, 1, 2], np.int64),
                             "o": np.array([3, 1, 2], np.int32),
                             "d": np.array([1.0, 2.0, 3.0]),
                             "v": np.array([1.0, 2.0, 3.0])})
    with pytest.raises(NotImplementedError, match=match):
        build(df).collect()


def test_range_frame_outside_the_reference_scope_raises():
    """The reference sends these RANGE frames to its CPU engine; the port,
    which has none, raises naming the cause."""
    w = Window.partitionBy("p")
    _raises(lambda df: df.select(F.sum("v").over(
        w.orderBy(F.col("o").desc()).rangeBetween(-1, 1))), "descending")
    _raises(lambda df: df.select(F.sum("v").over(
        w.orderBy("o", "d").rangeBetween(-1, 1))), "exactly one order key")
    _raises(lambda df: df.select(F.sum("v").over(
        w.orderBy("d").rangeBetween(-1, 1))), "32-bit")


def test_first_over_a_running_frame_raises():
    _raises(lambda df: df.select(F.first("v").over(
        Window.partitionBy("p").orderBy("o").rowsBetween(-1, 1))),
        "first over a running or bounded window frame")


def test_window_over_unclustered_partitions_raises():
    """A window over partitions not clustered on its keys (4 round-robin
    partitions; a final aggregate hash-partitioned on (p, o) under a
    window over p): a window partition would span partitions, which the
    reference computes apart, with wrong rows (ROADMAP, reference
    faults)."""
    _raises(lambda df: df.repartition(4).select(F.sum("v").over(
        Window.partitionBy("p"))), "not clustered")
    _raises(lambda df: df.repartition(4, "o").groupBy("p", "o").agg(
        F.sum("v").alias("sv")).select(F.sum("sv").over(
            Window.partitionBy("p"))), "not clustered")


def test_ordered_spec_without_frame_warns():
    with pytest.warns(DefaultRowsFrameWarning):
        F.sum("v").over(Window.partitionBy("p").orderBy("o"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        F.sum("v").over(Window.partitionBy("p").orderBy("o")
                        .rowsBetween(-1, 1))
        F.sum("v").over(Window.partitionBy("p"))


def test_window_keys_survive_column_pruning():
    """The spec's keys are not children of the window expression: pruning
    must keep them at the scan."""
    ps = _port_session()
    df = ps.createDataFrame({"p": np.array([1, 1, 2], np.int64),
                             "o": np.array([3, 1, 2], np.int32),
                             "x": np.array([7, 8, 9], np.int64)})
    rows = df.select(F.row_number().over(Window.partitionBy("p").orderBy(
        "o").rowsBetween(-1, 0)).alias("rn")).collect()
    assert sorted(rows) == [(1,), (1,), (2,)]
