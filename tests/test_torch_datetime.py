"""Parity of the PyTorch port's date and time expressions
(ops/datetime.py) with the JAX package's, on the CPU.

Days span -800000 to 800000 (years -221 to 4160), with leap days, month
ends and the epoch's neighbours placed among them, 10% NULLs and dead rows
past the row count; timestamps before and after the epoch; month offsets
up to the int32 extremes. Every result is an integer or a date: compared
bit for bit, validity included. The same cases run through the generated
stage kernels in test_torch_stage_codegen.py.
"""

import datetime

import numpy as np
import pytest

from test_torch_scalar_exprs import (JAX, PORT, assert_columns_equal,
                                     eval_both, lit, make_batches, ref)

N, CAP = 230, 256
_EPOCH = datetime.date(1970, 1, 1)
SPECIAL_DAYS = [(datetime.date(*d) - _EPOCH).days for d in (
    (2000, 2, 29), (1900, 2, 28), (1900, 3, 1), (2100, 2, 28), (1996, 2, 29),
    (1970, 1, 1), (1969, 12, 31), (2024, 12, 31), (2023, 1, 31),
    (1600, 2, 29), (1, 1, 1))] + [-800000, 800000, -1, 0, 59, 60]


def _arrays(seed: int):
    rng = np.random.default_rng(seed)

    def days():
        v = rng.integers(-800000, 800001, CAP).astype(np.int32)
        pick = rng.random(CAP) < 0.3
        v[pick] = rng.choice(SPECIAL_DAYS, int(pick.sum()))
        return v

    def valid():
        ok = rng.random(CAP) >= 0.1
        ok[N:] = False
        return ok

    ts = rng.integers(-5 * 10 ** 16, 5 * 10 ** 16, CAP, dtype=np.int64)
    ts[:8] = [-1, 0, 1, -86_400_000_000, 86_399_999_999, -999_999,
              -3_600_000_001, 951_782_400_000_000]
    k = rng.integers(-30000, 30000, CAP).astype(np.int32)
    k[:6] = [2 ** 31 - 1, -2 ** 31, 0, 1, -1, 12]
    secs = rng.integers(-10 ** 11, 10 ** 11, CAP, dtype=np.int64)
    out = {}
    for name, v, tname in (("d", days(), "date"), ("e", days(), "date"),
                           ("ts", ts, "timestamp"), ("k", k, "int"),
                           ("n", np.clip(k, -200000, 200000).astype(np.int64),
                            "bigint"),
                           ("sec", secs, "bigint")):
        ok = valid()
        out[name] = (np.where(ok, v, np.zeros((), v.dtype)).astype(v.dtype),
                     ok, tname)
    return out


@pytest.fixture(scope="module")
def batches():
    return make_batches({}, 0, N, CAP, extra=_arrays(31))


def _part(cls, col):
    return lambda M, s: getattr(M.dtm, cls)(ref(M, s, col))


CASES = {f"{cls.lower()} {col}": (_part(cls, col), 0)
         for cls in ("Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek",
                     "WeekDay", "DayOfYear", "LastDay")
         for col in ("d", "ts")}
CASES.update({f"{cls.lower()} ts": (_part(cls, "ts"), 0)
              for cls in ("Hour", "Minute", "Second")})
CASES.update({
    "date_add column": (lambda M, s: M.dtm.DateAdd(ref(M, s, "d"),
                                                   ref(M, s, "k")), 0),
    "date_add literal": (lambda M, s: M.dtm.DateAdd(ref(M, s, "d"),
                                                    lit(M, 30, "int")), 0),
    "date_add bigint": (lambda M, s: M.dtm.DateAdd(ref(M, s, "d"),
                                                   ref(M, s, "n")), 0),
    "date_sub column": (lambda M, s: M.dtm.DateSub(ref(M, s, "d"),
                                                   ref(M, s, "k")), 0),
    "date_sub null": (lambda M, s: M.dtm.DateSub(ref(M, s, "d"),
                                                 lit(M, None, "int")), 0),
    "datediff": (lambda M, s: M.dtm.DateDiff(ref(M, s, "d"),
                                             ref(M, s, "e")), 0),
    "datediff literal": (lambda M, s: M.dtm.DateDiff(
        ref(M, s, "d"), lit(M, 9131, "date")), 0),
    "add_months column": (lambda M, s: M.dtm.AddMonths(
        ref(M, s, "d"), ref(M, s, "n")), 0),
    "add_months literal": (lambda M, s: M.dtm.AddMonths(
        ref(M, s, "d"), lit(M, 1, "int")), 0),
    "add_months -13": (lambda M, s: M.dtm.AddMonths(
        ref(M, s, "d"), lit(M, -13, "int")), 0),
    "unix_timestamp ts": (lambda M, s: M.dtm.UnixTimestamp(
        ref(M, s, "ts")), 0),
    "unix_timestamp date": (lambda M, s: M.dtm.UnixTimestamp(
        ref(M, s, "d")), 0),
    "from_unixtime": (lambda M, s: M.dtm.FromUnixTime(ref(M, s, "sec")), 0),
    "to_date ts": (lambda M, s: M.dtm.ToDate(ref(M, s, "ts")), 0),
    "to_date date": (lambda M, s: M.dtm.ToDate(ref(M, s, "d")), 0),
    "year of date_add": (lambda M, s: M.dtm.Year(M.dtm.DateAdd(
        ref(M, s, "d"), lit(M, 400, "int"))), 0),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_date_expression_matches_jax(batches, case):
    build, rel = CASES[case]
    j, p = eval_both(batches, build)
    assert_columns_equal(j, p, rel, case)


def test_year_of_a_literal_folds_on_the_host(batches):
    """year(DATE '2000-02-29') and a NULL date fold to scalars, equal to
    the JAX package's."""
    from spark_rapids_tpu_torch.columnar.column import Scalar
    jb, pb = batches[:2]
    for value in (11016, -719528, None):
        j = JAX.dtm.Year(lit(JAX, value, "date")).eval(jb)
        p = PORT.dtm.Year(lit(PORT, value, "date")).eval(pb)
        assert isinstance(p, Scalar) and p.value == j.value


def test_civil_round_trip_over_the_whole_range():
    """days -> (y, m, d) -> days is the identity from -800000 to 800000,
    and agrees with Python's calendar over its range (years 1-9999)."""
    import torch
    from spark_rapids_tpu_torch.ops.datetime import (civil_from_days,
                                                     days_from_civil)
    days = torch.arange(-800000, 800001, 997, dtype=torch.int32)
    y, m, d = civil_from_days(days)
    assert torch.equal(days_from_civil(y, m, d), days)
    for k in range(0, len(days), 37):
        dd = int(days[k])
        if -719162 <= dd <= 2932896:
            want = _EPOCH + datetime.timedelta(days=dd)
            assert (int(y[k]), int(m[k]), int(d[k])) == \
                (want.year, want.month, want.day)
