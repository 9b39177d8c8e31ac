"""Parity of the PyTorch port's scalar expression families with the JAX
package's, on the CPU: the arithmetic (IntegralDivide, Remainder, Pmod,
UnaryMinus, UnaryPositive, Abs and the four operators), the conditionals
(If, CaseWhen, Coalesce, Nvl, NullIf, Greatest, Least), the predicates
(comparisons, EqualNullSafe, IsNaN, IS [NOT] NULL, IN, Kleene AND/OR/NOT),
the numeric casts and the math functions (ops/math_ops.py).

Every expression runs on one seeded batch through both packages: 10%
NULLs, dead rows past the row count, NaN, +-inf, +-0.0, the int8-int64
extremes, zero and -1 divisors. Integers, bools and floats from + - * /
are compared bit for bit (a NaN equals any NaN); the transcendental
functions within 1e-12 relative. The same cases run through the generated
stage kernels in test_torch_stage_codegen.py.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import arithmetic as jar
from spark_rapids_tpu.ops import cast as jcast
from spark_rapids_tpu.ops import conditionals as jco
from spark_rapids_tpu.ops import datetime as jdtm
from spark_rapids_tpu.ops import expressions as jex
from spark_rapids_tpu.ops import math_ops as jmo
from spark_rapids_tpu.ops import predicates as jpr

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import arithmetic as par
from spark_rapids_tpu_torch.ops import cast as pcast
from spark_rapids_tpu_torch.ops import conditionals as pco
from spark_rapids_tpu_torch.ops import datetime as pdtm
from spark_rapids_tpu_torch.ops import expressions as pex
from spark_rapids_tpu_torch.ops import math_ops as pmo
from spark_rapids_tpu_torch.ops import predicates as ppr

N, CAP = 230, 256
TRANSCENDENTAL_REL = 1e-12

JAX = types.SimpleNamespace(ex=jex, ar=jar, co=jco, pr=jpr, mo=jmo,
                            dtm=jdtm, Cast=jcast.Cast, dt=jdt)
PORT = types.SimpleNamespace(ex=pex, ar=par, co=pco, pr=ppr, mo=pmo,
                             dtm=pdtm, Cast=pcast.Cast, dt=pdt)

_F64_SPECIAL = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e308, -1e308, 1e-300,
                1.0, -1.0, 0.5, -2.5, 2.5]
_INT_SPECIAL = {np.int8: [-128, 127, -1, 0, 1],
                np.int16: [-32768, 32767, -1, 0, 1],
                np.int32: [-2 ** 31, 2 ** 31 - 1, -1, 0, 1],
                np.int64: [-2 ** 63, 2 ** 63 - 1, -1, 0, 1]}
# name -> (numpy dtype, SQL type name)
COLUMNS = {"x": (np.float64, "double"), "y": (np.float64, "double"),
           "f": (np.float32, "float"), "b": (np.int8, "tinyint"),
           "h": (np.int16, "smallint"), "i": (np.int32, "int"),
           "j": (np.int32, "int"), "l": (np.int64, "bigint"),
           "m": (np.int64, "bigint"), "t": (np.bool_, "boolean"),
           "u": (np.bool_, "boolean"), "p": (np.float64, "double")}


def column_values(rng, npdt, n: int, cap: int):
    """(values[cap], valid[cap]): random values with the type's special
    values sprinkled in, 10% NULL, dead rows past ``n``; NULL and dead
    rows zeroed (the layout's invariant)."""
    if npdt == np.bool_:
        v = rng.random(cap) < 0.5
    elif np.issubdtype(npdt, np.floating):
        v = rng.normal(0, 100, cap)
        special = _F64_SPECIAL if npdt == np.float64 else \
            [np.nan, np.inf, -np.inf, 0.0, -0.0, 3e38, -3e38, 1.0, -2.5]
        pick = rng.random(cap) < 0.25
        v[pick] = rng.choice(special, int(pick.sum()))
        v = v.astype(npdt)
    else:
        info = np.iinfo(npdt)
        v = rng.integers(max(info.min, -1000), min(info.max, 1000), cap,
                         dtype=np.int64)
        pick = rng.random(cap) < 0.25
        v[pick] = rng.choice(_INT_SPECIAL[npdt], int(pick.sum()))
        v = v.astype(npdt)
    valid = rng.random(cap) >= 0.1
    valid[n:] = False
    v = np.where(valid, v, np.zeros((), npdt)).astype(npdt)
    return v, valid


def make_batches(columns: dict, seed: int, n: int = N, cap: int = CAP,
                 extra=None):
    """(JAX batch, port batch, numpy arrays) over the same arrays.
    ``extra``: name -> (values, valid, SQL type) set by the caller."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, (npdt, tname) in columns.items():
        v, ok = column_values(rng, npdt, n, cap)
        arrays[name] = (v, ok, tname)
    arrays.update(extra or {})
    jcols, pcols, fields_j, fields_p = [], [], [], []
    for name, (v, ok, tname) in arrays.items():
        jcols.append(JColumn(jdt.of(tname), jnp.asarray(v),
                             jnp.asarray(ok)))
        pcols.append(PColumn(pdt.of(tname), torch.from_numpy(v.copy()),
                             torch.from_numpy(ok.copy())))
        fields_j.append(jdt.Field(name, jdt.of(tname)))
        fields_p.append(pdt.Field(name, pdt.of(tname)))
    jb = JBatch(jdt.Schema(fields_j), jcols, n)
    pb = PBatch(pdt.Schema(fields_p), pcols, n)
    return jb, pb, arrays


def ref(M, batch_schema, name):
    """A bound reference to column ``name`` in package M."""
    i = [f.name for f in batch_schema].index(name)
    f = batch_schema[i]
    return M.ex.BoundReference(i, M.dt.of(str(f.dtype)), True, name)


def lit(M, value, tname):
    return M.ex.Literal(value, M.dt.of(tname))


def assert_columns_equal(j, p, rel: float = 0.0, what: str = ""):
    """JAX column j and port column p: the same type, validity and data;
    floats bit for bit (any NaN equals any NaN) or within ``rel``."""
    assert str(p.dtype) == str(j.dtype), what
    jv, pv = np.asarray(j.validity), p.validity.numpy()
    np.testing.assert_array_equal(pv, jv, err_msg=f"{what} validity")
    jd, pd = np.asarray(j.data), p.data.numpy()
    assert jd.dtype == pd.dtype, (what, jd.dtype, pd.dtype)
    if np.issubdtype(jd.dtype, np.floating):
        both_nan = np.isnan(jd) & np.isnan(pd)
        if rel == 0.0:
            ib = np.dtype(f"int{jd.dtype.itemsize * 8}")
            same = (jd.view(ib) == pd.view(ib)) | both_nan
        else:
            same = both_nan | (jd == pd) | (
                np.abs(jd - pd) <= rel * np.maximum(np.abs(jd),
                                                    np.abs(pd)))
        bad = np.nonzero(~same)[0]
        assert not len(bad), (f"{what}: rows {bad[:5]} JAX "
                              f"{jd[bad[:5]]} port {pd[bad[:5]]}")
    else:
        np.testing.assert_array_equal(pd, jd, err_msg=what)


# name -> (builder(M, schema), relative tolerance of floats)
CASES = {
    # arithmetic
    "add f64": (lambda M, s: M.ar.Add(ref(M, s, "x"), ref(M, s, "y")), 0),
    "sub f32": (lambda M, s: M.ar.Subtract(ref(M, s, "f"), lit(M, 1.5,
                                                               "float")), 0),
    "mul f64 lit": (lambda M, s: M.ar.Multiply(ref(M, s, "x"),
                                               lit(M, 0.07, "double")), 0),
    "div f64": (lambda M, s: M.ar.Divide(ref(M, s, "x"), ref(M, s, "y")), 0),
    "add int8 wraps": (lambda M, s: M.ar.Add(ref(M, s, "b"),
                                             lit(M, 100, "tinyint")), 0),
    "mul int16 wraps": (lambda M, s: M.ar.Multiply(ref(M, s, "h"),
                                                   ref(M, s, "h")), 0),
    "sub int32": (lambda M, s: M.ar.Subtract(ref(M, s, "i"),
                                             ref(M, s, "j")), 0),
    "mul int64 wraps": (lambda M, s: M.ar.Multiply(ref(M, s, "l"),
                                                   ref(M, s, "m")), 0),
    "div int64": (lambda M, s: M.ar.IntegralDivide(ref(M, s, "l"),
                                                   ref(M, s, "m")), 0),
    "div int32": (lambda M, s: M.ar.IntegralDivide(ref(M, s, "i"),
                                                   ref(M, s, "j")), 0),
    "div int8 by -1": (lambda M, s: M.ar.IntegralDivide(
        ref(M, s, "b"), lit(M, -1, "tinyint")), 0),
    "remainder int64": (lambda M, s: M.ar.Remainder(ref(M, s, "l"),
                                                    ref(M, s, "m")), 0),
    "remainder int16": (lambda M, s: M.ar.Remainder(
        ref(M, s, "h"), lit(M, 7, "smallint")), 0),
    "remainder f64": (lambda M, s: M.ar.Remainder(ref(M, s, "x"),
                                                  ref(M, s, "y")), 0),
    "pmod int32": (lambda M, s: M.ar.Pmod(ref(M, s, "i"), ref(M, s, "j")),
                   0),
    "pmod int64 lit": (lambda M, s: M.ar.Pmod(ref(M, s, "l"),
                                              lit(M, -7, "bigint")), 0),
    "pmod f64": (lambda M, s: M.ar.Pmod(ref(M, s, "x"),
                                        lit(M, 3.5, "double")), 0),
    "unary minus int64": (lambda M, s: M.ar.UnaryMinus(ref(M, s, "l")), 0),
    "unary minus f32": (lambda M, s: M.ar.UnaryMinus(ref(M, s, "f")), 0),
    "unary positive": (lambda M, s: M.ar.UnaryPositive(ref(M, s, "i")), 0),
    "abs int8": (lambda M, s: M.ar.Abs(ref(M, s, "b")), 0),
    "abs int64": (lambda M, s: M.ar.Abs(ref(M, s, "l")), 0),
    "abs f64": (lambda M, s: M.ar.Abs(ref(M, s, "x")), 0),
    # predicates
    "eq f64 nan": (lambda M, s: M.pr.EqualTo(ref(M, s, "x"),
                                             ref(M, s, "y")), 0),
    "lt f64 nan": (lambda M, s: M.pr.LessThan(ref(M, s, "x"),
                                              ref(M, s, "y")), 0),
    "ge f32 lit": (lambda M, s: M.pr.GreaterThanOrEqual(
        ref(M, s, "f"), lit(M, 0.0, "float")), 0),
    "ne int64": (lambda M, s: M.pr.NotEqual(ref(M, s, "l"),
                                            ref(M, s, "m")), 0),
    "le int8": (lambda M, s: M.pr.LessThanOrEqual(ref(M, s, "b"),
                                                  lit(M, 0, "tinyint")), 0),
    "gt bool": (lambda M, s: M.pr.GreaterThan(ref(M, s, "t"),
                                              ref(M, s, "u")), 0),
    "eq null-safe f64": (lambda M, s: M.pr.EqualNullSafe(ref(M, s, "x"),
                                                         ref(M, s, "y")), 0),
    "eq null-safe int32 null lit": (lambda M, s: M.pr.EqualNullSafe(
        ref(M, s, "i"), lit(M, None, "int")), 0),
    "isnan": (lambda M, s: M.pr.IsNaN(ref(M, s, "x")), 0),
    "isnull": (lambda M, s: M.pr.IsNull(ref(M, s, "f")), 0),
    "isnotnull": (lambda M, s: M.pr.IsNotNull(ref(M, s, "l")), 0),
    "and kleene": (lambda M, s: M.pr.And(ref(M, s, "t"), ref(M, s, "u")),
                   0),
    "or kleene": (lambda M, s: M.pr.Or(ref(M, s, "t"), ref(M, s, "u")), 0),
    "and null lit": (lambda M, s: M.pr.And(ref(M, s, "t"),
                                           lit(M, None, "boolean")), 0),
    "not": (lambda M, s: M.pr.Not(ref(M, s, "t")), 0),
    "in int64": (lambda M, s: M.pr.In(ref(M, s, "l"), [1, -1, 0, 7]), 0),
    "in with null": (lambda M, s: M.pr.In(ref(M, s, "i"), [3, None]), 0),
    "in f64": (lambda M, s: M.pr.In(ref(M, s, "x"),
                                    [0.0, float("nan"), 1.0]), 0),
    # casts
    "cast f64 to int32": (lambda M, s: M.Cast(ref(M, s, "x"),
                                              M.dt.INT32), 0),
    "cast f64 to int64": (lambda M, s: M.Cast(ref(M, s, "x"),
                                              M.dt.INT64), 0),
    "cast f32 to int8": (lambda M, s: M.Cast(ref(M, s, "f"), M.dt.INT8), 0),
    "cast int64 to int16": (lambda M, s: M.Cast(ref(M, s, "l"),
                                                M.dt.INT16), 0),
    "cast int64 to f32": (lambda M, s: M.Cast(ref(M, s, "l"),
                                              M.dt.FLOAT32), 0),
    "cast f64 to f32": (lambda M, s: M.Cast(ref(M, s, "x"),
                                            M.dt.FLOAT32), 0),
    "cast bool to f64": (lambda M, s: M.Cast(ref(M, s, "t"),
                                             M.dt.FLOAT64), 0),
    "cast int32 to bool": (lambda M, s: M.Cast(ref(M, s, "i"),
                                               M.dt.BOOL), 0),
    # conditionals
    "if": (lambda M, s: M.co.If(ref(M, s, "t"), ref(M, s, "x"),
                                ref(M, s, "y")), 0),
    "if literal branch": (lambda M, s: M.co.If(
        ref(M, s, "t"), lit(M, 7, "bigint"), ref(M, s, "l")), 0),
    "case when": (lambda M, s: M.co.CaseWhen(
        [(M.pr.GreaterThan(ref(M, s, "x"), lit(M, 0.0, "double")),
          ref(M, s, "y")),
         (ref(M, s, "t"), lit(M, -1.0, "double"))], None), 0),
    "case when else": (lambda M, s: M.co.CaseWhen(
        [(ref(M, s, "u"), ref(M, s, "i"))], lit(M, 5, "int")), 0),
    "coalesce": (lambda M, s: M.co.Coalesce(ref(M, s, "x"), ref(M, s, "y"),
                                            lit(M, 9.5, "double")), 0),
    "nvl": (lambda M, s: M.co.Nvl(ref(M, s, "l"), ref(M, s, "m")), 0),
    "nullif f64": (lambda M, s: M.co.NullIf(ref(M, s, "x"),
                                            ref(M, s, "y")), 0),
    "nullif int lit": (lambda M, s: M.co.NullIf(ref(M, s, "i"),
                                                lit(M, 0, "int")), 0),
    "greatest f64 nan": (lambda M, s: M.co.Greatest(
        ref(M, s, "x"), ref(M, s, "y"), ref(M, s, "p")), 0),
    "least int64": (lambda M, s: M.co.Least(ref(M, s, "l"),
                                            ref(M, s, "m")), 0),
    "least f64 lit": (lambda M, s: M.co.Least(ref(M, s, "x"),
                                              lit(M, 0.0, "double")), 0),
    # math
    "sqrt": (lambda M, s: M.mo.Sqrt(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "exp": (lambda M, s: M.mo.Exp(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "log": (lambda M, s: M.mo.Log(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "log10": (lambda M, s: M.mo.Log10(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "log1p": (lambda M, s: M.mo.Log1p(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "sin": (lambda M, s: M.mo.Sin(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "cos": (lambda M, s: M.mo.Cos(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "tan": (lambda M, s: M.mo.Tan(ref(M, s, "x")), TRANSCENDENTAL_REL),
    "pow": (lambda M, s: M.mo.Pow(ref(M, s, "x"), ref(M, s, "y")),
            TRANSCENDENTAL_REL),
    "pow int base": (lambda M, s: M.mo.Pow(ref(M, s, "i"),
                                           lit(M, 2.0, "double")),
                     TRANSCENDENTAL_REL),
    "atan2": (lambda M, s: M.mo.Atan2(ref(M, s, "x"), ref(M, s, "y")),
              TRANSCENDENTAL_REL),
    "floor f64": (lambda M, s: M.mo.Floor(ref(M, s, "x")), 0),
    "ceil f32": (lambda M, s: M.mo.Ceil(ref(M, s, "f")), 0),
    "floor int": (lambda M, s: M.mo.Floor(ref(M, s, "i")), 0),
    "round f64": (lambda M, s: M.mo.Round(ref(M, s, "x")), 0),
    "round f64 scale 2": (lambda M, s: M.mo.Round(ref(M, s, "x"), 2), 0),
    "round f32": (lambda M, s: M.mo.Round(ref(M, s, "f"), 1), 0),
    "round int scale -1": (lambda M, s: M.mo.Round(ref(M, s, "i"), -1), 0),
    "round int64 scale -2": (lambda M, s: M.mo.Round(ref(M, s, "l"), -2),
                             0),
    # a nested tree across the families
    "nested": (lambda M, s: M.co.If(
        M.pr.And(M.pr.IsNotNull(ref(M, s, "x")),
                 M.pr.LessThan(M.ar.Abs(ref(M, s, "l")),
                               lit(M, 500, "bigint"))),
        M.ar.Add(M.Cast(M.ar.Pmod(ref(M, s, "l"), lit(M, 7, "bigint")),
                        M.dt.FLOAT64),
                 M.ar.Multiply(ref(M, s, "x"), lit(M, 2.0, "double"))),
        M.co.Coalesce(ref(M, s, "y"), lit(M, -1.0, "double"))), 0),
}
SEED = 23


@pytest.fixture(scope="module")
def batches():
    return make_batches(COLUMNS, SEED)


def eval_both(batches, build):
    jb, pb = batches[:2]
    j = jex.materialize(build(JAX, jb.schema).eval(jb), jb)
    p = pex.materialize(build(PORT, pb.schema).eval(pb), pb)
    return j, p


@pytest.mark.parametrize("case", sorted(CASES))
def test_expression_matches_jax(batches, case):
    build, rel = CASES[case]
    j, p = eval_both(batches, build)
    assert_columns_equal(j, p, rel, case)


def test_integral_division_by_minus_one_never_traps():
    """MIN / -1 and MIN % -1 wrap to MIN and 0 (the CPU's divide would
    trap), as the reference's XLA division gives."""
    lo = np.array([-2 ** 63, 7, -7, 0], np.int64)
    ok = np.array([True, True, True, False])
    extra = {"l": (lo, ok, "bigint"),
             "m": (np.array([-1, -1, 2, 0], np.int64), ok, "bigint")}
    b = make_batches({}, 0, n=3, cap=4, extra=extra)
    for name in ("div int64", "remainder int64", "pmod int32"):
        if name == "pmod int32":
            build = (lambda M, s: M.ar.Pmod(ref(M, s, "l"), ref(M, s, "m")))
        else:
            build = CASES[name][0]
        j, p = eval_both(b, build)
        assert_columns_equal(j, p, 0, name)
    _j, p = eval_both(b, CASES["div int64"][0])
    assert p.data.tolist() == [-2 ** 63, -7, -3, 0]


def test_api_functions_build_the_expressions():
    """F.* and the Column methods make the nodes the JAX API makes."""
    from spark_rapids_tpu.api import functions as JF
    from spark_rapids_tpu_torch.api import functions as PF
    names = ("coalesce", "nvl", "nullif", "greatest", "least", "abs",
             "sqrt", "exp", "log", "pow", "floor", "ceil", "round", "sin",
             "cos", "tan", "atan2", "pmod", "isnull", "isnan")
    for name in names:
        args = {"coalesce": 2, "nvl": 2, "nullif": 2, "greatest": 2,
                "least": 2, "pow": 2, "atan2": 2, "pmod": 2}.get(name, 1)
        jcols = [JF.col(c) for c in ("a", "b")[:args]]
        pcols = [PF.col(c) for c in ("a", "b")[:args]]
        assert type(getattr(PF, name)(*pcols).expr).__name__ == \
            type(getattr(JF, name)(*jcols).expr).__name__, name
    c = PF.col("a")
    assert type((c % 2).expr).__name__ == "Remainder"
    assert type((-c).expr).__name__ == "UnaryMinus"
    assert type(c.eqNullSafe(1).expr).__name__ == "EqualNullSafe"
