"""The generated stage kernels' source (plan/stage_codegen.py), compiled for
the host with g++ (-O2 -ffp-contract=off) and run over CPU tensors through
the same argument packing the card uses, against the port's eager torch
ops (and so, through test_torch_scalar_exprs.py and test_torch_datetime.py,
against the JAX package).

The per-row function is plain C++; only its ``__global__`` wrappers are
CUDA. Every scalar and date case of those two files compiles into two
kernels (one output per case) and is compared bit for bit, the
transcendental functions within 1e-12 relative. Also: string columns
against literals (=, <>, IN), a filter/project chain's keep mask and
outputs, the grouping-free K20 partials folded as K1 folds them, the plan
time declines, and the source's independence from literal values. No
session path runs the host build: it is how the generated source is
checked without a card.
"""

import ctypes
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from test_torch_datetime import CASES as DATE_CASES
from test_torch_datetime import _arrays as date_arrays
from test_torch_scalar_exprs import CASES as SCALAR_CASES
from test_torch_scalar_exprs import COLUMNS, PORT, lit, make_batches, ref

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import expressions as ex
from spark_rapids_tpu_torch.ops import predicates as pr
from spark_rapids_tpu_torch.ops import strings as st
from spark_rapids_tpu_torch.plan import stage_codegen as sg
from spark_rapids_tpu_torch.plan.stage_compiler import StageChain

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler")


def host_build(kernels, directory):
    """Each kernel's source compiled by g++ into its own shared library,
    all compilers started together: entry -> loaded library."""
    procs = {}
    for k in kernels:
        src = directory / f"{k.entry}.cpp"
        src.write_text(k.source)
        lib = directory / f"{k.entry}.so"
        procs[k.entry] = (lib, subprocess.Popen(
            ["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
             "-fPIC", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for entry, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out[:4000]
        libs[entry] = ctypes.CDLL(str(lib))
    return libs


def run_stage(k, lib, batch):
    """(outputs, mask) of a stage kernel on a CPU batch."""
    outs, mask = k.allocate(batch)
    lib.stage_host(k.pack(batch, outs, mask))
    return outs, mask


def assert_same(got: Column, want: Column, rel: float, what: str):
    """Data and validity equal; floats bit for bit (a NaN equals any NaN)
    or within ``rel``."""
    assert got.dtype == want.dtype, what
    assert torch.equal(got.validity, want.validity), f"{what} validity"
    g, w = got.data.numpy(), want.data.numpy()
    assert g.dtype == w.dtype, what
    if np.issubdtype(g.dtype, np.floating):
        nan = np.isnan(g) & np.isnan(w)
        if rel == 0:
            ib = np.dtype(f"int{g.dtype.itemsize * 8}")
            ok = (g.view(ib) == w.view(ib)) | nan
        else:
            ok = nan | (g == w) | (np.abs(g - w) <= rel * np.maximum(
                np.abs(g), np.abs(w)))
        bad = np.nonzero(~ok)[0]
        assert not len(bad), f"{what}: rows {bad[:5]} {g[bad[:5]]} " \
                             f"vs {w[bad[:5]]}"
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


FAMILIES = {"scalar": (SCALAR_CASES, lambda: make_batches(COLUMNS, 23)[1]),
            "date": (DATE_CASES,
                     lambda: make_batches({}, 0, 230, 256,
                                          extra=date_arrays(31))[1])}


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Per family: (batch, kernel, its library, case names in output
    order), one kernel holding every case of the family."""
    out, kernels = {}, []
    for fam, (cases, batch_of) in FAMILIES.items():
        batch = batch_of()
        names = sorted(cases)
        exprs = [sg.Materialize(cases[n][0](PORT, batch.schema))
                 for n in names]
        k = sg.StageKernel("stage", batch.schema, [], exprs)
        kernels.append(k)
        out[fam] = (batch, k, names, exprs)
    libs = host_build(kernels, tmp_path_factory.mktemp("stage_host"))
    res = {}
    for fam, (batch, k, names, exprs) in out.items():
        outs, _mask = run_stage(k, libs[k.entry], batch)
        res[fam] = (batch, dict(zip(names, zip(outs, exprs))))
    return res


CASE_IDS = [("scalar", n) for n in sorted(SCALAR_CASES)] + \
    [("date", n) for n in sorted(DATE_CASES)]


@pytest.mark.parametrize("family,case", CASE_IDS,
                         ids=[f"{f}-{n}" for f, n in CASE_IDS])
def test_generated_expression_equals_the_eager_op(families, family, case):
    batch, by_name = families[family]
    got, expr = by_name[case]
    want = ex.materialize(expr.eval(batch), batch)
    rel = (SCALAR_CASES if family == "scalar" else DATE_CASES)[case][1]
    assert_same(got, want, rel, case)


def _string_batch():
    """A string column ``s`` (width 16, junk past the lengths), an int64
    ``q`` and a double ``x``, 300 rows of 512."""
    rng = np.random.default_rng(5)
    cap, n, w = 512, 300, 16
    words = [b"FRANCE", b"GERMANY", b"", b"FRANCEX", b"FRANC", b"AIR",
             b"REG AIR", b"BRAZIL"]
    data = rng.integers(1, 256, (cap, w)).astype(np.uint8)
    lengths = np.zeros(cap, np.int32)
    valid = rng.random(cap) >= 0.1
    valid[n:] = False
    for i in range(cap):
        word = words[rng.integers(len(words))] if valid[i] else b""
        data[i, :len(word)] = np.frombuffer(word, np.uint8)
        lengths[i] = len(word)
    q = np.where(valid, rng.integers(0, 50, cap), 0).astype(np.int64)
    x = rng.normal(1000, 300, cap)
    cols = [Column(dt.STRING, torch.from_numpy(data), torch.from_numpy(valid),
                   torch.from_numpy(lengths)),
            Column(dt.INT64, torch.from_numpy(q), torch.ones(cap, dtype=bool)),
            Column(dt.FLOAT64, torch.from_numpy(x),
                   torch.from_numpy(rng.random(cap) >= 0.1))]
    schema = dt.Schema([dt.Field("s", dt.STRING), dt.Field("q", dt.INT64),
                        dt.Field("x", dt.FLOAT64)])
    return ColumnarBatch(schema, cols, n)


def _s():
    return ex.BoundReference(0, dt.STRING, True, "s")


STRING_CASES = {
    "eq": lambda: pr.EqualTo(_s(), ex.Literal("FRANCE")),
    "eq literal first": lambda: pr.EqualTo(ex.Literal("GERMANY"), _s()),
    "ne": lambda: pr.NotEqual(_s(), ex.Literal("FRANCE")),
    "eq empty": lambda: pr.EqualTo(_s(), ex.Literal("")),
    "eq wider than the column": lambda: pr.EqualTo(
        _s(), ex.Literal("FRANCE AND MORE THAN 16")),
    "eq null literal": lambda: pr.EqualTo(_s(), ex.Literal(None, dt.STRING)),
    "in": lambda: pr.In(_s(), ["AIR", "REG AIR"]),
    "in with null": lambda: pr.In(_s(), ["BRAZIL", None]),
    "isnull": lambda: pr.IsNull(_s()),
    "or of eqs": lambda: pr.Or(
        pr.And(pr.EqualTo(_s(), ex.Literal("FRANCE")),
               pr.LessThan(ex.BoundReference(1, dt.INT64),
                           ex.Literal(24))),
        pr.EqualTo(_s(), ex.Literal("GERMANY"))),
}


@pytest.fixture(scope="module")
def strings_run(tmp_path_factory):
    batch = _string_batch()
    names = sorted(STRING_CASES)
    exprs = [sg.Materialize(STRING_CASES[n]()) for n in names]
    # the string column itself passes through: no kernel output
    k = sg.StageKernel("stage", batch.schema, [], exprs + [_s()])
    lib = host_build([k], tmp_path_factory.mktemp("strings"))[k.entry]
    outs, _ = run_stage(k, lib, batch)
    return batch, k, dict(zip(names, zip(outs, exprs))), outs[-1]


@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_string_compare_with_literals_equals_the_eager_op(strings_run,
                                                          case):
    batch, _k, by_name, _pass = strings_run
    got, expr = by_name[case]
    assert_same(got, ex.materialize(expr.eval(batch), batch), 0, case)


def test_a_string_column_passes_through_unchanged(strings_run):
    batch, k, _by_name, passed = strings_run
    assert k.out_kinds[-1] == ("ref", 0)
    assert passed is batch.columns[0]


def _chain_batch():
    b = make_batches(COLUMNS, 41)[1]
    return b


def _chain(schema):
    """filter -> project -> filter -> project over the scalar columns."""
    x, l_, t = (ref(PORT, schema, n) for n in ("x", "l", "t"))
    p1 = [PORT.ar.Multiply(x, lit(PORT, 2.0, "double")),
          PORT.ar.Pmod(l_, lit(PORT, 5, "bigint")), t,
          lit(PORT, 3, "int")]
    s1 = dt.Schema([dt.Field("a", dt.FLOAT64), dt.Field("b", dt.INT64),
                    dt.Field("t", dt.BOOL), dt.Field("c", dt.INT32)])
    a = ex.BoundReference(0, dt.FLOAT64)
    bb = ex.BoundReference(1, dt.INT64)
    c = ex.BoundReference(3, dt.INT32)
    p2 = [PORT.ar.Add(a, PORT.Cast(bb, dt.FLOAT64)), c,
          ex.BoundReference(2, dt.BOOL)]
    s2 = dt.Schema([dt.Field("r", dt.FLOAT64), dt.Field("c", dt.INT32),
                    dt.Field("t", dt.BOOL)])
    steps = [("filter", pr.IsNotNull(x)), ("project", p1, s1),
             ("filter", pr.Or(pr.GreaterThan(a, lit(PORT, 0.0, "double")),
                              ex.BoundReference(2, dt.BOOL))),
             ("project", p2, s2)]
    return StageChain(steps, schema, s2)


def test_a_chain_gives_the_eager_chain_mask_and_columns(tmp_path):
    batch = _chain_batch()
    chain = _chain(batch.schema)
    filters, cols = sg.inline_chain(chain, batch.schema)
    k = sg.StageKernel("stage", batch.schema, filters, cols)
    lib = host_build([k], tmp_path)[k.entry]
    outs, mask = run_stage(k, lib, batch)
    want_batch, want_mask = chain.eval(batch)
    assert torch.equal(mask, want_mask)
    assert 0 < int(mask.sum()) < batch.num_rows
    for i, (g, w) in enumerate(zip(outs, want_batch.columns)):
        assert_same(g, w, 0, f"output {i}")


def _fold(parts: bytes, nparts: int, op: str, in_dtype):
    """K1's fold of host partials, in part order (agg_common.cuh)."""
    accs = [struct.unpack_from("<qqq8s", parts, 32 * p)
            for p in range(nparts)]
    n_live = sum(a[0] for a in accs)
    n_pick = sum(a[1] for a in accs)
    n_nan = sum(a[2] for a in accs)
    if op == "count_star":
        return n_live, True
    if op == "count":
        return n_pick, True
    flt = in_dtype.is_floating or op in ("avg",) or (
        op == "sum" and in_dtype in (dt.DATE, dt.TIMESTAMP))
    vals = [struct.unpack("<d" if flt else "<q", a[3])[0] for a in accs]
    if n_pick == 0:
        return 0, False
    if op in ("sum", "avg"):
        if flt:
            s = 0.0
            for v in vals:
                s += v
            return (s / n_pick if op == "avg" else s), True
        return int(np.sum(np.array(vals, np.int64))), True
    if op == "min":
        if flt:
            return (min(vals) if n_pick - n_nan > 0 else float("nan")), True
        return min(vals), True
    if flt:
        return (float("nan") if n_nan else max(vals)), True
    return max(vals), True


def test_k20_partials_fold_to_the_eager_reduce(tmp_path):
    """q6's shape plus every op: the grouping-free update's partials (K1's
    grid and tree, emulated on the host) folded as K1 folds them equal
    reduce_aggregate's eager results."""
    batch = make_batches(COLUMNS, 57, n=3000, cap=4096)[1]
    s = batch.schema
    x, y, l_, d = (ref(PORT, s, n) for n in ("x", "y", "l", "i"))
    filt = pr.And(pr.GreaterThanOrEqual(x, lit(PORT, -150.0, "double")),
                  pr.LessThan(l_, lit(PORT, 500, "bigint")))
    prod = sg.Materialize(PORT.ar.Multiply(x, y))
    specs = [("sum", prod, True), ("count", sg.Materialize(x), True),
             ("count_star", None, True), ("min", sg.Materialize(x), True),
             ("max", sg.Materialize(y), True),
             ("sum", sg.Materialize(l_), True),
             ("min", sg.Materialize(d), True),
             ("max", sg.Materialize(PORT.Cast(d, dt.INT64)), True)]
    k = sg.StageKernel("reduce", s, [filt], [], specs)
    lib = host_build([k], tmp_path)[k.entry]
    nparts = min(max((batch.capacity + 4095) // 4096, 1), 1024)
    parts = [torch.zeros(nparts * 32, dtype=torch.uint8) for _ in specs]
    lib.stage_host_reduce(k.pack(batch, [], None, parts), nparts)
    pred = filt.eval(batch)
    live = pred.data & pred.validity & batch.row_mask_raw()
    for (op, e, _ig), p in zip(specs, parts):
        col = None if e is None else ex.materialize(e.eval(batch), batch)
        want = A._masked_reduce_torch(A.AggSpec(op, col), live, 1)
        value, valid = _fold(p.numpy().tobytes(), nparts, op,
                             None if e is None else e.dtype)
        assert valid == bool(want.validity[0]), op
        if valid:
            w = want.data[0].item()
            assert value == pytest.approx(w, rel=1e-12, nan_ok=True), op


DECLINES = {
    "upper": (lambda s: st.Upper(ex.BoundReference(0, dt.STRING)),
              "string expression not generated (Upper)"),
    "substring": (lambda s: st.Substring(ex.BoundReference(0, dt.STRING),
                                         ex.Literal(1), ex.Literal(2)),
                  "string expression not generated (Substring)"),
    "string less-than": (lambda s: pr.LessThan(
        ex.BoundReference(0, dt.STRING), ex.Literal("M")),
        "string expression not generated (LessThan)"),
    "contains": (lambda s: st.Contains(ex.BoundReference(0, dt.STRING),
                                       ex.Literal("AIR")),
                 "string expression not generated (Contains)"),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_uncovered_expressions_decline_with_a_reason(case):
    batch = _string_batch()
    build, reason = DECLINES[case]
    got = sg.decline_reason("stage", batch.schema, [],
                            [sg.Materialize(build(batch.schema))])
    assert got == reason


def test_the_source_holds_no_literal_value():
    """Two stages that differ only in their literals share one source
    (one compiled kernel): the values travel in the argument block."""
    batch = _string_batch()

    def stage(name, q):
        return sg.StageKernel("stage", batch.schema, [pr.And(
            pr.EqualTo(_s(), ex.Literal(name)),
            pr.LessThan(ex.BoundReference(1, dt.INT64), ex.Literal(q)))], [])
    a, b = stage("FRANCE", 24), stage("GERMANY AND ITALY", -3)
    assert a.entry == b.entry and a.source == b.source
    assert "FRANCE" not in a.source and "24" not in a.source.split(
        "struct StageArgs")[1]
    assert a._base_words()[:] != b._base_words()[:]


# ---------------------------------------------------------------------------
# The execs through host-built kernels
# ---------------------------------------------------------------------------

HOST_QUERIES = ("q6", "q1", "q3", "q7", "headline")


class HostKernels:
    """StageKernel.launch and .reduce on the host: each generated source
    built by g++ at first use, K1's fold done as _fold does it."""

    def __init__(self, directory):
        self.directory = directory
        self.libs = {}
        self.launches = 0

    def lib(self, k):
        if k.entry not in self.libs:
            self.libs.update(host_build([k], self.directory))
        return self.libs[k.entry]

    def launch(self, k, batch):
        self.launches += 1
        return run_stage(k, self.lib(k), batch)

    def reduce(self, k, batch, out_slots):
        from spark_rapids_tpu_torch.columnar.column import storage_dtype
        self.launches += 1
        nparts = min(max((batch.capacity + 4095) // 4096, 1), 1024)
        parts = [torch.zeros(nparts * 32, dtype=torch.uint8)
                 for _ in k.specs]
        self.lib(k).stage_host_reduce(k.pack(batch, [], None, parts),
                                      nparts)
        out = []
        for (op, e, _ig), p in zip(k.specs, parts):
            in_t = None if e is None else e.dtype
            value, valid = _fold(p.numpy().tobytes(), nparts, op, in_t)
            t = A.result_dtype(op, in_t)
            data = torch.zeros(out_slots, dtype=storage_dtype(t))
            data[0] = value if valid else 0
            ok = torch.zeros(out_slots, dtype=torch.bool)
            ok[0] = valid
            out.append(Column(t, data, ok))
        return out


@pytest.fixture(scope="module")
def small_tpch():
    from benchmarks import datagen
    from spark_rapids_tpu_torch import queries
    sf = 0.001
    return {"lineitem": datagen.gen_lineitem(sf),
            "orders": datagen.gen_orders(sf),
            "customer": datagen.gen_customer(sf),
            "supplier": datagen.gen_supplier(sf),
            "nation": datagen.gen_nation(),
            "headline": queries.headline_table(3000)}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return HostKernels(tmp_path_factory.mktemp("host_kernels"))


@pytest.mark.parametrize("query", HOST_QUERIES)
def test_queries_through_host_built_kernels_equal_the_eager_rows(
        small_tpch, host_kernels, monkeypatch, query):
    """The execs' generated path (a filter's or a project's FusedStage, a
    whole stage, an aggregate's K19 prologue or K20 update) with the
    kernels built for the host in place of the card's: the rows equal
    the eager path's (a grouping-free sum within 1e-12, K1's fold order
    against torch's)."""
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.plan import physical as ph
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu"}).getOrCreate()
    t = {n: session.createDataFrame(c, schema=queries.table_schema(c))
         for n, c in small_tpch.items()}
    want = queries.QUERIES[query](t).collect()
    before = host_kernels.launches
    monkeypatch.setattr(ph, "on_card", lambda batch: True)
    monkeypatch.setattr(sg.StageKernel, "launch",
                        lambda k, b: host_kernels.launch(k, b))
    monkeypatch.setattr(sg.StageKernel, "reduce",
                        lambda k, b, slots: host_kernels.reduce(k, b, slots))
    got = queries.QUERIES[query](t).collect()
    assert host_kernels.launches > before
    if query == "headline":
        got, want = sorted(got), sorted(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12)
            else:
                assert a == b
