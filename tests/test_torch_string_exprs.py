"""Parity of the PyTorch port's string expressions (ops/strings.py) with
the JAX package's, on the CPU, where K13 (find_pattern's LOCATE mode), K16
(string_map), K17 (string_slice) and K18 (string_place) run their plain
PyTorch twins.

Every expression is held to the JAX expression on one seeded batch: ASCII
and multi-byte UTF-8 rows (2-, 3- and 4-byte characters), rows that start
with UTF-8 continuation bytes, leading and trailing spaces, empty rows,
NULL rows, dead rows past the row count and junk bytes past every length;
with scalar and column operands. Strings (bytes, lengths, validity) and
ints are compared bit for bit. Where the reference departs from Spark's
rule (a negative substring position, an empty pad, a pad width of 0 or
less) the port is held to a Spark-rule oracle instead. The three
expressions the reference runs on the host are held to it too, and their
host passes are counted.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.ops import strings as JS

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import strings as PS

N, CAP, W = 180, 256, 32
WORDS = ["abc", "hello", "", "é漢x", "  pad me  ", "Hello wORLD foo",
         "   ", "x" * 20, "a😀b", "naïve café", "l", "llama hall"]
# rows whose bytes start inside a character (continuation bytes)
RAW = [b"\x80\xbfab", b"\xa9llo"]
INCOMPAT = "spark.rapids.tpu.sql.incompatibleOps.enabled"


@pytest.fixture(scope="module")
def batches():
    """(JAX batch, port batch): a string column ``s`` (width 32) and two
    int32 columns ``p`` and ``n`` (substring positions and lengths, with
    NULLs), the same arrays in both."""
    rng = np.random.default_rng(11)
    data = np.zeros((CAP, W), np.uint8)
    lengths = np.zeros(CAP, np.int32)
    valid = np.zeros(CAP, np.bool_)
    for i in range(N):
        if rng.random() < 0.12:
            continue
        k = rng.integers(0, len(WORDS) + len(RAW))
        b = WORDS[k].encode("utf-8") if k < len(WORDS) else \
            RAW[k - len(WORDS)]
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
        valid[i] = True
    # junk past every length, dead rows included
    junk = rng.integers(1, 256, (CAP, W)).astype(np.uint8)
    data = np.where(np.arange(W)[None, :] >= lengths[:, None], junk, data)
    ints = []
    # positions from 0 up (a negative one before a short string's start
    # is a reference fault, held to Spark below); lengths from -2 up
    for lo, hi in ((0, 7), (-2, 9)):
        v = np.zeros(CAP, np.int32)
        ok = np.zeros(CAP, np.bool_)
        v[:N] = rng.integers(lo, hi, N)
        ok[:N] = rng.random(N) >= 0.1
        v[~ok] = 0
        ints.append((v, ok))
    jcols = [JColumn(jdt.STRING, jnp.asarray(data), jnp.asarray(valid),
                     jnp.asarray(lengths))]
    pcols = [PColumn(pdt.STRING, torch.from_numpy(data.copy()),
                     torch.from_numpy(valid.copy()),
                     torch.from_numpy(lengths.copy()))]
    for v, ok in ints:
        jcols.append(JColumn(jdt.INT32, jnp.asarray(v), jnp.asarray(ok)))
        pcols.append(PColumn(pdt.INT32, torch.from_numpy(v.copy()),
                             torch.from_numpy(ok.copy())))
    names = (("s", "string"), ("p", "int"), ("n", "int"))
    jb = JBatch(jdt.Schema([jdt.Field(a, jdt.of(t)) for a, t in names]),
                jcols, N)
    pb = PBatch(pdt.Schema([pdt.Field(a, pdt.of(t)) for a, t in names]),
                pcols, N)
    return jb, pb


def _s(E, D):
    return E.BoundReference(0, D.STRING, True, "s")


def _i(E, D, k):
    return E.BoundReference(k, D.INT32, True, "pn"[k - 1])


# name -> builder(E, S, D) of one expression over the batch's columns
CASES = {
    "length": lambda E, S, D: S.Length(_s(E, D)),
    "upper": lambda E, S, D: S.Upper(_s(E, D)),
    "lower": lambda E, S, D: S.Lower(_s(E, D)),
    "initcap": lambda E, S, D: S.InitCap(_s(E, D)),
    "substring 2 3": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(2), E.Literal(3)),
    "substring 0 2": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(0), E.Literal(2)),
    "substring -2 5": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(-2), E.Literal(5)),
    "substring 3 -1": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(3), E.Literal(-1)),
    "substring 1 99": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(1), E.Literal(99)),
    "substring null pos": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(None, D.INT32), E.Literal(2)),
    "substring length column": lambda E, S, D: S.Substring(
        _s(E, D), E.Literal(2), _i(E, D, 2)),
    "substring columns": lambda E, S, D: S.Substring(
        _s(E, D), _i(E, D, 1), _i(E, D, 2)),
    "substring scalar child": lambda E, S, D: S.Substring(
        E.Literal("héllo", D.STRING), E.Literal(2), E.Literal(3)),
    "trim": lambda E, S, D: S.StringTrim(_s(E, D)),
    "ltrim": lambda E, S, D: S.StringTrimLeft(_s(E, D)),
    "rtrim": lambda E, S, D: S.StringTrimRight(_s(E, D)),
    "lpad 12": lambda E, S, D: S.StringLPad(_s(E, D), 12, "ab"),
    "lpad 3": lambda E, S, D: S.StringLPad(_s(E, D), 3, "ab"),
    "rpad 40": lambda E, S, D: S.StringRPad(_s(E, D), 40, "xyz"),
    "rpad 5 multibyte pad": lambda E, S, D: S.StringRPad(_s(E, D), 5, "é"),
    "lpad 32": lambda E, S, D: S.StringLPad(_s(E, D), 32, " "),
    "concat": lambda E, S, D: S.ConcatStr(
        _s(E, D), E.Literal("-", D.STRING), _s(E, D)),
    "concat scalar first": lambda E, S, D: S.ConcatStr(
        E.Literal("ü:", D.STRING), _s(E, D)),
    "concat null scalar": lambda E, S, D: S.ConcatStr(
        _s(E, D), E.Literal(None, D.STRING)),
    "concat of a substring": lambda E, S, D: S.ConcatStr(
        S.Substring(_s(E, D), E.Literal(1), E.Literal(2)), _s(E, D),
        S.Upper(_s(E, D))),
    # more operands than one K18 call takes: placed in folds of 32
    "concat 33 operands": lambda E, S, D: S.ConcatStr(*[
        E.Literal("é-", D.STRING) if i % 4 == 3 else _s(E, D)
        for i in range(33)]),
    "concat 70 operands": lambda E, S, D: S.ConcatStr(*[
        S.Substring(_s(E, D), E.Literal(i % 5), E.Literal(3)) if i % 2
        else E.Literal(str(i), D.STRING) if i % 3 == 0 else _s(E, D)
        for i in range(70)]),
    "locate l": lambda E, S, D: S.StringLocate(
        E.Literal("l", D.STRING), _s(E, D)),
    "locate multibyte": lambda E, S, D: S.StringLocate(
        E.Literal("x", D.STRING), _s(E, D)),
    "locate empty": lambda E, S, D: S.StringLocate(
        E.Literal("", D.STRING), _s(E, D)),
    "locate continuation": lambda E, S, D: S.StringLocate(
        E.Literal("\xbf", D.STRING), _s(E, D)),
    "locate null": lambda E, S, D: S.StringLocate(
        E.Literal(None, D.STRING), _s(E, D)),
    "locate too long": lambda E, S, D: S.StringLocate(
        E.Literal("y" * 33, D.STRING), _s(E, D)),
    # a start of 0 reads as 1 in the reference: the device path
    "locate from 0": lambda E, S, D: S.StringLocate(
        E.Literal("l", D.STRING), _s(E, D), E.Literal(0)),
    "like eq": lambda E, S, D: S.Like(_s(E, D), "abc"),
    "like eq empty": lambda E, S, D: S.Like(_s(E, D), ""),
    "like contains": lambda E, S, D: S.Like(_s(E, D), "%l%"),
    "like prefix": lambda E, S, D: S.Like(_s(E, D), "he%"),
    "like suffix": lambda E, S, D: S.Like(_s(E, D), "%x"),
    "like percent": lambda E, S, D: S.Like(_s(E, D), "%"),
}
# the reference's host expressions: one host pass each
HOST_CASES = {
    "like general": ("like", lambda E, S, D: S.Like(_s(E, D), "h_l%o")),
    "like escape": ("like", lambda E, S, D: S.Like(_s(E, D), "%\\%%")),
    "replace": ("replace", lambda E, S, D: S.StringReplace(
        _s(E, D), "l", "LL")),
    "locate from 2": ("locate", lambda E, S, D: S.StringLocate(
        E.Literal("l", D.STRING), _s(E, D), E.Literal(2))),
}


def _both(batches, build):
    jb, pb = batches
    j = JE.materialize(build(JE, JS, jdt).eval(jb), jb)
    p = PE.materialize(build(PE, PS, pdt).eval(pb), pb)
    return j, p


def _assert_same(j, p):
    assert str(p.dtype) == str(j.dtype)
    ja, pa = j.arrays(), p.arrays()
    assert len(ja) == len(pa)
    for a, b in zip(ja, pa):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("case", list(CASES))
def test_string_expression_matches_jax(batches, case):
    j, p = _both(batches, CASES[case])
    _assert_same(j, p)


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_string_expression_matches_jax_in_one_pass(batches, case):
    name, build = HOST_CASES[case]
    before = native.host_counts()
    j, p = _both(batches, build)
    _assert_same(j, p)
    after = native.host_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == name) for k in after}


def test_device_expressions_make_no_host_pass(batches):
    before = native.host_counts()
    for build in CASES.values():
        _both(batches, build)
    assert native.host_counts() == before


SCALARS = ("héllo wörld", "  x  ", "", None, "abc")


@pytest.mark.parametrize("case", [
    "length", "upper", "lower", "initcap", "trim",
    "ltrim", "rtrim", "lpad 12", "lpad 3", "rpad 40", "concat",
    "locate l", "like eq", "like contains", "like general", "replace"])
def test_string_expression_on_scalars_matches_jax(batches, case):
    build = CASES.get(case) or HOST_CASES[case][1]
    jb, pb = batches
    for value in SCALARS:
        def on_scalar(E, S, D, v=value):
            node = build(E, S, D)
            return node.transform(
                lambda x: E.Literal(v, D.STRING)
                if isinstance(x, E.BoundReference) else None)
        j = on_scalar(JE, JS, jdt).eval(jb)
        p = on_scalar(PE, PS, pdt).eval(pb)
        assert (p.value, p.is_null) == (j.value, j.is_null), (case, value)


# ---------------------------------------------------------------------------
# Where the reference departs from Spark: held to Spark's rule
# ---------------------------------------------------------------------------

FAULT_ROWS = ["abc", "hello", "", None, "é漢x"]


def _fault_batches():
    jc = JColumn.from_pylist(FAULT_ROWS, jdt.STRING, capacity=128)
    pc = PColumn.from_pylist(FAULT_ROWS, pdt.STRING, capacity=128)
    jb = JBatch(jdt.Schema([jdt.Field("s", jdt.STRING)]), [jc], 5)
    pb = PBatch(pdt.Schema([pdt.Field("s", pdt.STRING)]), [pc], 5)
    return jb, pb


def spark_substring(s, pos: int, length: int):
    """UTF8String.substringSQL over characters."""
    if s is None:
        return None
    n = len(s)
    start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end = start + length
    start = max(start, 0)
    return "" if start >= end else s[start:end]


def spark_pad(s, width: int, pad: str, left: bool):
    """UTF8String.lpad/rpad, over bytes as the reference declares."""
    if s is None:
        return None
    b, p = s.encode("utf-8"), pad.encode("utf-8")
    if width - len(b) <= 0 or not p:
        return b[:max(width, 0)].decode("utf-8", errors="replace")
    fill = (p * width)[:width - len(b)]
    return (fill + b if left else b + fill).decode("utf-8")


def _rows(build, jb_pb):
    jb, pb = jb_pb
    j = JE.materialize(build(JE, JS, jdt).eval(jb), jb).to_pylist(5)
    p = PE.materialize(build(PE, PS, pdt).eval(pb), pb).to_pylist(5)
    return j, p


@pytest.mark.parametrize("pos,length", [(-5, 3), (-4, 2), (-3, 1),
                                        (-1, 5), (-9, 20)])
def test_negative_substring_position_follows_spark(pos, length):
    """The reference clamps the start to 0 before it adds the length
    (strings.py:211-214): substring('abc', -5, 3) gives 'abc' there, 'a'
    in Spark."""
    j, p = _rows(lambda E, S, D: S.Substring(
        E.BoundReference(0, D.STRING, True, "s"), E.Literal(pos),
        E.Literal(length)), _fault_batches())
    assert p == [spark_substring(s, pos, length) for s in FAULT_ROWS]
    if (pos, length) == (-5, 3):
        assert j[0] == "abc" and p[0] == "a"
    # the position and the length as columns
    _jb, pb = _fault_batches()
    ints = [PColumn.from_pylist([x] * 5, pdt.INT32, capacity=128)
            for x in (pos, length)]
    batch = PBatch(pdt.Schema([pdt.Field("s", pdt.STRING),
                               pdt.Field("p", pdt.INT32),
                               pdt.Field("n", pdt.INT32)]),
                   pb.columns + ints, 5)
    out = PS.Substring(PE.BoundReference(0, pdt.STRING, True, "s"),
                       PE.BoundReference(1, pdt.INT32, True, "p"),
                       PE.BoundReference(2, pdt.INT32, True, "n")).eval(batch)
    assert out.to_pylist(5) == p


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("width,pad", [(5, ""), (2, ""), (-1, "x"),
                                       (0, "x"), (4, "xy")])
def test_pad_follows_spark_for_empty_pad_and_width(left, width, pad):
    """The reference pads an empty pattern with a space (strings.py:568)
    and writes NUL bytes for a width of 0 or less (583-606); Spark cuts
    to the width and gives ''."""
    cls = "StringLPad" if left else "StringRPad"
    j, p = _rows(lambda E, S, D: getattr(S, cls)(
        E.BoundReference(0, D.STRING, True, "s"), width, pad),
        _fault_batches())
    assert p == [spark_pad(s, width, pad, left) for s in FAULT_ROWS]
    if (width, pad) == (5, "") and left:
        assert j[0] == "  abc" and p[0] == "abc"
    if width == -1:
        assert j[0] == "\x00" * 7 and p[0] == ""


def test_pad_on_scalars_follows_spark():
    _jb, pb = _fault_batches()
    for width, pad in ((5, ""), (-1, "x"), (0, "x"), (6, "xy"), (2, "x")):
        for left in (True, False):
            cls = PS.StringLPad if left else PS.StringRPad
            got = cls(PE.Literal("abc", pdt.STRING), width, pad).eval(pb)
            assert got.value == spark_pad("abc", width, pad, left)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def test_wrappers_refuse_other_devices_and_twins_do_not_launch(batches):
    meta = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    mlen = torch.zeros(4, dtype=torch.int32, device="meta")
    mval = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        PS.string_map(meta, mlen, mval, PS.UPPER)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PS.string_slice(meta, mlen, mval, PS.TRIM)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PS.string_place([(meta, mlen, mval)], 4, 8, PS.LPAD, 5)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PS.find_pattern(meta, mlen, torch.zeros(1, dtype=torch.uint8,
                                                device="meta"), PS.LOCATE)
    before = native.counts()
    for build in CASES.values():
        _both(batches, build)
    assert native.counts() == before


@pytest.mark.parametrize("k", [33, 64, 65, 97])
def test_concat_above_32_operands_equals_the_one_pass_twin(batches, k):
    """string_place folds a concat of more than MAX_CONCAT_OPERANDS
    operands (columns and one-row scalars) through temporaries; the twin
    places all k in one pass. Exact."""
    _jb, pb = batches
    s = pb.columns[0]
    col = (s.data, s.lengths, s.validity)
    dash = (torch.tensor([[45] + [0] * 7], dtype=torch.uint8),
            torch.tensor([1], dtype=torch.int32), torch.tensor([True]))
    ops = [dash if i % 5 == 4 else col for i in range(k)]
    n = pb.capacity
    out_w = 1 << (sum(o[0].shape[1] for o in ops) - 1).bit_length()
    got = PS.string_place(ops, n, out_w, PS.CONCAT)
    want = PS._string_place_torch(ops, n, out_w, PS.CONCAT, 0,
                                  torch.zeros(0, dtype=torch.uint8))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1].max()) > 32 * 8


def test_no_operand_is_refused(batches):
    with pytest.raises(ValueError, match="at least one operand"):
        PS.string_place([], batches[1].capacity, 8, PS.CONCAT)


def test_locate_mode_equals_the_reference_steps(batches):
    """K13's LOCATE twin against the reference's own two steps (the first
    byte, then its char-start cumsum) on the batch's rows."""
    jb, pb = batches
    s = pb.columns[0]
    for p in ("l", "", "é", "\xbf", "llama"):
        pat = np.frombuffer(p.encode("utf-8"), np.uint8)
        found = np.asarray(JS._find_pattern(jb.columns[0].data,
                                            jb.columns[0].lengths, pat))
        cum = np.cumsum(np.asarray(JS._is_char_start(jb.columns[0].data)),
                        axis=1) - 1
        want = np.where(found >= 0, cum[np.arange(CAP),
                                        np.clip(found, 0, W - 1)] + 1, 0)
        got = PS.find_pattern(s.data, s.lengths,
                              torch.from_numpy(pat.copy()), PS.LOCATE)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Through the session: the API, and the incompat gate
# ---------------------------------------------------------------------------

TABLE = {"s": np.array(["abc", "Hello World", "  pad  ", "é漢x", "",
                        "llama", "naïve café", "x" * 20]),
         "k": np.arange(8, dtype=np.int64)}


def _select(F_, df):
    c = F_.col("s")
    return df.select(
        F_.col("k"), F_.length(c), F_.upper(c), F_.lower(c),
        F_.initcap(c), F_.substring(c, 2, 3), F_.substring(c, 0, 2),
        c.substr(F_.lit(1), F_.lit(2)), F_.concat(c, F_.lit("-"), c),
        F_.trim(c), F_.ltrim(c), F_.rtrim(c), F_.lpad(c, 9, "*"),
        F_.rpad(c, 4, "."), F_.locate("l", c), F_.instr(c, "a"),
        F_.locate("l", c, 3), F_.replace(c, "l", "L"), c.like("%l%"),
        c.like("_e%")).withColumnRenamed("k", "key").orderBy("key")


def test_string_functions_through_the_session_match_jax_engine():
    js = JaxSession.builder.config({"spark.rapids.tpu.sql.explain": "NONE",
                                    INCOMPAT: "true"}).getOrCreate()
    ps = TpuSession.builder.config({"spark.rapids.torch.device": "cpu",
                                    INCOMPAT: "true"}).getOrCreate()
    want = _select(JF, js.createDataFrame(TABLE)).collect()
    got = _select(F, ps.createDataFrame(TABLE)).collect()
    assert got == want and len(got) == 8
    assert _select(F, ps.createDataFrame(TABLE)).columns[0] == "key"


def test_case_mapping_needs_the_incompatible_ops_key():
    ps = TpuSession.builder.config("spark.rapids.torch.device",
                                   "cpu").getOrCreate()
    df = ps.createDataFrame(TABLE)
    for fn in (F.upper, F.lower, F.initcap):
        with pytest.raises(NotImplementedError, match=INCOMPAT):
            df.select(fn(F.col("s"))).collect()
    assert df.select(F.length(F.col("s"))).collect()[0] == (3,)
    ps.conf.set(INCOMPAT, "true")
    assert df.select(F.upper(F.col("s"))).collect()[0] == ("ABC",)
