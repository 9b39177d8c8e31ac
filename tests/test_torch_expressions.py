"""Parity of the PyTorch port's string comparisons, IN and CASE WHEN
(ops/predicates.py, ops/strings_util.py, ops/conditionals.py) with the JAX
package's, on the same seeded batch: result data and validity bit for
bit."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import conditionals as JC
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.ops import predicates as JP

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import conditionals as PC
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import predicates as PP

CAP = 256
N = 200
VOCAB = ["MAIL", "SHIP", "AIR", "REG AIR", "", "1-URGENT", "2-HIGH",
         "MAILBOX", "MAI"]
# (type, width) of the batch's columns: two strings of different widths,
# an int and a double
COLUMNS = (("string", 8), ("string", 16), ("bigint", None),
           ("double", None))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    vocab = np.array(VOCAB)
    values = [
        [None if rng.random() < 0.1 else str(x)
         for x in vocab[rng.integers(0, len(vocab), N)]],
        [None if rng.random() < 0.1 else str(x) + "-X" * int(k)
         for x, k in zip(vocab[rng.integers(0, len(vocab), N)],
                         rng.integers(0, 3, N))],
        [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(0, 5, N)],
        [None if rng.random() < 0.1 else float(x)
         for x in rng.integers(-2, 3, N) / 2],
    ]
    jcols, pcols, fields_j, fields_p = [], [], [], []
    for i, ((t, w), vals) in enumerate(zip(COLUMNS, values)):
        jc = JColumn.from_pylist(vals, jdt.of(t), capacity=CAP, width=w)
        jcols.append(jc)
        pcols.append(PColumn(pdt.of(t), *[torch.from_numpy(np.array(a))
                                          for a in jc.arrays()]))
        fields_j.append(jdt.Field(f"c{i}", jdt.of(t)))
        fields_p.append(pdt.Field(f"c{i}", pdt.of(t)))
    return (JBatch(jdt.Schema(fields_j), jcols, N),
            PBatch(pdt.Schema(fields_p), pcols, N))


def _ref(mod, dtmod, i):
    return mod.BoundReference(i, dtmod.of(COLUMNS[i][0]), True, f"c{i}")


def _build(side, name):
    """The named expression over one engine's classes."""
    E, P, C, D = (JE, JP, JC, jdt) if side == "jax" else (PE, PP, PC, pdt)
    s0, s1 = _ref(E, D, 0), _ref(E, D, 1)
    lit = E.Literal
    return {
        "eq_literal": P.EqualTo(s0, lit("MAIL")),
        "ne_literal": P.NotEqual(s0, lit("SHIP")),
        "eq_columns_widths_8_16": P.EqualTo(s0, s1),
        "lt_columns": P.LessThan(s0, s1),
        "le_literal_prefix": P.LessThanOrEqual(s0, lit("MAI")),
        "gt_literal_longer_than_column": P.GreaterThan(
            s0, lit("MAIL-LONGER-THAN-EIGHT")),
        "ge_literal": P.GreaterThanOrEqual(s1, lit("REG AIR")),
        "in_strings": P.In(s0, ["MAIL", "SHIP"]),
        "in_strings_with_null": P.In(s0, ["1-URGENT", None]),
        "in_ints": P.In(_ref(E, D, 2), [1, 3]),
        "case_when_strings": C.CaseWhen(
            [(P.In(s0, ["1-URGENT", "2-HIGH"]), lit(1)),
             (P.EqualTo(s0, lit("MAIL")), lit(2))], lit(0)),
        "case_when_no_else": C.CaseWhen(
            [(P.GreaterThan(_ref(E, D, 3), lit(0.0)), s1)]),
        "case_when_string_values": C.CaseWhen(
            [(P.IsNull(_ref(E, D, 2)), s0)], s1),
        "if_not_in": C.If(P.Not(P.In(s0, ["MAIL", "SHIP"])),
                          _ref(E, D, 2), lit(7)),
    }[name]


NAMES = ("eq_literal", "ne_literal", "eq_columns_widths_8_16", "lt_columns",
         "le_literal_prefix", "gt_literal_longer_than_column", "ge_literal",
         "in_strings", "in_strings_with_null", "in_ints",
         "case_when_strings", "case_when_no_else",
         "case_when_string_values", "if_not_in")


@pytest.mark.parametrize("name", NAMES)
def test_expression_matches_jax(batches, name):
    jb, pb = batches
    jout = JE.materialize(_build("jax", name).eval(jb), jb)
    pout = PE.materialize(_build("port", name).eval(pb), pb)
    assert str(pout.dtype) == str(jout.dtype)
    jarr = [np.asarray(a) for a in jout.arrays()]
    parr = [a.numpy() for a in pout.arrays()]
    assert len(parr) == len(jarr)
    for a, b in zip(jarr, parr):
        np.testing.assert_array_equal(b, a)


def test_string_literal_compare_folds_on_the_host(batches):
    _jb, pb = batches
    out = PP.LessThan(PE.Literal("AIR"), PE.Literal("MAIL")).eval(pb)
    assert out.value is True
    assert PP.EqualTo(PE.Literal("A"), PE.Literal(None)).eval(pb).is_null


@pytest.mark.parametrize("name", ("eq_literal", "ge_literal", "in_strings",
                                  "in_ints"))
def test_literals_are_copied_to_the_device_once_per_expression(batches,
                                                               name):
    """A literal operand goes to the device on the first batch; later
    batches reuse that copy."""
    _jb, pb = batches
    node = _build("port", name)
    first = PE.materialize(node.eval(pb), pb)
    cached = dict(node._literals)
    assert cached
    second = PE.materialize(node.eval(pb), pb)
    assert node._literals.keys() == cached.keys()
    assert all(node._literals[k] is v for k, v in cached.items())
    for a, b in zip(first.arrays(), second.arrays()):
        assert torch.equal(a, b)
