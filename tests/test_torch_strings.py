"""Parity of the PyTorch port's string pattern predicates (ops/strings.py)
with the JAX package's, on the CPU, where K13 (find_pattern) runs its
plain PyTorch twin.

``_find_pattern`` is held to the JAX function on seeded byte matrices
with junk bytes past each row's length, patterns from empty to longer than
the width, and multi-byte UTF-8; the prefix and suffix modes to numpy.
Contains, StartsWith and EndsWith are held to the JAX expressions on one
seeded batch with NULLs and dead rows, on scalar inputs and on a NULL
literal pattern. Everything is compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.ops import strings as JS

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import strings as PS

ALPHABET = np.frombuffer("absp ecé".encode("utf-8"), dtype=np.uint8)
PATTERNS = ("", "a", "ab", "spec", "é", "cé", "ba b", "abababab",
            "abababababababab", "abababababababababababababababababab")


def _matrix(rng, n: int, w: int):
    """(data uint8[n, w], lengths int32[n]): bytes drawn from a small
    alphabet (so patterns occur), lengths 0..w, and junk (non-zero) bytes
    past each length."""
    data = ALPHABET[rng.integers(0, len(ALPHABET), (n, w))]
    lengths = rng.integers(0, w + 1, n).astype(np.int32)
    lengths[:3] = (0, w, 1)
    return np.ascontiguousarray(data), lengths


def _pattern(p: str) -> np.ndarray:
    return np.frombuffer(p.encode("utf-8"), dtype=np.uint8)


@pytest.mark.parametrize("w", [8, 16, 32])
def test_find_pattern_matches_jax(w):
    rng = np.random.default_rng(w)
    data, lengths = _matrix(rng, 500, w)
    pd, pl = torch.from_numpy(data), torch.from_numpy(lengths)
    for p in PATTERNS:
        pat = _pattern(p)
        want = np.asarray(JS._find_pattern(jnp.asarray(data),
                                           jnp.asarray(lengths), pat))
        got = PS._find_pattern(pd, pl, pat)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=repr(p))
    # a match that ends exactly at the length counts, one byte further not
    row = np.zeros((2, w), np.uint8)
    row[:, w - 2:] = _pattern("ab")
    got = PS._find_pattern(torch.from_numpy(row),
                           torch.tensor([w, w - 1], dtype=torch.int32),
                           _pattern("ab"))
    assert got.tolist() == [w - 2, -1]


def _oracle(data, lengths, pat, mode):
    """Numpy: the K13 position in the prefix or suffix mode."""
    out = np.full(len(lengths), -1, np.int32)
    p = len(pat)
    for i, (row, n) in enumerate(zip(data, lengths)):
        if p == 0:
            out[i] = 0
        elif p <= n:
            j = 0 if mode == PS.PREFIX else n - p
            if bytes(row[j:j + p]) == bytes(pat):
                out[i] = j
    return out


@pytest.mark.parametrize("mode", [PS.PREFIX, PS.SUFFIX])
def test_prefix_and_suffix_modes_match_numpy(mode):
    rng = np.random.default_rng(mode)
    data, lengths = _matrix(rng, 400, 16)
    pd, pl = torch.from_numpy(data), torch.from_numpy(lengths)
    for p in PATTERNS:
        pat = _pattern(p)
        got = PS.find_pattern(pd, pl, torch.from_numpy(pat.copy()), mode)
        np.testing.assert_array_equal(got.numpy(),
                                      _oracle(data, lengths, pat, mode),
                                      err_msg=repr(p))


CAP, N = 256, 200
WORDS = ["special requests", "carefully special", "requests", "", "é",
         "pending deposits", "spécial", "ironic requests special",
         "ab" * 16]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    vals = [None if rng.random() < 0.15 else WORDS[i]
            for i in rng.integers(0, len(WORDS), N)]
    jc = JColumn.from_pylist(vals, jdt.STRING, capacity=CAP, width=32)
    pc = PColumn(pdt.STRING, *[torch.from_numpy(np.array(a))
                               for a in jc.arrays()])
    return (JBatch(jdt.Schema([jdt.Field("s", jdt.STRING)]), [jc], N),
            PBatch(pdt.Schema([pdt.Field("s", pdt.STRING)]), [pc], N))


def _expr(side, cls, child, pattern):
    E, S, D = (JE, JS, jdt) if side == "jax" else (PE, PS, pdt)
    if child == "column":
        c = E.BoundReference(0, D.STRING, True, "s")
    else:
        c = E.Literal(child, D.STRING)
    return getattr(S, cls)(c, E.Literal(pattern, D.STRING))


CLASSES = ("Contains", "StartsWith", "EndsWith")
PREDICATE_PATTERNS = ("special", "requests", "", "é", "spécial",
                      "ab" * 16, "ab" * 17, None)


@pytest.mark.parametrize("pattern", PREDICATE_PATTERNS)
@pytest.mark.parametrize("cls", CLASSES)
def test_pattern_predicates_match_jax(batches, cls, pattern):
    """A column with NULLs and dead rows past N; an empty, a UTF-8, an
    exactly-as-wide, an over-long and a NULL literal pattern."""
    jb, pb = batches
    jout = JE.materialize(_expr("jax", cls, "column", pattern).eval(jb), jb)
    pout = PE.materialize(_expr("port", cls, "column", pattern).eval(pb),
                          pb)
    assert str(pout.dtype) == str(jout.dtype) == "boolean"
    for a, b in zip(jout.arrays(), pout.arrays()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if pattern is None:
        assert not pout.validity.any()


@pytest.mark.parametrize("cls", CLASSES)
def test_pattern_predicates_on_scalars_match_jax(batches, cls):
    jb, pb = batches
    for child in ("special requests", "é", "", None):
        for pattern in ("special", "requests", "", None):
            j = _expr("jax", cls, child, pattern).eval(jb)
            p = _expr("port", cls, child, pattern).eval(pb)
            assert (p.value, p.is_null) == (j.value, j.is_null), \
                (cls, child, pattern)


def test_column_pattern_raises_and_wrapper_refuses_other_devices(batches):
    _jb, pb = batches
    ref = PE.BoundReference(0, pdt.STRING, True, "s")
    with pytest.raises(NotImplementedError, match="column pattern"):
        PS.Contains(ref, ref).eval(pb)
    meta = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        PS.find_pattern(meta, torch.zeros(4, dtype=torch.int32,
                                          device="meta"),
                        torch.zeros(1, dtype=torch.uint8, device="meta"))


def test_the_twin_runs_without_a_launch(batches):
    """On the CPU the wrapper runs its twin: the launch counter stays."""
    _jb, pb = batches
    before = native.counts()["find_pattern"]
    PS.Contains(PE.BoundReference(0, pdt.STRING, True, "s"),
                PE.Literal("special", pdt.STRING)).eval(pb)
    assert native.counts()["find_pattern"] == before
