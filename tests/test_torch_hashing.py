"""Parity of the PyTorch port's ops/hashing.py (Spark's murmur3) with the
JAX package's, and with Spark's own values.

The same seeded numpy arrays go into a JAX column (CPU, x64) and a port
column; on the CPU the port's wrapper runs the plain PyTorch twin of K11
(csrc/murmur3.cu). Hashes must match bit for bit for every key type and
chain, with one deliberate exception: a NaN whose bits are not the
canonical NaN. Spark hashes ``Double.doubleToLongBits`` and
``Float.floatToIntBits``, which canonicalise every NaN; the reference
hashes the raw bits (spark_rapids_tpu/ops/hashing.py:107-116). The port
hashes as Spark does (``test_non_canonical_nan_hashes_as_spark``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import hashing as JH

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import hashing as PH

CAP = 256
N = 230
TYPES = ("tinyint", "smallint", "int", "bigint", "date", "timestamp",
         "boolean", "float", "double", "string")
# canonical, x86's 0.0/0.0 (sign bit set) and a signalling NaN
NAN_BITS = {"double": (np.uint64, (0x7FF8000000000000, 0xFFF8000000000000,
                                   0x7FF0000000000001)),
            "float": (np.uint32, (0x7FC00000, 0xFFC00000, 0x7F800001))}


def _arrays(rng, tname: str, n: int = N, cap: int = CAP, width: int = 16):
    """Padded storage arrays [data, validity(, lengths)] of a column: 15%
    NULL; floats with -0.0, +-inf and the canonical NaN; strings of 0 to
    ``width`` random bytes (tails hold bytes >= 0x80)."""
    t = pdt.of(tname)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= 0.15
    if t == pdt.STRING:
        lens = np.zeros(cap, np.int32)
        lens[:n] = rng.integers(0, width + 1, n)
        lens[~valid] = 0
        data = rng.integers(0, 256, (cap, width)).astype(np.uint8)
        data[np.arange(width)[None, :] >= lens[:, None]] = 0
        return [data, valid, lens]
    data = np.zeros(cap, t.numpy_dtype)
    if t == pdt.BOOL:
        data[:n] = rng.integers(0, 2, n)
    elif t.is_floating:
        vals = rng.normal(0, 1e3, n).astype(t.numpy_dtype)
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan],
                           t.numpy_dtype)
        pick = rng.random(n) < 0.25
        vals[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        data[:n] = vals
    else:
        info = np.iinfo(t.numpy_dtype)
        data[:n] = rng.integers(info.min, info.max, n, endpoint=True,
                                dtype=t.numpy_dtype)
    data[~valid] = 0
    return [data, valid]


def _pair(tname: str, arrays):
    """(JAX column, port column) over the same arrays."""
    jc = JColumn(jdt.of(tname), *[jnp.asarray(a) for a in arrays])
    pc = PColumn(pdt.of(tname), *[torch.from_numpy(a.copy()) for a in arrays])
    return jc, pc


def _jax_hash(jcols, cap=CAP):
    return np.asarray(JH.murmur3_batch(jcols, cap)).astype(np.int32)


@pytest.mark.parametrize("tname", TYPES)
def test_murmur3_batch_matches_jax_per_type(tname):
    rng = np.random.default_rng(sum(map(ord, tname)))
    jc, pc = _pair(tname, _arrays(rng, tname))
    got = PH.murmur3_batch([pc], CAP).numpy()
    np.testing.assert_array_equal(got, _jax_hash([jc]))


@pytest.mark.parametrize("width", [8, 32])
def test_string_tails_with_high_bytes_match_jax(width):
    """Every length 0..width, every tail byte >= 0x80 (a signed block)."""
    rng = np.random.default_rng(width)
    lens = np.tile(np.arange(width + 1, dtype=np.int32), 4)[:CAP]
    n = len(lens)
    data = np.zeros((CAP, width), np.uint8)
    data[:n] = rng.integers(0x80, 256, (n, width))
    data[np.arange(width)[None, :] >= np.pad(lens, (0, CAP - n))[:, None]] = 0
    valid = np.zeros(CAP, np.bool_)
    valid[:n] = True
    jc, pc = _pair("string", [data, valid, np.pad(lens, (0, CAP - n))])
    np.testing.assert_array_equal(PH.murmur3_batch([pc], CAP).numpy(),
                                  _jax_hash([jc]))


CHAINS = [("int", "string"), ("bigint", "double", "date"),
          ("string", "string", "boolean"), ("timestamp", "float"),
          ("tinyint", "smallint", "bigint")]


@pytest.mark.parametrize("chain", CHAINS, ids=["-".join(c) for c in CHAINS])
def test_murmur3_chains_match_jax(chain):
    """Each column's hash seeds the next (Murmur3Hash(children, 42))."""
    rng = np.random.default_rng(len(chain) * 31 + len(chain[0]))
    pairs = [_pair(t, _arrays(rng, t)) for t in chain]
    got = PH.murmur3_batch([p for _j, p in pairs], CAP).numpy()
    np.testing.assert_array_equal(got, _jax_hash([j for j, _p in pairs]))


@pytest.mark.parametrize("tname", ["int", "bigint", "string", "double"])
def test_murmur3_column_with_row_seeds_matches_jax(tname):
    rng = np.random.default_rng(5)
    jc, pc = _pair(tname, _arrays(rng, tname))
    seeds = rng.integers(-2**31, 2**31, CAP, dtype=np.int64).astype(np.int32)
    want = np.asarray(JH.murmur3_column(
        jc, jnp.asarray(seeds.view(np.uint32)))).view(np.int32)
    got = PH.murmur3_column(pc, torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(got, want)


SPARK_VALUES = [("int", 0, 933211791), ("int", 42, 29417773),
                ("int", -1, -1604776387), ("bigint", 0, -1670924195),
                ("bigint", 42, 1316951768), ("string", "", 142593372),
                ("string", "abc", 1322437556)]


@pytest.mark.parametrize("tname,value,want", SPARK_VALUES)
def test_spark_literal_hashes(tname, value, want):
    """Spark's values, as tests/test_strings.py pins them for the JAX
    package."""
    col = PColumn.from_numpy(np.array([value], dtype=object if
                                      tname == "string" else None),
                             pdt.of(tname))
    assert int(PH.murmur3_batch([col], col.capacity)[0]) == want


@pytest.mark.parametrize("tname", ["double", "float"])
def test_non_canonical_nan_hashes_as_spark(tname):
    """Spark canonicalises NaN before hashing, so every NaN hashes as the
    canonical one (for a double: -1281358385). The JAX package hashes the
    raw bits: it agrees on the canonical NaN only (ROADMAP queue C)."""
    bits_t, patterns = NAN_BITS[tname]
    vals = np.zeros(128, np.dtype(jdt.of(tname).numpy_dtype))
    vals[:3] = np.array(patterns, bits_t).view(vals.dtype)
    valid = np.arange(128) < 3
    jc, pc = _pair(tname, [vals, valid])
    got = PH.murmur3_batch([pc], 128).numpy()[:3]
    ref = _jax_hash([jc], 128)[:3]
    assert len(set(got.tolist())) == 1
    if tname == "double":
        assert got[0] == -1281358385
    assert ref[0] == got[0]                 # canonical: the same bits
    assert ref[1] != got[1] and ref[2] != got[2]   # the reference's fault


def test_hash_partition_ids_are_pmod_of_the_hash():
    """pmod(hash, n) for live rows, n for padding (K11's partition ids)."""
    rng = np.random.default_rng(11)
    _jc, pc = _pair("bigint", _arrays(rng, "bigint"))
    h = PH.murmur3_batch([pc], CAP).numpy().astype(np.int64)
    for n in (1, 3, 8, 200):
        pid = PH.hash_partition_ids([pc], N, CAP, n).numpy()
        np.testing.assert_array_equal(pid[:N], np.mod(h[:N], n))
        assert (pid[N:] == n).all()


def test_f_hash_matches_jax_through_both_sessions():
    rng = np.random.default_rng(3)
    k = rng.integers(-1000, 1000, 300)
    s = np.array(["", "a", "héllo", "abcd", "abcde", "ÿþ"])[
        rng.integers(0, 6, 300)]
    d = rng.normal(size=300)
    d[::7] = -0.0
    data = {"k": k, "s": s, "d": d}
    jax_s = JaxSession.builder.config(
        {"spark.rapids.tpu.sql.explain": "NONE"}).getOrCreate()
    want = jax_s.createDataFrame(data).select(
        JF.hash(JF.col("k")), JF.hash(JF.col("s"), JF.col("d"))).collect()
    port_s = TpuSession.builder.config(
        "spark.rapids.torch.device", "cpu").getOrCreate()
    got = port_s.createDataFrame(data).select(
        F.hash(F.col("k")), F.hash(F.col("s"), F.col("d"))).collect()
    assert got == want
