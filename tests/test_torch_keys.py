"""Wide key lists and many partitions in the PyTorch port, against the JAX
package's engine on the CPU.

K2 (sort_key_lanes), K3 (segment_bounds) and K11 (murmur3) take at most
MAX_KEYS (8) key columns a call; their wrappers split longer key lists into
blocks and combine them (the lanes of each block one after another, the
starts OR-ed, the hash chained through per-row seeds). The CPU twins go
through the same block logic, so a 9-key and a 17-key sort, group-by and
hash exchange are held here to the JAX engine (rows and pieces bit for
bit, float sums within 1e-12 relative), and each blocked result to the
one-pass twin over all keys at once. K12 (partition_split) keeps its
counters in device memory above 4096 partitions: ``repartition(8192)``
is held to the JAX engine, ``shuffle.partitions = 8192`` to numpy, and
5000 and 65536 partitions to a stable sort and bincount.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import expressions as jex
from spark_rapids_tpu.shuffle import partitioning as JP

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import expressions as pex
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.shuffle import partitioning as PP

ROWS = 300
WORDS = np.array(["", "a", "MAIL", "héllo", "x" * 11])


def _table(n_keys: int, rows: int = ROWS, seed: int = 0) -> dict:
    """``n_keys`` low-cardinality key columns (int64, string, double and
    int32 in turn, so later keys break the ties of earlier ones) and a
    double value."""
    rng = np.random.default_rng(seed + n_keys)
    out = {}
    for i in range(n_keys):
        kind = i % 4
        if kind == 0:
            out[f"k{i}"] = rng.integers(0, 3, rows).astype(np.int64)
        elif kind == 1:
            out[f"k{i}"] = WORDS[rng.integers(0, 3, rows)]
        elif kind == 2:
            out[f"k{i}"] = rng.integers(0, 2, rows) / 4.0
        else:
            out[f"k{i}"] = rng.integers(-1, 2, rows).astype(np.int32)
    out["v"] = rng.integers(-400, 400, rows) / 4.0
    return out


def _sessions(**conf):
    js = JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false",
        **conf}).getOrCreate()
    ps = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    return js, ps


def _assert_rows_equal(got, want, rel=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=0), (g, w)
            else:
                assert x == y, (g, w)


@pytest.mark.parametrize("n_keys", [9, 17])
def test_wide_key_sort_matches_jax_engine(n_keys):
    data = _table(n_keys)
    keys = [f"k{i}" for i in range(n_keys)]
    js, ps = _sessions()
    want = js.createDataFrame(data).orderBy(
        *[JF.col(k).desc() if i % 3 == 1 else JF.col(k) for i, k in
          enumerate(keys)], "v").collect()
    got = ps.createDataFrame(data).orderBy(
        *[F.col(k).desc() if i % 3 == 1 else F.col(k) for i, k in
          enumerate(keys)], "v").collect()
    assert got == want


@pytest.mark.parametrize("n_keys", [9, 17])
def test_wide_key_group_by_matches_jax_engine(n_keys):
    """One partition: K2's lanes sort the keys, K3 finds the groups.
    (Above one partition the JAX engine concatenates its partial groups at
    un-bucketed row counts, which the reference's own size-class gate,
    tests/test_zz_recompile_gate.py, then flags in the same process; the
    hash exchange of wide keys is held to the reference below.)"""
    data = _table(n_keys)
    keys = [f"k{i}" for i in range(n_keys)]
    js, ps = _sessions()
    want = js.createDataFrame(data).groupBy(*keys).agg(
        JF.count("*").alias("n"), JF.sum("v").alias("s")).orderBy(
        *keys).collect()
    got = ps.createDataFrame(data).groupBy(*keys).agg(
        F.count("*").alias("n"), F.sum("v").alias("s")).orderBy(
        *keys).collect()
    assert len(got) > 1
    _assert_rows_equal(got, want)


def _batches(n_keys: int):
    """(JAX batch, port batch) of the key columns over the same arrays,
    NULLs included, a capacity past the rows."""
    data = _table(n_keys, rows=200, seed=3)
    cap = 256
    rng = np.random.default_rng(n_keys)
    jcols, pcols, fields = [], [], []
    for name, vals in data.items():
        valid = rng.random(len(vals)) >= 0.1
        jt = jdt.STRING if vals.dtype.kind == "U" else jdt.of(vals.dtype)
        jc = JColumn.from_pylist(
            [v.item() if ok else None for v, ok in zip(vals, valid)], jt,
            capacity=cap)
        pc = PColumn(pdt.of(str(jt)), *[torch.from_numpy(np.array(a))
                                        for a in jc.arrays()])
        jcols.append(jc)
        pcols.append(pc)
        fields.append((name, str(jt)))
    jb = JBatch(jdt.Schema([jdt.Field(n, jdt.of(t)) for n, t in fields]),
                jcols, 200)
    pb = PBatch(pdt.Schema([pdt.Field(n, pdt.of(t)) for n, t in fields]),
                pcols, 200)
    return jb, pb, fields


@pytest.mark.parametrize("n_keys", [9, 17])
def test_wide_key_hash_exchange_matches_jax(n_keys):
    """murmur3 over 9 and 17 columns, chained across the blocks: the
    partition ids and the pieces equal the reference's."""
    jb, pb, fields = _batches(n_keys)
    idx = range(n_keys)
    jref = [jex.BoundReference(i, jdt.of(fields[i][1]), True) for i in idx]
    pref = [pex.BoundReference(i, pdt.of(fields[i][1]), True) for i in idx]
    jpart, ppart = JP.HashPartitioner(5, jref), PP.HashPartitioner(5, pref)
    np.testing.assert_array_equal(ppart.partition_ids(pb).numpy()[:200],
                                  np.asarray(jpart.partition_ids(jb))[:200])
    for jp, pp in zip(jpart.split(jb), ppart.split(pb)):
        assert jp.num_rows == pp.num_rows
        for jc, pc in zip(jp.columns, pp.columns):
            for ja, pa in zip(jc.arrays(), pc.arrays()):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n_keys", [9, 17])
def test_key_blocks_equal_the_one_pass_twins(n_keys):
    """The blocked wrappers against the twins over all keys in one pass:
    the same sort order, the same group bounds, the same hashes."""
    _jb, pb, _fields = _batches(n_keys)
    cols = pb.columns[:n_keys]
    cap = pb.capacity
    assert len(K.key_blocks(cols)) == -(-n_keys // K.MAX_KEYS)
    keys = [K.SortKey(c, ascending=i % 2 == 0, nulls_first=i % 3 != 0)
            for i, c in enumerate(cols)]
    lanes = K.sort_key_lanes(keys, 200, cap)
    assert lanes.shape[0] == K.lane_count(keys)
    perm = K.lanes_order(lanes)
    assert torch.equal(perm, K.lanes_order(
        K._sort_key_lanes_torch(keys, 200, cap)))
    srt = [K.gather_column(c, perm) for c in cols]
    got = K.segment_bounds(srt, 200, cap)
    want = K._segment_bounds_torch(srt, 200, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h, pid = H.murmur3(cols, cap, H.SEED, 7, 200)
    wh, wpid = H._murmur3_torch(cols, cap, H.SEED, 7, 200)
    assert torch.equal(h, wh) and torch.equal(pid, wpid)


# ---------------------------------------------------------------------------
# More partitions than K12's shared memory holds
# ---------------------------------------------------------------------------

# above the 4096 partitions K12 counts in shared memory; a power of two,
# because the JAX engine compiles its split per partition count and its own
# size-class gate (tests/test_zz_recompile_gate.py) flags any other count
# left in the process's compiled signatures
MANY_PARTITIONS = 8192


def test_repartition_into_many_partitions_matches_jax_engine():
    """The rows come back partition by partition: the same rows in the
    same order as the JAX engine's."""
    data = _table(2, rows=400)
    js, ps = _sessions()
    want = js.createDataFrame(data).repartition(
        MANY_PARTITIONS, "k0", "k1").collect()
    got = ps.createDataFrame(data).repartition(
        MANY_PARTITIONS, "k0", "k1").collect()
    assert got == want and len(got) == 400


def test_many_shuffle_partitions_match_numpy():
    """A grouped aggregate above a round-robin exchange: partial -> hash
    exchange into 8192 partitions -> final, against numpy. (The JAX
    engine takes ~18 s for this plan on the CPU, so the reference is held
    to the same hash split above, not to this run.)"""
    data = _table(1, rows=400)
    _js, ps = _sessions(**{"spark.rapids.tpu.sql.shuffle.partitions":
                           MANY_PARTITIONS})
    got = ps.createDataFrame(data).repartition(2).groupBy("k0").agg(
        F.sum("v").alias("s"), F.count("*").alias("n")).orderBy(
        "k0").collect()
    keys = np.unique(data["k0"])
    want = [(int(k), float(data["v"][data["k0"] == k].sum()),
             int((data["k0"] == k).sum())) for k in keys]
    _assert_rows_equal(got, want)
    assert "TpuHashExchangeExec" in ps.last_plan().operator_tree()


@pytest.mark.parametrize("n", [5000, 65536])
def test_partition_split_takes_any_partition_count(n):
    """The wrapper's old 4096 limit is gone: 5000 and 65536 partitions
    split as a stable sort by partition id (padding last) and its
    bincount."""
    rng = np.random.default_rng(n)
    cap, rows = 4096, 4000
    pids = torch.from_numpy(rng.integers(0, n, cap).astype(np.int32))
    perm, counts = PP.partition_split(pids, rows, n)
    bins = np.where(np.arange(cap) < rows, pids.numpy(), n)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(bins, kind="stable"))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(bins, minlength=n + 1)[:n])
