"""Parity of the PyTorch port's shuffle/partitioning.py and
shuffle/exchange.py with the JAX package's, and the partial -> exchange ->
final aggregate through both sessions.

The same seeded numpy arrays go into a JAX batch (CPU, x64) and a port
batch; on the CPU the port's wrappers run the plain PyTorch twins of K11
(murmur3) and K12 (partition_split). Hash, round-robin and single pieces
must equal the reference's bit for bit, in row order; range bounds must be
equal and range pieces equal on int, date and string keys. On f64 keys
the port compares exactly where the reference narrows to f32, so only the
sorted concatenation is held equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import expressions as jex
from spark_rapids_tpu.plan import logical as jlp
from spark_rapids_tpu.shuffle import partitioning as JP

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.exec.pipeline import PipelineWindow
from spark_rapids_tpu_torch.ops import expressions as pex
from spark_rapids_tpu_torch.plan import logical as plp
from spark_rapids_tpu_torch.shuffle import exchange as PX
from spark_rapids_tpu_torch.shuffle import partitioning as PP

CAP = 512
N = 470
COLS = (("k", "bigint"), ("s", "string"), ("d", "double"), ("t", "date"))


def _arrays(rng, tname: str, n: int, cap: int, nulls: float = 0.1):
    t = pdt.of(tname)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= nulls
    if t == pdt.STRING:
        words = np.array(["", "MAIL", "SHIP", "AIR", "TRUCK", "REG AIR",
                          "héllo wörld", "x" * 13])
        vals = words[rng.integers(0, len(words), n)]
        enc = [w.encode() for w in vals]
        width = 16
        data = np.zeros((cap, width), np.uint8)
        lens = np.zeros(cap, np.int32)
        for i, b in enumerate(enc):
            if valid[i]:
                data[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
        return [data, valid, lens]
    data = np.zeros(cap, t.numpy_dtype)
    if t.is_floating:
        data[:n] = rng.integers(-40, 40, n) / 4
    else:
        data[:n] = rng.integers(-60, 60, n)
    data[~valid] = 0
    return [data, valid]


def _batches(rng, n: int = N, cap: int = CAP, cols=COLS, nulls=0.1):
    """(JAX batch, port batch) over the same arrays."""
    arrays = [_arrays(rng, t, n, cap, nulls) for _name, t in cols]
    jb = JBatch(jdt.Schema([jdt.Field(c, jdt.of(t)) for c, t in cols]),
                [JColumn(jdt.of(t), *[jnp.asarray(a) for a in arrs])
                 for (_c, t), arrs in zip(cols, arrays)], n)
    pb = PBatch(pdt.Schema([pdt.Field(c, pdt.of(t)) for c, t in cols]),
                [PColumn(pdt.of(t), *[torch.from_numpy(a.copy())
                                      for a in arrs])
                 for (_c, t), arrs in zip(cols, arrays)], n)
    return jb, pb


def _assert_pieces_equal(jpieces, ppieces):
    assert len(jpieces) == len(ppieces)
    for p, (j, q) in enumerate(zip(jpieces, ppieces)):
        assert j.num_rows == q.num_rows, p
        if j.num_rows == 0:
            continue
        assert j.capacity == q.capacity, p
        for jc, pc in zip(j.columns, q.columns):
            for ja, pa in zip(jc.arrays(), pc.arrays()):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


def _refs(module, cols, idx):
    return [module.BoundReference(i, (jdt if module is jex else pdt).of(
        cols[i][1]), True) for i in idx]


@pytest.mark.parametrize("n_parts", [1, 3, 8])
@pytest.mark.parametrize("keys", [(0,), (1,), (0, 1, 3), (2,)],
                         ids=["int64", "string", "three", "double"])
def test_hash_split_matches_jax(n_parts, keys):
    rng = np.random.default_rng(n_parts * 10 + len(keys))
    jb, pb = _batches(rng)
    jpart = JP.HashPartitioner(n_parts, _refs(jex, COLS, keys))
    ppart = PP.HashPartitioner(n_parts, _refs(pex, COLS, keys))
    np.testing.assert_array_equal(
        ppart.partition_ids(pb).numpy()[:N],
        np.asarray(jpart.partition_ids(jb))[:N])
    _assert_pieces_equal(jpart.split(jb), ppart.split(pb))


@pytest.mark.parametrize("n_parts", [3, 8])
def test_null_key_goes_to_pmod_of_the_seed(n_parts):
    """A NULL leaves the seed, so a one-key NULL row lands in
    pmod(42, n) in both engines."""
    rng = np.random.default_rng(1)
    jb, pb = _batches(rng, nulls=1.0)
    ppart = PP.HashPartitioner(n_parts, _refs(pex, COLS, (0,)))
    assert (ppart.partition_ids(pb).numpy()[:N] == 42 % n_parts).all()
    pieces = ppart.split(pb)
    assert [p.num_rows for p in pieces] == \
        [N if i == 42 % n_parts else 0 for i in range(n_parts)]
    jpart = JP.HashPartitioner(n_parts, _refs(jex, COLS, (0,)))
    _assert_pieces_equal(jpart.split(jb), pieces)


@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_empty_batch_splits_into_empty_pieces(n_parts):
    rng = np.random.default_rng(2)
    jb, pb = _batches(rng, n=0, cap=128)
    for count in (0, torch.tensor(0)):        # host and device counts
        pb = PBatch(pb.schema, pb.columns, count)
        pieces = PP.HashPartitioner(n_parts, _refs(pex, COLS, (0,))).split(
            pb)
        assert len(pieces) == n_parts
        assert all(p.num_rows == 0 for p in pieces)
    jpieces = JP.HashPartitioner(n_parts, _refs(jex, COLS, (0,))).split(jb)
    assert [p.num_rows for p in jpieces] == [0] * n_parts


@pytest.mark.parametrize("n_parts", [2, 3, 8])
def test_round_robin_and_single_match_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    jb, pb = _batches(rng)
    _assert_pieces_equal(JP.RoundRobinPartitioner(n_parts).split(jb),
                         PP.RoundRobinPartitioner(n_parts).split(pb))
    single = PP.SinglePartitioner().split(pb)
    assert len(single) == 1 and single[0] is pb
    assert len(JP.SinglePartitioner().split(jb)) == 1


def _range_pair(rng, key, ascending, n_parts, batches=3):
    """Partitioners of both engines over the same sample batches."""
    samples = [_batches(rng, n=200 + 13 * i, cap=256) for i in range(batches)]
    jorders = [jlp.SortOrder(r, ascending) for r in _refs(jex, COLS, key)]
    porders = [plp.SortOrder(r, ascending) for r in _refs(pex, COLS, key)]
    return (JP.RangePartitioner(n_parts, jorders, [j for j, _p in samples]),
            PP.RangePartitioner(n_parts, porders, [p for _j, p in samples]))


RANGE_KEYS = {"int64": (0,), "date": (3,), "string": (1,),
              "string_int64": (1, 0)}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("key", list(RANGE_KEYS))
def test_range_bounds_and_pieces_match_jax(key, ascending):
    rng = np.random.default_rng(len(key) + 7 * ascending)
    jpart, ppart = _range_pair(rng, RANGE_KEYS[key], ascending, 4)
    jb, pb = _batches(rng)
    pieces = ppart.split(pb)
    jbounds = jpart._compute_bounds(jb.schema)
    pbounds = ppart.bounds()
    assert pbounds.num_rows == jbounds.num_rows == 3
    for jc, pc in zip(jbounds.columns, pbounds.columns):
        for ja, pa in zip(jc.arrays(), pc.arrays()):
            np.testing.assert_array_equal(pa.numpy()[:3],
                                          np.asarray(ja)[:3])
    _assert_pieces_equal(jpart.split(jb), pieces)


def _rows(piece, key):
    c = piece.columns[key]
    n = piece.num_rows
    return [None if not v else float(x) for x, v in zip(
        np.asarray(c.data)[:n], np.asarray(c.validity)[:n])]


def test_range_on_doubles_gives_the_same_sorted_rows():
    """The reference narrows f64 order keys to f32 (partitioning.py:283);
    the port orders exactly, so a piece may differ by a row near a bound,
    but the pieces sorted and concatenated are the same rows."""
    rng = np.random.default_rng(4)
    jpart, ppart = _range_pair(rng, (2,), True, 5)
    jb, pb = _batches(rng)

    def sorted_concat(pieces):
        out = []
        for p in pieces:
            out.extend(sorted(_rows(p, 2),
                              key=lambda x: (x is not None, x or 0.0)))
        return out
    got = sorted_concat(ppart.split(pb))
    assert got == sorted_concat(jpart.split(jb))
    assert len(got) == N


@pytest.mark.parametrize("depth", [1, 8])
def test_local_shuffle_window_depths_give_equal_pieces(depth):
    """The split's counts parked on a window of any depth: the same
    pieces, in map order, as splitting each batch at once."""
    rng = np.random.default_rng(9)
    batches = [_batches(rng, n=300 + i, cap=512)[1] for i in range(5)]
    part = PP.HashPartitioner(8, _refs(pex, COLS, (0,)))
    deferred, blocking = PX.LocalShuffle(8), PX.LocalShuffle(8)
    win = PipelineWindow(depth)
    for b in batches:
        deferred.write_deferred(win, part, b)
        blocking.write(part, b)
    win.flush()
    assert win.resolves == (len(batches) if depth == 1 else 2)
    for p in range(8):
        a = list(deferred.read(p, batches[0].schema, "cpu"))
        b = list(blocking.read(p, batches[0].schema, "cpu"))
        _assert_pieces_equal(a, b)
        assert deferred.slices[p] == []       # released once read


def _group_data(rng, n=3000):
    k = rng.integers(0, 200, n)
    v = rng.integers(-100, 100, n).astype(np.float64) / 4
    return {"k": k, "v": v, "s": np.array(["a", "bb", "ccc"])[k % 3]}


def _jax_session(parts):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false",
        "spark.rapids.tpu.sql.shuffle.partitions": parts}).getOrCreate()


def _port_session(parts):
    return TpuSession.builder.config({
        "spark.rapids.torch.device": "cpu",
        "spark.rapids.tpu.sql.reader.batchSizeRows": 1000,
        "spark.rapids.tpu.sql.shuffle.partitions": parts}).getOrCreate()


def _grouped(F_, df, how):
    if how == "repartition_key":
        df = df.repartition(4, "k")
    elif how == "repartition":
        df = df.repartition(4)
    elif how == "coalesce":
        df = df.coalesce(1)
    return df.groupBy("k").agg(F_.sum("v").alias("sv"),
                               F_.count("*").alias("n"),
                               F_.max("s").alias("ms"))


@pytest.mark.parametrize("how", ["repartition_key", "repartition",
                                 "coalesce"])
def test_repartition_then_group_by_matches_jax(how):
    """repartition(4[, k]) gives partial -> hash exchange -> final in both
    engines; coalesce(1) keeps one partition and a complete aggregate."""
    rng = np.random.default_rng(12)
    data = _group_data(rng)
    js = _jax_session(3)
    want = _grouped(JF, js.createDataFrame(data), how).collect()
    ps = _port_session(3)
    got = _grouped(F, ps.createDataFrame(data), how).collect()
    assert sorted(got) == sorted(want)
    assert ps.last_plan().operator_tree() == str(js.last_plan())
    tree = ps.last_plan().tree_string()
    if how == "coalesce":
        assert "[partial]" not in tree
    else:
        assert "TpuHashAggregateExec[partial]" in tree and \
            "TpuHashAggregateExec[final]" in tree


def test_global_aggregate_over_partitions_meets_on_one():
    rng = np.random.default_rng(13)
    data = _group_data(rng)
    js, ps = _jax_session(8), _port_session(8)
    want = js.createDataFrame(data).repartition(5).agg(
        JF.sum("v"), JF.count("*")).collect()
    got = ps.createDataFrame(data).repartition(5).agg(
        F.sum("v"), F.count("*")).collect()
    assert got == want
    assert ps.last_plan().operator_tree() == str(js.last_plan())


def _jax_plan(session, df) -> str:
    """The JAX engine's plan of ``df``, planned but not run."""
    from spark_rapids_tpu.plan.overrides import Overrides
    return str(Overrides(session.conf).apply(df._analyzed()))


def test_order_by_over_partitions_is_a_range_exchange():
    """A global sort above three partitions: range exchange, local sorts,
    then the limit takes the first rows across the partitions in order
    (rows held to numpy, the plan to the JAX engine's)."""
    rng = np.random.default_rng(14)
    data = _group_data(rng, 600)
    ps = _port_session(3)
    got = ps.createDataFrame(data).repartition(3, "s").orderBy(
        F.col("v").desc(), "k").limit(50).collect()
    order = np.lexsort((data["k"], -data["v"]))[:50]
    assert got == [(int(data["k"][i]), float(data["v"][i]),
                    str(data["s"][i])) for i in order]
    js = _jax_session(3)
    jdf = js.createDataFrame(data).repartition(3, "s").orderBy(
        JF.col("v").desc(), "k").limit(50)
    assert ps.last_plan().operator_tree() == _jax_plan(js, jdf)
    assert "TpuRangeExchangeExec" in ps.last_plan().operator_tree()


def test_more_partitions_than_the_kernel_holds_raise():
    """What this checks: an 8192-partition hash split equals the JAX
    engine's, partition ids and pieces bit for bit. The name is from when
    K12 refused more than the 4096 partitions whose counters fit in its
    shared memory; above that it now keeps them in device memory, with no
    limit, as in the reference. 8192 is a power of two because the
    reference's size-class gate (tests/test_zz_recompile_gate.py) flags
    any other count its split compiles in the same process; 5000
    partitions are held to a stable sort in tests/test_torch_keys.py."""
    rng = np.random.default_rng(15)
    jb, pb = _batches(rng)
    ppart = PP.HashPartitioner(8192, _refs(pex, COLS, (0,)))
    jpart = JP.HashPartitioner(8192, _refs(jex, COLS, (0,)))
    np.testing.assert_array_equal(ppart.partition_ids(pb).numpy()[:N],
                                  np.asarray(jpart.partition_ids(jb))[:N])
    _assert_pieces_equal(jpart.split(jb), ppart.split(pb))
