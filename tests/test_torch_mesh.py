"""The PyTorch port's parallel/mesh.py against the JAX package's, function
by function, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
sets up; the port's mesh is 8 workers on the CPU, where K29 and K30 run
their plain twins (and K2-K4, K6, K11, K12 theirs). The same seeded numpy
shards go into both. Every array of every worker's output must be equal:
integer, bool, string and count arrays bit for bit; float arrays bit for
bit where their values are quarters (sums exact in any order) and within
1e-9 relative otherwise. Worker counts and capacities are powers of two,
and each JAX mesh program shape compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.parallel import mesh as JM

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.parallel import mesh as PM

N = 8
CAP = 128
WORDS = ["", "MAIL", "SHIP", "AIR", "TRUCK", "REG AIR", "héllo wörld",
         "x" * 13]


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= N
    return JM.make_mesh(N), PM.make_mesh(N, "cpu")


# ---------------------------------------------------------------------------
# Inputs: the same numpy arrays as a JAX shard and a port shard
# ---------------------------------------------------------------------------

def _arrays(rng, tname, n, cap, nulls=0.1, hi=20, quarters=True,
            junk=False):
    t = pdt.of(tname)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= nulls
    if t == pdt.STRING:
        width = 16
        data = np.zeros((cap, width), np.uint8)
        lens = np.zeros(cap, np.int32)
        for i, w in enumerate(np.array(WORDS)[rng.integers(0, len(WORDS),
                                                           n)]):
            b = w.encode()
            if junk:
                data[i] = rng.integers(1, 255, width)
            if valid[i]:
                data[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
        return [data, valid, lens]
    data = np.zeros(cap, t.numpy_dtype)
    if t.is_floating:
        data[:n] = rng.integers(-4 * hi, 4 * hi, n) / 4 if quarters \
            else rng.normal(0, hi, n)
    else:
        data[:n] = rng.integers(0, hi, n)
    data[~valid] = 0
    return [data, valid]


def _pair(cols, arrays_list, n):
    """(JAX batch, port batch) over the same arrays."""
    jb = JBatch(jdt.Schema([jdt.Field(c, jdt.of(t)) for c, t in cols]),
                [JColumn(jdt.of(t), *[jnp.asarray(a) for a in arrs])
                 for (_c, t), arrs in zip(cols, arrays_list)], n)
    pb = PBatch(pdt.Schema([pdt.Field(c, pdt.of(t)) for c, t in cols]),
                [PColumn(pdt.of(t), *[torch.from_numpy(a.copy())
                                      for a in arrs])
                 for (_c, t), arrs in zip(cols, arrays_list)], n)
    return jb, pb


def _shards(seed, cols, rows=None, cap=CAP, **kw):
    """Per worker (JAX shard, port shard); ``rows`` per worker (default:
    random, one empty worker)."""
    rng = np.random.default_rng(seed)
    if rows is None:
        rows = [int(x) for x in rng.integers(1, cap + 1, N)]
        rows[3] = 0
    out = []
    for n in rows:
        arrays = [_arrays(rng, t, n, cap, **kw.get(c, {}))
                  for c, t in cols]
        out.append(_pair(cols, arrays, n))
    return [j for j, _ in out], [p for _, p in out]


def _assert_batches_equal(jbs, pbs, exact_floats=True, zero_sign=True):
    assert len(jbs) == len(pbs)
    for w, (jb, pb) in enumerate(zip(jbs, pbs)):
        assert pb.num_rows == jb.num_rows, f"worker {w}"
        assert len(jb.columns) == len(pb.columns)
        for jc, pc in zip(jb.columns, pb.columns):
            assert pc.dtype.name == jc.dtype.name
            for ja, pa in zip(jc.arrays(), pc.arrays()):
                _assert_array(np.asarray(ja), pa.numpy(),
                              f"worker {w} {pc.dtype}", exact_floats,
                              zero_sign)


def _assert_array(want, got, what, exact_floats=True, zero_sign=True):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind == "f" and not zero_sign:
        want, got = want + 0.0, got + 0.0      # -0.0 -> +0.0
    if got.dtype.kind == "f" and not exact_floats:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8), err_msg=what)


# ---------------------------------------------------------------------------
# K29 / K30 and the all_to_all
# ---------------------------------------------------------------------------

def _payload(rng, cap, n_rows, junk):
    ints = rng.integers(-2 ** 62, 2 ** 62, cap)
    ints[n_rows:] = 0
    flts = rng.integers(-400, 400, cap) / 4
    valid = rng.random(cap) < 0.8
    small = rng.integers(-(2 ** 15), 2 ** 15, cap).astype(np.int16)
    data, _v, lens = _arrays(rng, "string", n_rows, cap, junk=junk)
    return [ints, flts.astype(np.float32), valid, small, data, lens]


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("case", ["random", "empty_slots", "one_slot",
                                  "no_rows"])
def test_bucket_rows_matches_jax_and_one_pass(n, case):
    rng = np.random.default_rng(n * 31 + len(case))
    cap = 256
    n_rows = 0 if case == "no_rows" else 200
    arrays = _payload(rng, cap, n_rows, junk=True)
    if case == "one_slot":
        pids = np.full(cap, n - 1, np.int32)
    elif case == "empty_slots":
        pids = (rng.integers(0, max(1, n // 2), cap) * 2 % n).astype(
            np.int32)
    else:
        pids = rng.integers(0, n, cap).astype(np.int32)
    live = np.arange(cap) < n_rows
    p_out, p_counts = PM.bucket_rows_for_exchange(
        [torch.from_numpy(a) for a in arrays], torch.from_numpy(pids),
        torch.from_numpy(live), n, cap)
    j_out, j_counts = JM.bucket_rows_for_exchange(
        [jnp.asarray(a) for a in arrays], jnp.asarray(pids),
        jnp.asarray(live), n, cap)
    _assert_array(np.asarray(j_counts), p_counts.numpy(), "counts")
    for ja, pa in zip(j_out, p_out):
        _assert_array(np.asarray(ja), pa.numpy(), "slots")
    # the one-pass formula: each slot the live rows of its target, in order
    for a, pa in zip(arrays, p_out):
        for t in range(n):
            rows = np.nonzero(live & (pids == t))[0]
            want = np.zeros_like(a)
            want[:len(rows)] = a[rows]
            _assert_array(want, pa[t].numpy(), f"slot {t}")
    assert int(p_counts.sum()) == n_rows


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("case", ["random", "empty_slots", "one_slot",
                                  "no_rows"])
def test_flatten_received_matches_jax_and_one_pass(n, case):
    rng = np.random.default_rng(n * 17 + len(case))
    cap = 128
    if case == "no_rows":
        counts = np.zeros(n, np.int32)
    elif case == "one_slot":
        counts = np.zeros(n, np.int32)
        counts[n // 2] = cap
    elif case == "empty_slots":
        counts = np.where(np.arange(n) % 2 == 0, 0,
                          rng.integers(0, cap + 1, n)).astype(np.int32)
    else:
        counts = rng.integers(0, cap + 1, n).astype(np.int32)
    slots = [np.stack([_payload(rng, cap, cap, junk=True)[i]
                       for _ in range(n)]) for i in range(6)]
    out_cap = n * cap
    p_out, p_total = PM.flatten_received(
        [torch.from_numpy(s) for s in slots], torch.from_numpy(counts),
        out_cap)
    j_out, j_total = JM.flatten_received(
        [jnp.asarray(s) for s in slots], jnp.asarray(counts), out_cap)
    assert int(p_total) == int(j_total) == int(counts.sum())
    assert p_total.dtype == torch.int32
    for s, ja, pa in zip(slots, j_out, p_out):
        _assert_array(np.asarray(ja), pa.numpy(), "flat")
        want = np.zeros((out_cap,) + s.shape[2:], s.dtype)
        rows = np.concatenate([s[t, :counts[t]] for t in range(n)])
        want[:len(rows)] = rows
        _assert_array(want, pa.numpy(), "one pass")


def test_exchange_matches_jax_all_to_all(meshes):
    """The collective: slot t of worker w -> slot w of worker t."""
    jmesh, pmesh = meshes
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1000, (N, N, 16)).astype(np.int64)
    s = rng.integers(0, 255, (N, N, 16, 8)).astype(np.uint8)
    counts = rng.integers(0, 17, (N, N)).astype(np.int32)

    def per_worker(a, s, c):
        moved, mc = JM.exchange([a[0], s[0]], c[0], "workers")
        return moved[0][None], moved[1][None], mc[None]
    P = jax.sharding.PartitionSpec("workers")
    fn = jax.jit(JM._shard_map(per_worker, jmesh, (P, P, P), P))
    ja, js, jc = fn(jnp.asarray(a), jnp.asarray(s), jnp.asarray(counts))
    sends = [[torch.from_numpy(a[w]), torch.from_numpy(s[w]),
              torch.from_numpy(counts[w])] for w in range(N)]
    for collective in (pmesh.collective, PM.Collective(
            [torch.device("cpu")] * N)):
        # the second: the slot-copy path of workers on distinct devices
        collective.shared = collective is pmesh.collective
        recv = collective.all_to_all(sends)
        for t in range(N):
            _assert_array(np.asarray(ja)[t], recv[t][0].numpy(), "a")
            _assert_array(np.asarray(js)[t], recv[t][1].numpy(), "s")
            _assert_array(np.asarray(jc)[t], recv[t][2].numpy(), "counts")


def test_wrappers_refuse_other_devices_and_twins_launch_nothing():
    meta = torch.zeros(CAP, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        PM.bucket_rows_for_exchange([meta], meta, meta.bool(), 2, CAP)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PM.flatten_received([meta.reshape(2, 64)], meta[:2], CAP)
    before = native.counts()
    PM.flatten_received([torch.zeros(2, 64)],
                        torch.tensor([3, 4], dtype=torch.int32), CAP)
    assert native.counts() == before


# ---------------------------------------------------------------------------
# The pipelines
# ---------------------------------------------------------------------------

# the shapes of test_torch_mesh_plan.py's group-by (one JAX program)
GB_COLS = (("k", "bigint"), ("v", "double"), ("j", "bigint"))
GB_OPS = ["sum", "count", "avg", "min", "max", "count_star"]
GB_VALS = [1, 1, 1, 2, 2, 0]


@pytest.mark.parametrize("case", ["null_keys", "skew"])
def test_distributed_groupby_matches_jax(meshes, case):
    """sum/count/count_star/avg/min/max with NULL keys, and every row on
    one key (all groups on one worker)."""
    jmesh, pmesh = meshes
    kw = {"k": {"nulls": 0.2, "hi": 23}, "j": {"hi": 9}}
    if case == "skew":
        kw["k"] = {"nulls": 0.0, "hi": 1}
    jbs, pbs = _shards(11 + len(case), GB_COLS, cap=256, **kw)
    j = JM.run_distributed_groupby(jmesh, jbs, [0], GB_VALS, GB_OPS)
    p = PM.run_distributed_groupby(pmesh, pbs, [0], GB_VALS, GB_OPS)
    _assert_batches_equal(j, p)
    if case == "skew":
        assert sorted(b.num_rows for b in p) == [0] * (N - 1) + [1]


def test_distributed_groupby_string_keys_matches_jax(meshes):
    jmesh, pmesh = meshes
    cols = (("s", "string"), ("k", "int"), ("d", "double"))
    jbs, pbs = _shards(23, cols, k={"hi": 3})
    ops = ["sum", "count", "avg", "max", "count_star"]
    j = JM.run_distributed_groupby(jmesh, jbs, [0, 1], [2, 2, 2, 1, 2], ops)
    p = PM.run_distributed_groupby(pmesh, pbs, [0, 1], [2, 2, 2, 1, 2], ops)
    _assert_batches_equal(j, p)


def test_copartition_exchange_matches_jax(meshes):
    jmesh, pmesh = meshes
    cols = (("k", "bigint"), ("s", "string"), ("d", "double"),
            ("b", "boolean"))
    jbs, pbs = _shards(29, cols, k={"hi": 40})
    j = JM.run_copartition_exchange(jmesh, jbs, [0, 1])
    p = PM.run_copartition_exchange(pmesh, pbs, [0, 1])
    _assert_batches_equal(j, p)


def test_partition_exchange_matches_jax(meshes):
    """(the shapes of test_torch_mesh_plan.py's repartition)"""
    jmesh, pmesh = meshes
    jbs, pbs = _shards(31, GB_COLS, cap=256)
    rng = np.random.default_rng(3)
    parts = 8
    pids = [rng.integers(0, parts, 256).astype(np.int32) for _ in range(N)]
    j = JM.run_partition_exchange(jmesh, jbs, [jnp.asarray(x) for x in pids],
                                  parts)
    p = PM.run_partition_exchange(pmesh, pbs,
                                  [torch.from_numpy(x) for x in pids], parts)
    for (jcols, jcounts), (pcols, pcounts) in zip(j, p):
        np.testing.assert_array_equal(pcounts, jcounts)
        for jc, pc in zip(jcols, pcols):
            for ja, pa in zip(jc.arrays(), pc.arrays()):
                _assert_array(np.asarray(ja), pa.numpy(), "exchange")
    assert sum(int(c.sum()) for _cols, c in p) == sum(b.num_rows
                                                      for b in pbs)


# descending: the shapes of test_torch_mesh_plan.py's descending sort
SORT_COLS = (("d", "double"), ("i", "bigint"))


@pytest.mark.parametrize("asc", [True, False])
def test_distributed_sort_matches_jax(meshes, asc):
    """NULLs, NaN, -0.0 and ties, ascending and descending: every worker's
    range and order equal the reference's. The reference's jitted mesh
    programs return +0.0 for a -0.0 payload value (ROADMAP queue C); the
    port keeps the sign, so the zeros compare by value and the port's -0.0
    count is held to the input's."""
    jmesh, pmesh = meshes
    rng = np.random.default_rng(41)
    jbs, pbs = [], []
    for w in range(N):
        n = 0 if w == 5 else int(rng.integers(1, CAP + 1))
        d = _arrays(rng, "double", n, CAP, nulls=0.1, hi=6)
        special = rng.random(n)
        d[0][:n] = np.where(special < 0.1, np.nan,
                            np.where(special < 0.2, -0.0, d[0][:n]))
        d[0][~d[1]] = 0
        arrays = [d, _arrays(rng, "bigint", n, CAP, hi=3)]
        jb, pb = _pair(SORT_COLS, arrays, n)
        jbs.append(jb)
        pbs.append(pb)
    keys, ascs, nfs = [0, 1], [asc, True], [asc, True]
    j = JM.run_distributed_sort(jmesh, jbs, keys, ascs, nfs)
    p = PM.run_distributed_sort(pmesh, pbs, keys, ascs, nfs)
    _assert_batches_equal(j, p, zero_sign=False)

    def negative_zeros(batches):
        return sum(int(np.signbit(d[(d == 0)]).sum()) for d in (
            b.columns[0].data.numpy()[:b.num_rows] for b in batches))
    assert negative_zeros(p) == negative_zeros(pbs) > 0


# the shapes of test_torch_mesh_plan.py's streaming group-by
STREAM_COLS = (("k", "bigint"), ("v", "double"))
STREAM_OPS = ["sum", "count", "avg"]


def test_streaming_groupby_matches_jax(meshes):
    jmesh, pmesh = meshes
    jbs, pbs = _shards(43, STREAM_COLS, rows=[1500] * N, cap=2048,
                       k={"hi": 3000, "nulls": 0.05})
    # two rounds of 1024-row windows
    j = JM.run_distributed_groupby(jmesh, jbs, [0], [1, 1, 1], STREAM_OPS,
                                   window_rows=1024)
    p = PM.run_distributed_groupby(pmesh, pbs, [0], [1, 1, 1], STREAM_OPS,
                                   window_rows=1024)
    _assert_batches_equal(j, p)
    keys = np.concatenate([b.columns[0].data.numpy()[:b.num_rows][
        b.columns[0].validity.numpy()[:b.num_rows]] for b in pbs])
    nulls = any((~b.columns[0].validity.numpy()[:b.num_rows]).any()
                for b in pbs)
    assert sum(b.num_rows for b in p) == len(np.unique(keys)) + nulls


def test_streaming_groupby_string_keys_matches_jax(meshes):
    """Three rounds of 128-row windows (the session's key takes >= 1024,
    the function any)."""
    jmesh, pmesh = meshes
    cols = (("s", "string"), ("v", "double"))
    jbs, pbs = _shards(47, cols, rows=[300] * N, cap=512, s={"nulls": 0.1})
    j = JM.run_distributed_groupby(jmesh, jbs, [0], [1], ["sum"],
                                   window_rows=128)
    p = PM.run_distributed_groupby(pmesh, pbs, [0], [1], ["sum"],
                                   window_rows=128)
    _assert_batches_equal(j, p)


def test_streaming_string_keys_ignore_junk_bytes(meshes):
    """Bytes past a length and the bytes of NULL rows are masked before the
    word packing: junk there gives the same groups as zeros."""
    _jmesh, pmesh = meshes
    cols = (("s", "string"), ("v", "double"))
    _j, clean = _shards(53, cols, rows=[300] * N, cap=512, s={"nulls": 0.1})
    rng = np.random.default_rng(7)
    dirty = []
    for b in clean:
        s = b.columns[0]
        past = torch.arange(s.data.shape[1])[None, :] >= s.lengths[:, None]
        junk = torch.from_numpy(rng.integers(1, 256, tuple(s.data.shape))
                                .astype(np.uint8))
        data = torch.where(past | ~s.validity[:, None], junk, s.data)
        dirty.append(PBatch(b.schema, [PColumn(s.dtype, data, s.validity,
                                               s.lengths)] + b.columns[1:],
                            b.num_rows))
    a = PM.run_distributed_groupby(pmesh, clean, [0], [1], ["sum"],
                                   window_rows=128)
    b = PM.run_distributed_groupby(pmesh, dirty, [0], [1], ["sum"],
                                   window_rows=128)
    assert sum(x.num_rows for x in a) == len(WORDS) + 1
    for x, y in zip(a, b):
        assert x.num_rows == y.num_rows
        for cx, cy in zip(x.columns, y.columns):
            for ax, ay in zip(cx.arrays(), cy.arrays()):
                assert torch.equal(ax, ay)


def test_streaming_overflow_raises_like_jax(meshes):
    """~1200 distinct strings a worker owns against an accumulator of
    8 x 128 groups (the shapes of the string-key streaming test)."""
    jmesh, pmesh = meshes
    rows, cap = 1200, 2048
    jbs, pbs = [], []
    for w in range(N):
        data = np.zeros((cap, 16), np.uint8)
        lens = np.zeros(cap, np.int32)
        for i in range(rows):
            b = f"w{w}-{i:05d}".encode()
            data[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        valid = np.arange(cap) < rows
        jb, pb = _pair((("s", "string"), ("v", "double")),
                       [[data, valid, lens],
                        [np.where(valid, 0.25, 0.0), valid]], rows)
        jbs.append(jb)
        pbs.append(pb)
    for M, mesh, batches in ((JM, jmesh, jbs), (PM, pmesh, pbs)):
        with pytest.raises(RuntimeError, match="accumulator overflow"):
            M.run_distributed_groupby(mesh, batches, [0], [1], ["sum"],
                                      window_rows=128)


# ---------------------------------------------------------------------------
# The mesh itself
# ---------------------------------------------------------------------------

def test_maybe_mesh_rules():
    cpu = torch.device("cpu")
    conf = cfg.TorchConf
    on = "spark.rapids.tpu.sql.mesh.enabled"
    workers = "spark.rapids.torch.mesh.workers"
    # auto: a CUDA session only
    assert PM.maybe_mesh(conf({workers: 8}), cpu) is None
    assert PM.maybe_mesh(conf({on: "false", workers: 8}), cpu) is None
    mesh = PM.maybe_mesh(conf({on: "true", workers: 4}), cpu)
    assert mesh.devices.size == mesh.size == 4
    assert mesh.collective.shared
    with pytest.raises(RuntimeError, match="at least 2"):
        PM.maybe_mesh(conf({on: "true"}), cpu)
    with pytest.raises(RuntimeError, match="at least 2"):
        PM.maybe_mesh(conf({on: "true", workers: 1}), cpu)
    with pytest.raises(ValueError):
        PM.maybe_mesh(conf({on: "maybe", workers: 4}), cpu)
    with pytest.raises(ValueError):
        conf({"spark.rapids.tpu.sql.mesh.streamWindowRows": 100}).get(
            cfg.MESH_STREAM_WINDOW_ROWS)
    with pytest.raises(ValueError):
        conf({"spark.rapids.tpu.sql.shuffle.plane": "rdma"}).get(
            cfg.SHUFFLE_PLANE)
