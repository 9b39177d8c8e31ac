"""Outer and cross joins of the PyTorch port against the JAX package.

The kernels' level: the port's ``join_gather(..., "left")`` (K7's outer
mode), ``unmatched_build_gather`` (K14 + K5) and ``cross_join_gather``
(K15) against the JAX functions on the same seeded columns, on the CPU
where the wrappers run their plain twins: every output array bit for bit.

The engine's level: left, right, full, cross and inner non-equi joins
through both sessions on small tables with NULL keys, duplicate keys and
keys missing from either side, empty sides, and a full outer join whose
stream side hashes into one partition of eight (so the others join an
empty stream batch). The port runs each in the broadcast form and in the
shuffled form (threshold -1); its rows equal the JAX engine's (compared as
sorted row lists), and its plan's operator tree equals the JAX engine's
plan of the same query in the same form (whole-stage fusion off in both
engines for that comparison).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import joins as JJ

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.columnar.column import bucket
from spark_rapids_tpu_torch.ops import joins as PJ


# ---------------------------------------------------------------------------
# The kernels' level
# ---------------------------------------------------------------------------

def _pair(values, tname: str, cap: int, width=None):
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=cap,
                             width=width)
    return jc, PColumn(pdt.of(tname), *[torch.from_numpy(np.array(a))
                                         for a in jc.arrays()])


def _ints(rng, n, hi, null_frac=0.0):
    return [None if rng.random() < null_frac else int(x)
            for x in rng.integers(0, hi, n)]


# name -> (build key values, build capacity, stream key values, stream
# capacity)
KEY_CASES = {
    "nulls_dups_and_misses": lambda rng: (
        _ints(rng, 300, 60, 0.15), 512, _ints(rng, 200, 90, 0.15), 256),
    "empty_build": lambda rng: ([], 128, _ints(rng, 100, 10, 0.1), 128),
    "empty_stream": lambda rng: (_ints(rng, 100, 10, 0.1), 128, [], 128),
}


def _payload(rng, n, cap):
    specs = [("string", [None if rng.random() < 0.1 else str(x) for x in
                         np.array(["a", "bb", "ccc"])[
                             rng.integers(0, 3, n)]], 8),
             ("double", [None if rng.random() < 0.1 else float(x)
                         for x in rng.random(n)], None)]
    pairs = [_pair(v, t, cap, w) for t, v, w in specs]
    return [j for j, _ in pairs], [p for _, p in pairs]


@pytest.fixture(scope="module", params=sorted(KEY_CASES))
def kcase(request):
    rng = np.random.default_rng(zlib.crc32(request.param.encode()))
    bvals, bcap, svals, scap = KEY_CASES[request.param](rng)
    nb, ns = len(bvals), len(svals)
    jbk, pbk = _pair(bvals, "bigint", bcap)
    jsk, psk = _pair(svals, "bigint", scap)
    jbp, pbp = _payload(rng, nb, bcap)
    jsp, psp = _payload(rng, ns, scap)
    jm = JJ.join_match([jbk], nb, [jsk], ns, scap)
    pm = PJ.join_match([pbk], nb, [psk], ns, scap, with_build_matched=True)
    return dict(nb=nb, ns=ns, jm=jm, pm=pm, j_stream=[jsk] + jsp,
                p_stream=[psk] + psp, j_build=[jbk] + jbp,
                p_build=[pbk] + pbp)


def _assert_columns_equal(jcols, pcols):
    assert len(jcols) == len(pcols)
    for jc, pc in zip(jcols, pcols):
        for a, b in zip(jc.arrays(), pc.arrays()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_left_join_gather_matches_jax(kcase):
    jm, pm, ns = kcase["jm"], kcase["pm"], kcase["ns"]
    live = np.arange(jm.count.shape[0]) < ns
    rows = int(np.where(live, np.maximum(np.asarray(jm.count), 1), 0).sum())
    assert sum(pm.totals.tolist()) == rows
    out_cap = bucket(max(rows, 1))
    j_s, j_b, j_cnt = JJ.join_gather(jm, kcase["j_stream"], kcase["j_build"],
                                     out_cap, "left", n_stream=ns)
    p_s, p_b, p_cnt = PJ.join_gather(pm, kcase["p_stream"], kcase["p_build"],
                                     out_cap, "left", n_stream=ns)
    assert int(p_cnt) == int(j_cnt) == rows
    _assert_columns_equal(j_s, p_s)
    _assert_columns_equal(j_b, p_b)


def test_outer_expansion_matches_jax(kcase):
    """K7's outer mode slot by slot: the reference's left branch expands
    max(count, 1) slots per live stream row and none per dead row; a slot
    of a row with no match has no build row (-1 here)."""
    jm, pm, ns = kcase["jm"], kcase["pm"], kcase["ns"]
    cap = jm.count.shape[0]
    count = np.asarray(jm.count)
    slots = np.where(np.arange(cap) < ns, np.maximum(count, 1), 0)
    rows = int(slots.sum())
    out_cap = bucket(max(rows, 1))
    jm2 = jm._replace(count=jnp.asarray(slots, jnp.int32),
                      total_pairs=jnp.asarray(rows, jnp.int32))
    j_sidx, j_sorted, j_live = JJ._expand_indices(jm2, out_cap)
    p_sidx, p_bidx, p_live = PJ._expand_indices(pm, out_cap, outer=True,
                                                n_stream=ns)
    live = np.asarray(j_live)
    np.testing.assert_array_equal(p_live.numpy(), live)
    sidx = np.asarray(j_sidx)[live]
    np.testing.assert_array_equal(p_sidx.numpy()[live], sidx)
    order = np.asarray(jm.build_order)
    want_b = np.where(count[sidx] > 0, order[np.clip(
        np.asarray(j_sorted)[live], 0, len(order) - 1)], -1)
    np.testing.assert_array_equal(p_bidx.numpy()[live], want_b)


def test_build_matched_and_unmatched_build_gather_match_jax(kcase):
    jm, pm, nb = kcase["jm"], kcase["pm"], kcase["nb"]
    np.testing.assert_array_equal(pm.build_matched.numpy(),
                                  np.asarray(jm.build_matched))
    j_out, j_cnt = JJ.unmatched_build_gather(jm, kcase["j_build"], nb)
    p_out, p_cnt = PJ.unmatched_build_gather(pm, kcase["p_build"], nb)
    assert int(p_cnt) == int(j_cnt)
    _assert_columns_equal(j_out, p_out)


@pytest.mark.parametrize("n_left,n_right", [(7, 5), (0, 5), (7, 0),
                                            (130, 1), (1, 130)])
def test_cross_join_gather_matches_jax(n_left, n_right):
    rng = np.random.default_rng(n_left * 1000 + n_right)
    jl, pl = _payload(rng, n_left, bucket(n_left))
    jr, pr = _payload(rng, n_right, bucket(n_right))
    out_cap = bucket(max(n_left * n_right, 1))
    j_l, j_r, j_cnt = JJ.cross_join_gather(jl, n_left, jr, n_right, out_cap)
    p_l, p_r, p_cnt = PJ.cross_join_gather(pl, n_left, pr, n_right, out_cap)
    assert int(p_cnt) == int(j_cnt) == n_left * n_right
    assert p_cnt.dtype == torch.int64
    _assert_columns_equal(j_l, p_l)
    _assert_columns_equal(j_r, p_r)


def test_outer_wrappers_refuse_other_devices():
    meta = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        PJ.build_matched(meta, meta, 0, 128)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PJ.cross_expand(1, 1, 128, "meta")
    m = PJ.JoinMatch(meta, meta,
                     torch.zeros(128, dtype=torch.int64, device="meta"),
                     torch.zeros((), dtype=torch.int64, device="meta"), None)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PJ._expand_indices(m, 128, outer=True, n_stream=1)
    before = native.counts()
    PJ.cross_expand(2, 3, 128, "cpu")
    assert native.counts() == before      # the twin launches nothing


# ---------------------------------------------------------------------------
# The engine's level
# ---------------------------------------------------------------------------

def _tables():
    """L(lk, la, ls) and R(rk, rb, rs): int64 keys with NULLs and
    duplicates, some keys on one side only; a one-key L1 whose rows all
    hash into one partition; empty copies of L and R."""
    rng = np.random.default_rng(13)
    nl, nr = 90, 70

    def keys(n, hi):
        k = rng.integers(0, hi, n)
        return pa.array(k, mask=rng.random(n) < 0.15)

    def words(n):
        w = np.array(["MAIL", "SHIP", "AIR", "REG AIR"])[
            rng.integers(0, 4, n)]
        return pa.array(list(w), mask=rng.random(n) < 0.1)

    L = pa.table({"lk": keys(nl, 30), "la": rng.integers(0, 1000, nl) / 8,
                  "ls": words(nl)})
    R = pa.table({"rk": keys(nr, 40) , "rb": rng.integers(-50, 50, nr),
                  "rs": words(nr)})
    L1 = pa.table({"lk": pa.array(np.full(20, 7)),
                   "la": rng.integers(0, 1000, 20) / 8, "ls": words(20)})
    return {"L": L, "R": R, "L1": L1, "L0": L.slice(0, 0),
            "R0": R.slice(0, 0)}


def _on(F_):
    return F_.col("lk") == F_.col("rk")


# name -> (left table, right table, how); "cross" joins without a
# condition, "non_equi" inner-joins on la < rb only
JOINS = {
    "left": ("L", "R", "left"), "right": ("L", "R", "right"),
    "full": ("L", "R", "full"), "inner": ("L", "R", "inner"),
    "cross": ("L", "R", "cross"), "non_equi": ("L", "R", "non_equi"),
    "cross_join_condition": ("L", "R", "cross_cond"),
    "left_empty_build": ("L", "R0", "left"),
    "full_empty_build": ("L", "R0", "full"),
    "full_empty_stream": ("L0", "R", "full"),
    "right_empty_stream": ("L0", "R", "right"),
    "cross_empty_right": ("L", "R0", "cross"),
    "full_one_stream_partition": ("L1", "R", "full"),
}


def _query(F_, t, name):
    lname, rname, how = JOINS[name]
    l, r = t[lname], t[rname]
    if how == "cross":
        return l.crossJoin(r)
    if how == "non_equi":
        return l.join(r, on=F_.col("la") < F_.col("rb"))
    if how == "cross_cond":
        return l.join(r, on=F_.col("ls") == F_.col("rs"), how="cross")
    return l.join(r, on=_on(F_), how=how)


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple(
        (True, 0) if v is None else (False, v) for v in r))


def _jax_session(**conf):
    return JaxSession.builder.config({
        "spark.rapids.tpu.sql.explain": "NONE",
        "spark.rapids.tpu.sql.adaptive.enabled": "false", **conf}
    ).getOrCreate()


NO_BROADCAST = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
                "spark.rapids.tpu.sql.shuffle.partitions": 8}
FORMS = {"broadcast": {}, "shuffled": NO_BROADCAST}


@pytest.fixture(scope="module")
def tables():
    return _tables()


# whole-stage fusion off in both engines for the plan comparison
NO_FUSION = {"spark.rapids.tpu.sql.fusion.wholeStage": "false",
             "spark.rapids.tpu.sql.wholeStageFusion.enabled": "false"}


@pytest.fixture(scope="module")
def jax_rows(tables):
    """Every join of JOINS once on the JAX engine (its rows do not depend
    on the plan's form)."""
    js = _jax_session()
    t = {k: js.createDataFrame(v) for k, v in tables.items()}
    return {name: _sorted(_query(JF, t, name).collect()) for name in JOINS}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", list(JOINS))
def test_join_matches_jax_engine(tables, jax_rows, name, form):
    from spark_rapids_tpu.plan.overrides import Overrides
    conf = {**FORMS[form], **NO_FUSION}
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **conf}).getOrCreate()
    t = {k: session.createDataFrame(v) for k, v in tables.items()}
    df = _query(F, t, name)
    got = df.collect()
    assert _sorted(got) == jax_rows[name]
    js = _jax_session(**conf)
    jt = {k: js.createDataFrame(v) for k, v in tables.items()}
    jdf = _query(JF, jt, name)
    tree = session.last_plan().operator_tree()
    assert tree == str(Overrides(js.conf).apply(jdf._analyzed()))
    assert [(f.name, str(f.dtype), f.nullable) for f in df.schema] == \
        [(f.name, str(f.dtype), f.nullable) for f in jdf.schema]
    how = JOINS[name][2]
    if how in ("cross", "non_equi", "cross_cond"):
        assert "TpuCrossJoinExec" in tree
    elif form == "shuffled":
        assert "TpuShuffledJoinExec" in tree and "Broadcast" not in tree
    if how == "right":
        assert tree.startswith("_ReorderExec")


def test_full_outer_joins_every_build_partition_and_counts_match():
    """The full outer join of one-key stream rows against many build keys
    on the shuffled plan: seven of the eight stream partitions are empty,
    and every build row of theirs still comes out, once."""
    t = _tables()
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": "cpu", **NO_BROADCAST}).getOrCreate()
    L1, R = (session.createDataFrame(t[k]) for k in ("L1", "R"))
    rows = L1.join(R, on=_on(F), how="full").collect()
    rk = t["R"].column("rk").to_pylist()
    hits = sum(k == 7 for k in rk)
    assert len(rows) == 20 * hits + (len(rk) - hits) + (0 if hits else 20)
    assert sorted((r[3] for r in rows if r[0] is None),
                  key=lambda v: (v is None, v or 0)) == \
        sorted((k for k in rk if k != 7), key=lambda v: (v is None, v or 0))
