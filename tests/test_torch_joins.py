"""Parity of the PyTorch port's ops/joins.py with the JAX package's.

The same seeded key and payload columns go through the JAX join_match /
join_gather (CPU, x64) and the port's on the CPU, where the wrappers run
the plain PyTorch twins of K2 (sort_key_lanes), K5 (compact_scan), K6
(join_probe) and K7 (join_expand). Everything is compared bit for bit:
lo, count, the total, the matched (stream row, build row) pairs and every
gathered column array.

One case is held to a numpy oracle instead: a build side that fills its
capacity exactly, where the reference's binary search stops one step short
(spark_rapids_tpu/ops/joins.py:85) and misses matches.
"""

import zlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import joins as JJ

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.columnar.column import bucket
from spark_rapids_tpu_torch.ops import joins as PJ


def _pair(values, tname: str, cap: int, width=None):
    """(JAX column, port column) holding identical arrays."""
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=cap,
                             width=width)
    return jc, PColumn(pdt.of(tname), *[torch.from_numpy(np.array(a))
                                         for a in jc.arrays()])


def _ints(rng, n, hi, null_frac=0.0):
    return [None if rng.random() < null_frac else int(x)
            for x in rng.integers(0, hi, n)]


def _doubles(rng, n):
    v = rng.integers(-3, 4, n).astype(np.float64) / 2
    v[rng.random(n) < 0.15] = np.nan
    v[(v == 0) & (rng.random(n) < 0.5)] = -0.0
    return [float(x) for x in v]


def _words(rng, n, vocab):
    return [str(x) for x in np.array(vocab)[rng.integers(0, len(vocab), n)]]


# name -> (key spec per side, n_build, build cap, n_stream, stream cap);
# a key spec is [(type, values fn, width)], one entry per key column
def _case(name, rng):
    if name == "int64":
        nb, ns = 300, 200
        return ([("bigint", _ints(rng, nb, 120), None)], nb, 512,
                [("bigint", _ints(rng, ns, 150), None)], ns, 256)
    if name == "int_and_string_widths_8_16":
        nb, ns = 300, 200
        return ([("bigint", _ints(rng, nb, 6), None),
                 ("string", _words(rng, nb, ["MAIL", "SHIP", "AIR", ""]), 8)],
                nb, 512,
                [("bigint", _ints(rng, ns, 6), None),
                 ("string", _words(rng, ns, ["MAIL", "SHIP", "TRUCK",
                                             "REG AIR XL"]), 16)],
                ns, 256)
    if name == "nulls_both_sides":
        nb, ns = 300, 200
        return ([("bigint", _ints(rng, nb, 60, 0.2), None)], nb, 512,
                [("bigint", _ints(rng, ns, 60, 0.2), None)], ns, 256)
    if name == "f64_nan_and_signed_zero":
        nb, ns = 300, 200
        return ([("double", _doubles(rng, nb), None)], nb, 512,
                [("double", _doubles(rng, ns), None)], ns, 256)
    if name == "duplicates_both_sides":
        nb, ns = 400, 250
        return ([("int", _ints(rng, nb, 5), None)], nb, 512,
                [("int", _ints(rng, ns, 7), None)], ns, 256)
    if name == "empty_build":
        return ([("bigint", [], None)], 0, 512,
                [("bigint", _ints(rng, 100, 10), None)], 100, 256)
    if name == "empty_stream":
        return ([("bigint", _ints(rng, 100, 10), None)], 100, 512,
                [("bigint", [], None)], 0, 256)
    raise KeyError(name)


CASES = ("int64", "int_and_string_widths_8_16", "nulls_both_sides",
         "f64_nan_and_signed_zero", "duplicates_both_sides", "empty_build",
         "empty_stream")


def _columns(spec, cap):
    pairs = [_pair(vals, t, cap, w) for t, vals, w in spec]
    return [j for j, _ in pairs], [p for _, p in pairs]


def _payload(rng, n, cap):
    """A string, a double and an int payload column of n rows."""
    specs = [("string", _words(rng, n, ["a", "bb", "ccc", None]), 8),
             ("double", [None if rng.random() < 0.1 else float(x)
                         for x in rng.random(n)], None),
             ("bigint", _ints(rng, n, 1 << 40, 0.1), None)]
    return _columns(specs, cap)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    rng = np.random.default_rng(zlib.crc32(request.param.encode()))
    bspec, nb, bcap, sspec, ns, scap = _case(request.param, rng)
    jb, pb = _columns(bspec, bcap)
    js, ps = _columns(sspec, scap)
    jbp, pbp = _payload(rng, nb, bcap)
    jsp, psp = _payload(rng, ns, scap)
    jm = JJ.join_match(jb, nb, js, ns, scap)
    pm = PJ.join_match(pb, nb, ps, ns, scap)
    return dict(nb=nb, ns=ns, scap=scap, jm=jm, pm=pm,
                j_stream=js + jsp, p_stream=ps + psp,
                j_build=jb + jbp, p_build=pb + pbp)


def _assert_columns_equal(jcols, pcols):
    assert len(jcols) == len(pcols)
    for jc, pc in zip(jcols, pcols):
        for a, b in zip(jc.arrays(), pc.arrays()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_join_match_matches_jax(case):
    jm, pm = case["jm"], case["pm"]
    np.testing.assert_array_equal(pm.lo.numpy(), np.asarray(jm.lo))
    np.testing.assert_array_equal(pm.count.numpy(), np.asarray(jm.count))
    np.testing.assert_array_equal(pm.build_order.numpy(),
                                  np.asarray(jm.build_order))
    assert int(pm.total_pairs) == int(jm.total_pairs)


def test_matched_pairs_match_jax(case):
    jm, pm = case["jm"], case["pm"]
    out_cap = bucket(max(int(jm.total_pairs), 1))
    j_sidx, j_sorted, j_live = JJ._expand_indices(jm, out_cap)
    j_bidx = np.asarray(jm.build_order)[np.clip(
        np.asarray(j_sorted), 0, jm.build_order.shape[0] - 1)]
    p_sidx, p_bidx, p_live = PJ._expand_indices(pm, out_cap)
    live = np.asarray(j_live)
    np.testing.assert_array_equal(p_live.numpy(), live)
    np.testing.assert_array_equal(p_sidx.numpy()[live],
                                  np.asarray(j_sidx)[live])
    np.testing.assert_array_equal(p_bidx.numpy()[live], j_bidx[live])


@pytest.mark.parametrize("how", ["inner", "left_semi", "left_anti"])
def test_join_gather_matches_jax(case, how):
    jm, pm = case["jm"], case["pm"]
    out_cap = bucket(max(int(jm.total_pairs), 1))
    j_s, j_b, j_cnt = JJ.join_gather(jm, case["j_stream"], case["j_build"],
                                     out_cap, how, n_stream=case["ns"])
    p_s, p_b, p_cnt = PJ.join_gather(pm, case["p_stream"], case["p_build"],
                                     out_cap, how, n_stream=case["ns"])
    assert int(p_cnt) == int(j_cnt)
    _assert_columns_equal(j_s, p_s)
    _assert_columns_equal(j_b, p_b)


def test_join_gather_refuses_unported_join_types(case):
    """join_gather takes inner, left, left_semi and left_anti; right and
    full outer joins are composed by the execs (a swapped left join; a
    left join plus unmatched_build_gather), so the function refuses
    them."""
    for how in ("right", "full"):
        with pytest.raises(NotImplementedError, match="join_gather takes"):
            PJ.join_gather(case["pm"], case["p_stream"], case["p_build"],
                           128, how, n_stream=case["ns"])


def test_build_filling_its_capacity_matches_a_numpy_oracle():
    """n_build == capacity: every equal pair is found (the reference's
    search runs bit_length(cap - 1) steps, one short of a full range)."""
    rng = np.random.default_rng(3)
    cap = 128
    build = rng.integers(0, 40, cap)
    stream = np.concatenate([np.arange(40), rng.integers(0, 60, 60)])
    _, pb = _pair([int(x) for x in build], "bigint", cap)
    _, ps = _pair([int(x) for x in stream], "bigint", cap)
    m = PJ.join_match([pb], cap, [ps], len(stream), cap)
    want = (stream[:, None] == build[None, :]).sum(axis=1)
    np.testing.assert_array_equal(m.count.numpy()[:len(stream)], want)
    assert int(m.total_pairs) == int(want.sum())
    srt = np.sort(build, kind="stable")
    np.testing.assert_array_equal(m.lo.numpy()[:len(stream)],
                                  np.searchsorted(srt, stream, "left"))
    sidx, bidx, live = PJ._expand_indices(m, bucket(int(want.sum())))
    n = int(want.sum())
    assert bool(live[:n].all()) and not bool(live[n:].any())
    np.testing.assert_array_equal(
        build[bidx[:n].numpy()], stream[sidx[:n].numpy()])


def test_probe_and_expand_twins_take_cpu_tensors_only():
    """On a tensor that is neither on the CPU nor on a CUDA device the
    wrappers raise instead of running their twins."""
    lanes = torch.zeros((1, 128), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        PJ.join_probe(lanes, 0, lanes, [], 0)
    m = PJ.JoinMatch(torch.zeros(128, dtype=torch.int32, device="meta"),
                     torch.zeros(128, dtype=torch.int32, device="meta"),
                     torch.zeros(128, dtype=torch.int64, device="meta"),
                     torch.zeros((), dtype=torch.int64, device="meta"), None)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PJ._expand_indices(m, 128)
