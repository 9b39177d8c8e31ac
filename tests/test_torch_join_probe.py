"""K6 (join probe) and K15 (cross-join expansion) twins against the JAX
package, at the cases the kernels' Hopper designs branch on.

On the CPU the port's ``join_probe`` and ``cross_expand`` run their plain
PyTorch twins; the kernels themselves are held to these twins on the card
by chip_smoke.py (``--only check_k6,check_k15``). The same seeded numpy
lanes go through the reference's ``_search_bounds`` (CPU, x64) and the
port; every output is compared exactly:

- K6 over raw sorted lanes at 1, 2, 3 and 16 lanes (the kernel's
  specialisations and its most lanes), a hot key over more than 2^12
  build rows (its gallop past the sample stride), unique build keys,
  probes below and above every build key, NULL keys on both sides, a
  build that fills its capacity (held to a numpy oracle: the reference's
  fixed step count stops one step short there), host-int and 0-d tensor
  counts; the lower-bound mode against the full mode and against the
  reference's range partition ids;
- K15 against the reference's ``cross_join_gather``, and the divisor it
  takes (``_fast_divisor``) against ``//`` for every 32-bit numerator
  class.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import joins as JJ

from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import joins as PJ


def _sorted_lanes(vals: np.ndarray, cap: int) -> np.ndarray:
    """int64[nl, cap]: the columns of ``vals`` (nl x n) sorted
    lexicographically, lane 0 most significant; padding rows zero."""
    n = vals.shape[1]
    order = np.lexsort(vals[::-1]) if n else np.zeros(0, np.int64)
    out = np.zeros((vals.shape[0], cap), np.int64)
    out[:, :n] = vals[:, order]
    return out


def _case(name: str, rng):
    """(build lanes, n_build, probe lanes, probe validities, n_probe)."""
    pcap = 256
    if name.startswith("lanes_"):
        nl = int(name.split("_")[1])
        nb, bcap = 300, 512
        hi = 400 if nl == 1 else 4
        build = _sorted_lanes(rng.integers(0, hi, (nl, nb)), bcap)
        probe = rng.integers(-1, hi + 1, (nl, pcap))
        valid = [rng.random(pcap) > 0.15 for _ in range(min(nl, 8))]
        return build, nb, probe, valid, 200
    if name == "hot_key_over_2^12_rows":
        nb, bcap = 8000, 8192
        vals = np.concatenate([rng.integers(0, 3000, nb - 5000),
                               np.full(5000, 1500)])
        probe = rng.integers(-2, 3002, (2, pcap))
        probe[0] = 3                        # a tag lane, as K2 writes one
        probe[1, ::3] = 1500
        return (_sorted_lanes(np.stack([np.full(nb, 3), vals]), bcap), nb,
                probe, [], 230)
    if name == "unique_build_keys":
        nb, bcap = 1000, 1024
        vals = rng.permutation(4000)[:nb]
        return (_sorted_lanes(vals[None], bcap), nb,
                rng.integers(0, 4000, (1, pcap)), [], pcap)
    if name == "probes_past_either_end":
        nb, bcap = 400, 512
        build = _sorted_lanes(rng.integers(100, 200, (2, nb)), bcap)
        probe = np.where(rng.random((2, pcap)) < 0.5, -10**15, 10**15)
        probe[:, ::5] = rng.integers(100, 200, (2, len(probe[0, ::5])))
        return build, nb, probe, [], pcap
    if name == "nulls_both_sides":
        # a NULL build key is a row of its own lane value (K2 ranks NULL
        # apart); a NULL probe key never matches
        nb, bcap = 300, 512
        vals = rng.integers(0, 50, (2, nb))
        vals[0] = np.where(rng.random(nb) < 0.2, 0, 1)
        probe = rng.integers(0, 50, (2, pcap))
        probe[0] = 1
        return (_sorted_lanes(vals, bcap), nb, probe,
                [rng.random(pcap) > 0.2], 240)
    raise KeyError(name)


# 2 lanes: the hot key, the ends and the NULL cases
CASES = ("lanes_1", "lanes_3", "lanes_16", "hot_key_over_2^12_rows",
         "unique_build_keys", "probes_past_either_end", "nulls_both_sides")


def _reference(build, nb, probe, valid, n_probe):
    """The JAX package's join_match arithmetic over the same lanes."""
    bw = [jnp.asarray(x) for x in build]
    pw = [jnp.asarray(x) for x in probe]
    lo = np.asarray(JJ._search_bounds(bw, nb, pw, "left"))
    hi = np.asarray(JJ._search_bounds(bw, nb, pw, "right"))
    ok = np.arange(probe.shape[1]) < n_probe
    for v in valid:
        ok = ok & v
    return lo, np.where(ok, hi - lo, 0).astype(np.int32)


def _port(build, nb, probe, valid, n_probe, lower_only=False):
    return PJ.join_probe(torch.from_numpy(build), nb,
                         torch.from_numpy(probe),
                         [torch.from_numpy(v) for v in valid], n_probe,
                         lower_only=lower_only)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    rng = np.random.default_rng(zlib.crc32(request.param.encode()))
    return _case(request.param, rng)


def test_probe_matches_jax(case):
    build, nb, probe, valid, n_probe = case
    lo, count, totals = _port(build, nb, probe, valid, n_probe)
    want_lo, want_count = _reference(build, nb, probe, valid, n_probe)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(count.numpy(), want_count)
    live = np.arange(probe.shape[1]) < n_probe
    assert totals.tolist() == [int(want_count.sum()),
                               int((live & (want_count == 0)).sum())]


def test_lower_only_lo_is_the_full_modes(case):
    build, nb, probe, valid, n_probe = case
    lower = _port(build, nb, probe, valid, n_probe, lower_only=True)
    assert lower[1] is None and lower[2] is None
    torch.testing.assert_close(
        lower[0], _port(build, nb, probe, valid, n_probe)[0], rtol=0,
        atol=0)


def test_host_int_and_tensor_counts_agree(case):
    build, nb, probe, valid, n_probe = case
    by_int = _port(build, nb, probe, valid, n_probe)
    by_tensor = _port(build, torch.tensor(nb), probe, valid,
                      torch.tensor(n_probe))
    for a, b in zip(by_int, by_tensor):
        assert torch.equal(a, b)


def test_build_filling_its_capacity_matches_numpy():
    """n_build == capacity: a range of 2^k rows takes k + 1 halvings; the
    reference takes k (joins.py:85-86), so a numpy oracle decides."""
    rng = np.random.default_rng(11)
    cap = 1024
    build = _sorted_lanes(rng.integers(0, 300, (1, cap)), cap)
    probe = rng.integers(-1, 302, (1, 256))
    probe[0, :8] = build[0, -1]              # the last build row's key
    lo, count, _ = _port(build, cap, probe, [], 256)
    np.testing.assert_array_equal(
        lo.numpy(), np.searchsorted(build[0], probe[0], side="left"))
    np.testing.assert_array_equal(
        count.numpy(), np.searchsorted(build[0], probe[0], side="right") -
        np.searchsorted(build[0], probe[0], side="left"))


def test_lower_only_gives_the_references_range_ids():
    """The reference's range partition id (partitioning.py:256-273): the
    number of bound rows strictly below the row, by _lex_cmp against each
    bound; the port's is K6's lower-bound mode over the sorted bounds."""
    rng = np.random.default_rng(12)
    nl, n_bounds = 2, 7                      # 8 partitions
    bounds = _sorted_lanes(rng.integers(0, 5, (nl, n_bounds)), 16)
    rows = rng.integers(-1, 6, (nl, 512))
    pid = jnp.zeros(512, dtype=jnp.int32)
    row_words = [jnp.asarray(x) for x in rows]
    for bi in range(n_bounds):
        bw = [jnp.broadcast_to(jnp.asarray(w[bi]), (512,)) for w in bounds]
        blt, _ = JJ._lex_cmp(bw, row_words)
        pid = pid + blt.astype(jnp.int32)
    lo, _, _ = _port(bounds, n_bounds, rows, [], 512, lower_only=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(pid))


def _int_column(values, cap):
    jc = JColumn.from_pylist(values, jdt.of("bigint"), capacity=cap)
    return jc, PColumn(pdt.of("bigint"), *[torch.from_numpy(np.array(a))
                                           for a in jc.arrays()])


@pytest.mark.parametrize("n_left,n_right", [(0, 5), (5, 0), (1, 1), (7, 13),
                                            (13, 7), (3, 64)])
def test_cross_expand_matches_jax(n_left, n_right):
    rng = np.random.default_rng(n_left * 100 + n_right)
    jl, pl = _int_column([int(x) for x in rng.integers(0, 99, n_left)], 16)
    jr, pr = _int_column([int(x) for x in rng.integers(0, 99, n_right)], 64)
    cap = 256
    jlo, jro, jtotal = JJ.cross_join_gather([jl], n_left, [jr], n_right, cap)
    plo, pro, ptotal = PJ.cross_join_gather([pl], n_left, [pr], n_right, cap)
    assert int(ptotal) == int(jtotal) == n_left * n_right
    for jc, pc in ((jlo[0], plo[0]), (jro[0], pro[0])):
        for a, b in zip(jc.arrays(), pc.arrays()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _divide(n: np.ndarray, d: int) -> np.ndarray:
    """K15's division of uint64-held 32-bit numerators by ``d``."""
    magic, shift, add = PJ._fast_divisor(d)
    if d == 1:
        return n
    h = (n * np.uint64(magic)) >> np.uint64(32)
    if add:
        h = h + ((n - h) >> np.uint64(1))
    return h >> np.uint64(shift)


def test_fast_divisor_matches_floor_division():
    """Every divisor in 1..4096, 2^k - 1, 2^k + 1 and 2^31 - 1, 2^32 - 1,
    over numerators up to 2^32 - 1: the ends, each side of the largest
    multiple of the divisor, and 48 random ones."""
    rng = np.random.default_rng(13)
    top = (1 << 32) - 1
    divisors = set(range(1, 4097)) | {(1 << 31) - 1, top}
    for k in range(2, 32):
        divisors |= {(1 << k) - 1, (1 << k) + 1}
    for d in sorted(divisors):
        m = top // d * d
        n = np.array([0, 1, d - 1, d, d + 1, m - 1, m, min(m + 1, top),
                      (1 << 31) - 1, 1 << 31, top - 1, top] +
                     list(rng.integers(0, top, 48, endpoint=True)),
                     dtype=np.uint64)
        n = np.minimum(n, np.uint64(top))
        np.testing.assert_array_equal(_divide(n, d), n // np.uint64(d),
                                      err_msg=f"divisor {d}")
    with pytest.raises(ValueError):
        PJ._fast_divisor(0)
    with pytest.raises(ValueError):
        PJ._fast_divisor(1 << 32)


@pytest.mark.parametrize("capacity", [0, 1, 129])
def test_cross_expand_refuses_an_odd_capacity(capacity):
    """The kernel writes slots in pairs: the wrapper takes even capacities
    only (the engine's are powers of two), on any device."""
    with pytest.raises(ValueError, match="even"):
        PJ.cross_expand(2, 3, capacity, "cpu")
