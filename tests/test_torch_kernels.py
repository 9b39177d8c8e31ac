"""Parity of the PyTorch port's ops/kernels.py with the JAX package's.

Each case feeds the same seeded numpy columns to the JAX function (CPU, x64)
and to the port on the CPU, where the wrappers run their plain PyTorch
twins of K2 (sort_key_lanes) and K3 (segment_bounds). Permutations, group
starts, ids, counts and heads must match bit for bit.
"""

import zlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import kernels as JK

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import kernels as PK

CAP = 512
N = 450


def _values(rng, tname: str, n: int, width: int = 8):
    if tname == "string":
        alphabet = np.array(list("ABCN\x00ab"))
        lens = rng.integers(0, width + 1, n)
        return [None if rng.random() < 0.1 else
                "".join(alphabet[rng.integers(0, len(alphabet), k)])
                for k in lens]
    if tname in ("double", "float"):
        v = rng.integers(-6, 6, n).astype(np.float64) / 2
        v[rng.random(n) < 0.15] = np.nan
        v[rng.random(n) < 0.15] = -0.0
        return [None if rng.random() < 0.1 else float(x) for x in v]
    if tname == "boolean":
        return [None if rng.random() < 0.1 else bool(x)
                for x in rng.integers(0, 2, n)]
    lo, hi = (-(1 << 62), 1 << 62) if tname == "bigint" else (-50, 50)
    vals = rng.integers(lo, hi, n)
    vals[rng.random(n) < 0.3] = 7                    # plenty of ties
    return [None if rng.random() < 0.1 else int(x) for x in vals]


def _pair(values, tname: str, width=None, cap=CAP):
    """(JAX column, port column) holding identical arrays."""
    jc = JColumn.from_pylist(values, jdt.of(tname), capacity=cap,
                             width=width)
    arrays = [torch.from_numpy(np.array(a)) for a in jc.arrays()]
    return jc, PColumn(pdt.of(tname), *arrays)


def _keys(rng, spec, n=N):
    jkeys, pkeys = [], []
    for tname, asc, nf, width in spec:
        jc, pc = _pair(_values(rng, tname, n, width or 8), tname, width)
        jkeys.append(JK.SortKey(jc, asc, nf))
        pkeys.append(PK.SortKey(pc, asc, nf))
    return jkeys, pkeys


SORT_CASES = {
    "int64_asc": [("bigint", True, True, None)],
    "int64_desc_nulls_last": [("bigint", False, False, None)],
    "int32_desc_nulls_first": [("int", False, True, None)],
    "date_asc_nulls_last": [("date", True, False, None)],
    "f64_nan_zero_asc": [("double", True, True, None)],
    "f64_nan_zero_desc": [("double", False, False, None)],
    "f32_nan_desc": [("float", False, True, None)],
    "bool_desc": [("boolean", False, True, None)],
    "string_w8_asc": [("string", True, True, 8)],
    "string_w8_desc": [("string", False, False, 8)],
    "string_w2_short_form": [("string", True, True, 2)],
    "string_w3_desc_short_form": [("string", False, True, 3)],
    "string_w16": [("string", True, False, 16)],
    "two_strings_q1_shape": [("string", True, True, 8),
                             ("string", True, True, 8)],
    "mixed_four_keys": [("int", True, True, None),
                        ("double", False, True, None),
                        ("string", True, False, 8),
                        ("bigint", False, False, None)],
}


@pytest.mark.parametrize("live", ["prefix", "mask"])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_indices_matches_jax(case, live):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    jkeys, pkeys = _keys(rng, SORT_CASES[case])
    jmask = pmask = None
    if live == "mask":
        m = (rng.random(CAP) < 0.6) & (np.arange(CAP) < N)
        jmask, pmask = m, torch.from_numpy(m)
    want = np.asarray(JK.sort_indices(jkeys, N, CAP, live_mask=jmask))
    got = PK.sort_indices(pkeys, N, CAP, live_mask=pmask).numpy()
    np.testing.assert_array_equal(got, want)


def test_lane_count_and_widths():
    rng = np.random.default_rng(1)
    _, pkeys = _keys(rng, SORT_CASES["two_strings_q1_shape"])
    # pad + 2 * (null + 64 byte bits + 4 length bits) = 139 bits
    assert PK.lane_count(pkeys) == 3
    lanes = PK.sort_key_lanes(pkeys, N, CAP)
    assert lanes.shape == (3, CAP) and lanes.dtype == torch.int64
    assert bool((lanes >= 0).all())           # 63-bit lanes: sign bit clear


def test_torch_sort_puts_nan_last_on_f64():
    x = torch.tensor([3.0, float("nan"), -1.0, float("nan"), 2.0],
                     dtype=torch.float64)
    vals, idx = torch.sort(x, stable=True)
    assert idx.tolist() == [2, 4, 0, 1, 3]
    assert torch.isnan(vals[3:]).all()


def _sorted_pair(rng, spec, n_live):
    jkeys, pkeys = _keys(rng, spec)
    order = np.array(JK.sort_indices(jkeys, n_live, CAP))
    jsorted = [JK.gather_column(k.column, order) for k in jkeys]
    psorted = [PK.gather_column(k.column, torch.from_numpy(order))
               for k in pkeys]
    return jsorted, psorted


SEGMENT_CASES = {
    "int64": [("bigint", True, True, None)],
    "f64_nan_null": [("double", True, True, None)],
    "string_w8": [("string", True, True, 8)],
    "two_keys": [("boolean", True, True, None), ("int", True, True, None)],
}


@pytest.mark.parametrize("n_live", [N, 0, 1])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_bounds_match_jax(case, n_live):
    rng = np.random.default_rng(zlib.crc32(case.encode()) + n_live)
    jsorted, psorted = _sorted_pair(rng, SEGMENT_CASES[case], n_live)
    jstarts = np.asarray(JK.segment_starts_from_sorted_keys(jsorted, n_live,
                                                            CAP))
    jids = np.asarray(JK.segment_ids(jstarts))
    jperm, jcount = JK.compaction_indices(jstarts)
    starts, ids, n_groups, first_row = PK.segment_bounds(psorted, n_live, CAP)
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert int(n_groups) == int(jcount) == int(jstarts.sum())
    np.testing.assert_array_equal(first_row.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(
        PK.segment_starts_from_sorted_keys(psorted, n_live, CAP).numpy(),
        jstarts)
    np.testing.assert_array_equal(PK.segment_ids(starts).numpy(), jids)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_compaction_indices_match_jax(frac):
    rng = np.random.default_rng(int(frac * 10))
    keep = (rng.random(CAP) < frac) & (np.arange(CAP) < N)
    jperm, jcount = JK.compaction_indices(keep)
    perm, count = PK.compaction_indices(torch.from_numpy(keep))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(count) == int(jcount)


def _keep_mask(kind: str, rng) -> np.ndarray:
    idx = np.arange(CAP)
    if kind == "none":
        return np.zeros(CAP, np.bool_)
    if kind == "all":
        return idx < N
    if kind == "alternating":
        return (idx % 2 == 1) & (idx < N)
    return (rng.random(CAP) < 0.5) & (idx < N)


@pytest.mark.parametrize("kind", ["none", "all", "alternating", "random"])
def test_compaction_and_compact_columns_match_jax_at_masks(kind):
    """K5's twin: the permutation, the count and every compacted column."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    keep = _keep_mask(kind, rng)
    jperm, jcount = JK.compaction_indices(keep)
    perm, count = PK.compaction_indices(torch.from_numpy(keep))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(count) == int(jcount) == int(keep.sum())
    jcols, pcols = zip(*[_pair(_values(rng, t, N), t, w)
                         for t, w in (("string", 8), ("double", None),
                                      ("bigint", None))])
    jout, jn = JK.compact_columns(list(jcols), keep)
    pout, pn = PK.compact_columns(list(pcols), torch.from_numpy(keep))
    assert int(pn) == int(jn)
    for jc, pc in zip(jout, pout):
        for a, b in zip(jc.arrays(), pc.arrays()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gather_slice_concat_match_jax():
    rng = np.random.default_rng(5)
    jc, pc = _pair(_values(rng, "string", N), "string", 8)
    idx = rng.integers(0, CAP, CAP)
    valid = rng.random(CAP) < 0.5
    jg = JK.gather_column(jc, idx, out_valid=valid)
    pg = PK.gather_column(pc, torch.from_numpy(idx),
                          out_valid=torch.from_numpy(valid))
    for a, b in zip(jg.arrays(), pg.arrays()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    js = JK.slice_column(jc, 10, 128, 100)
    ps = PK.slice_column(pc, 10, 128, 100)
    for a, b in zip(js.arrays(), ps.arrays()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jn, pn = _pair(_values(rng, "bigint", N), "bigint")
    jcat = JK.concat_columns([jn, jn], [N, 30], 1024)
    pcat = PK.concat_columns([pn, pn], [N, 30], 1024)
    for a, b in zip(jcat.arrays(), pcat.arrays()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its twin only for CPU tensors: any other device must
    launch the kernel or raise, never fall back."""
    col = PColumn(pdt.INT64, torch.zeros(CAP, dtype=torch.int64,
                                         device="meta"),
                  torch.zeros(CAP, dtype=torch.bool, device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        PK.sort_key_lanes([PK.SortKey(col)], N, CAP)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PK.segment_bounds([col], N, CAP)
    with pytest.raises(RuntimeError, match="unsupported device"):
        PK.compaction_indices(col.validity)
    assert native.counts() == {k: 0 for k in native.KERNELS}
