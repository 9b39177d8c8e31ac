#!/usr/bin/env python3
"""Drive the PyTorch port (spark_rapids_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 10] [--seed 7] [--only check_k19,...]

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every hand-written kernel from csrc/ with nvcc (sm_90a),
     timed; every kernel is rebuilt, whatever _build/ already holds; then
     the generated stage kernels of the main path's plans (planned over
     tiny tables) compiled by NVRTC and loaded, counted and timed;
  3. each kernel (K1-K30, K6's lower-bound mode, K7's outer mode, K13's
     locate mode, K1's fold alone and K21's offset mode) against
     its plain PyTorch twin on the card, at the main path's shapes and at
     edge cases, with the stated tolerance,
     plus CUDA-event timings of kernel, twin and (where one exists) the
     single PyTorch call computing the same function; K8-K10 are timed at
     the headline's shape (64 M rows) and at one 2^20-row batch, and K10's
     phase runs groupby_singleword on the card (no engine path calls it);
     K11 (murmur3) is also held to Spark's own hash values, K12
     (partition_split) to a stable sort + bincount and to itself, K4 also
     reduces shuffled ids over 5000 segments (the sort first), K13
     (find_pattern) runs over o_comment bytes with junk past the lengths,
     K7's outer mode and K14 (build_matched) at one partition of q13's
     join, K6 (join_probe) in both modes at 1-5 and 16 lanes, hot keys,
     unique keys, probes past either end, with host-int and device
     counts, timed at q3's second join; K15 (cross_expand) with empty
     sides and divisors with and without the add step, timed at q11's and
     q15's shapes; K6 and K15 with host-int counts under
     torch.cuda.set_sync_debug_mode("error") (no synchronize) and their
     registers and stack from nvcc -Xptxas -v (every K6 specialisation
     without stack frame or spills); once the main path has run, K15 at
     the shapes its cold runs of q11 and q15 gave it and K6 at its largest
     full and lower-bound calls (recorded where the engine calls the
     wrappers); K16 (string_map), K17
     (string_slice), K18 (string_place) and K13's locate mode over random
     UTF-8 rows (1-4-byte characters, leading continuation bytes, junk
     past the lengths, NULL and dead rows) at widths 8 to 256, and timed
     over o_comment (K16, K18, locate) and q22's c_phone batch (K17);
     K19 (fused_stage) against the eager chain of q6's filter, q1's
     filter -> aggregate inputs, the headline's chain, q7's stages (string
     equality, year) and two random chains over every generated family
     (NULL, NaN, +-inf, the integer extremes, days +-800000), K20
     (fused_reduce) + K1's fold against the eager chain + K1 on q6's batch
     and on every aggregate op, bit for bit, all at 2^20 rows; K21-K24
     (window ranks and offsets, segmented scans, frame bounds and frame
     aggregates) bit for bit over NULL, NaN, -0.0 and tied keys, one-row
     and one-segment batches, empty frames, unbounded ends and RANGE keys
     at the int32 edges, timed at the windows phase's shapes and at 2^20
     rows; K25-K28 (explode expansion, split count and place, map lookup
     and build) bit for bit over every primitive element type at widths
     4-64, NULL and empty arrays, NULL elements, random UTF-8 rows with the
     split's edge cases, duplicate and absent keys, NULL values, float
     maps, a float key on an int map and a bigint key on an int map,
     timed at the nested phase's shapes; K29 and K30 (the mesh's exchange
     bucketing and receive flattening) bit for bit at 1, 2, 4, 8 and 1024
     workers over empty slots, one full slot, no rows, every element width,
     junk bytes, NaN payloads and -0.0, timed at one worker's side of the
     mesh phase's q3 lineitem exchange;
     then K2, K3 and K11 at 9 and 17 key columns (their wrappers split the
     keys into blocks of 8) against their one-pass twins, and K12 at 5000
     and 65536 partitions (its device-memory counters);
  4. the main path, whole-stage fusion at its default (on): TPC-H q6,
     q1, q3, q12, q4, q13, q11, q15, q22, q2, q17, q5, q10, q14, q18, q19,
     q20, q7, q8, q9, q16 and q21 and TPC-DS q98 and q89 (store_sales
     drawn as benchmarks/datagen.py's register_tpcds_tables draws it)
     through
     TpuSession -> DataFrame -> collect on benchmarks/datagen.py lineitem,
     orders, customer, supplier, partsupp, nation, part and region data at
     scale factor --sf, then the root bench.py's headline
     (filter -> project -> dense-range group-by) over its 64 M rows, one
     cold and three hot runs each, held to numpy oracles computed
     independently from the same arrays (sort + searchsorted joins,
     bincount sums), then the string expressions over customer and part
     (string_exprs: length, case maps, substrings, concat, trims, pads,
     locate, LIKE, replace), each column held to a Python oracle of
     Spark's rules, with the host passes of the general LIKE and replace
     counted, then the windows phase (W1-W6: ranks, lead/lag and running
     aggregates over orders, ROWS and RANGE frames and a whole-partition
     sum over lineitem in one 2^26-row batch), then the nested phase
     (N1: o_comment split into words and counted; N2: p_type's words by
     position; N3: create_map over three lineitem keys, looked up,
     posexploded and measured; N4: a 2^20-row struct column made from
     python dicts, shredded into a filter and an aggregate, and whole
     through a broadcast join) against numpy oracles (the
     tables are drawn and every oracle computed on host threads while
     the kernels build, all of them finished before the kernel checks,
     so no timed phase shares the host with them); the launch counters
     are zeroed just before and read just after, and every kernel of
     each query's path must have launched in its cold run, the generated
     kernels of its plan's units included; the warm runs must be served
     from the device scan cache (no column uploaded or evicted, no cache
     entry refused); q3,
     q12, q4 and q13 must run on the reference's shuffled plan (hash
     exchanges, shuffled joins, a range exchange under the sort; q13's
     join a left outer one), q11 and q15 on a cross join, q22 on a cross
     join and a shuffled left anti join;
     then, outside the counted run, the mesh phase (M1-M5: q1, q3, a
     global orderBy over lineitem, q18's l_orderkey group-by through the
     streaming route and a repartition(8, l_orderkey) on the ICI plane,
     through a session with 4 mesh workers on the card, mesh.enabled=true,
     broadcast off, over datagen's tables at SF 1; each a cold and two hot
     runs held to numpy oracles, its plan's mesh execs, its peak and its
     cold run's launches; the counters set to 0 before the phase: its K29
     and K30 launches are their `phase_launches`), the headline and q1 at
     update-window
     depths 48, 8 and 1 (hot time and device peak at each), q3 and q4
     in the shuffled and the broadcast join form (join_form_ab), q11 at
     the TPC-H fraction 0.0001 / SF (q11_scaled, which must return rows),
     the right and full outer joins in both forms (outer_forms: q13
     written as a right join, customer full outer join the filtered
     orders), and q6, q1, q3, q7 and the headline with fusion on and off
     (fusion_ab: hot time, hot peak, the update stage's device kernels per
     scan batch and a hot run's top device kernels, from torch.profiler);
  5. the port bench's hand-built headline pipeline, once at 64 M rows,
     validated against the numpy oracle.
Then the kernel summary line, the card line and, last, the result line
{"ok": true, "device": {...}}. Any failure raises: exit code != 0 and no
result line. Without a CUDA device, or without the repository beside it,
the script exits != 0 before printing anything.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)

# K6/K7's main-path shape: q3's second join at SF 10 probes the ~1.46 M rows
# of customer x orders (capacity 2^21) into the ~32 M lineitem rows left by
# l_shipdate > 1995-03-15 (capacity 2^25); the keys are order keys.
Q3_BUILD_ROWS, Q3_BUILD_CAP = 32_000_000, 1 << 25
Q3_PROBE_ROWS, Q3_PROBE_CAP = 1_460_000, 1 << 21
Q3_KEY_RANGE = 15_000_001


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair_ms(fn_a, fn_b, iters: int = 100) -> tuple:
    """(median of ``fn_a``, median of ``fn_b``): CUDA-event times of one
    call each, the two called in turns (a b, b a, ...) so that neither
    meets the host in a better state; for calls whose time is host time."""
    import torch
    for _ in range(3):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(iters):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sector_bytes(mask, elem_bytes: int) -> int:
    """Bytes of the 32-byte DRAM sectors of an array of ``elem_bytes``-byte
    elements that hold at least one element where ``mask`` is set: what a
    kernel that loads only those elements must move."""
    import torch
    idx = mask.nonzero().flatten()
    return 32 * int(torch.unique(idx * elem_bytes // 32).numel())


def live_read_bytes(rows: int, live, key, cols) -> int:
    """Bytes a one-int-key group-by pass (K8, K9) must read over ``rows``
    rows: the live mask of every row; the key's and each value column's
    validity, and their data where that is also valid, in the 32-byte
    sectors that hold a live row. A column passed twice is read once."""
    live = live[:rows]
    total = rows + sector_bytes(live, 1) + sector_bytes(
        live & key.validity[:rows], key.data.element_size())
    for c in {id(c): c for c in cols}.values():
        total += sector_bytes(live, 1) + sector_bytes(
            live & c.validity[:rows], c.data.element_size())
    return total


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def column_err(got, want, rel: float, what: str) -> float:
    """Max |got - want| over valid slots; raises past ``rel`` (floats) or
    on any difference (ints, bools, validity)."""
    import torch
    if not torch.equal(got.validity, want.validity):
        raise AssertionError(f"{what}: validity differs")
    if got.data.dtype != want.data.dtype or got.data.shape != want.data.shape:
        raise AssertionError(f"{what}: {got.data.dtype}{tuple(got.data.shape)}"
                             f" vs {want.data.dtype}{tuple(want.data.shape)}")
    if not got.data.dtype.is_floating_point:
        if not torch.equal(got.data, want.data):
            bad = (got.data != want.data).nonzero()[:4].flatten().tolist()
            raise AssertionError(f"{what}: data differs at {bad}")
        return 0.0
    a, b = got.data.double(), want.data.double()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError(f"{what}: NaN positions differ")
    fin = ~torch.isnan(a)
    diff = (a - b).abs()[fin]
    if diff.numel() == 0:
        return 0.0
    scale = torch.maximum(a.abs(), b.abs())[fin]
    if bool((diff > rel * scale).any()):
        raise AssertionError(f"{what}: float error {float(diff.max())} "
                             f"beyond relative {rel}")
    return float(diff.max())


def tensor_err(got, want, what: str) -> float:
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel and twin differ")
    return 0.0


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def make_column(rng, dtype_name: str, cap: int, n: int, device,
                null_frac: float = 0.1, nan_frac: float = 0.05):
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    t = dt.of(dtype_name)
    if t == dt.STRING:
        vals = np.array(["A", "N", "R", "", "AB", "NO", "ABCDEFG"])[
            rng.integers(0, 7, n)]
    elif t == dt.BOOL:
        vals = rng.integers(0, 2, n).astype(np.bool_)
    elif t.is_floating:
        # multiples of 1/4 below 1000: every sum of up to 2^20 of them is
        # exact in f64, whatever the order of the additions
        vals = (rng.integers(-4000, 4000, n) / 4).astype(t.numpy_dtype)
        vals[rng.random(n) < nan_frac] = np.nan
        vals[rng.random(n) < 0.02] = -0.0
    else:
        vals = rng.integers(-1000, 1000, n).astype(t.numpy_dtype)
    valid = rng.random(n) >= null_frac
    return Column.from_numpy(vals, t, valid, capacity=cap, device=device)


AGG_OPS = ("count_star", "count", "sum", "avg", "min", "max", "first",
           "last")
AGG_TYPES = ("bigint", "int", "double", "float", "date", "boolean")


def _valid_spec(op: str, tname: str) -> bool:
    return not (op in ("sum", "avg") and tname == "date")


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def check_k1(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    cap = 1 << 20
    n = cap - 12345
    checks = 0
    for tname in AGG_TYPES:
        col = make_column(rng, tname, cap, n, device)
        for live_kind in ("rows", "mask", "empty", "all_null"):
            c = col
            if live_kind == "rows":
                live = torch.arange(cap, device=device) < n
            elif live_kind == "mask":
                live = (torch.rand(cap, device=device) < 0.3) & \
                    (torch.arange(cap, device=device) < n)
            elif live_kind == "empty":
                live = torch.zeros(cap, dtype=torch.bool, device=device)
            else:
                live = torch.arange(cap, device=device) < n
                c = Column(col.dtype, col.data,
                           torch.zeros_like(col.validity))
            for op in AGG_OPS:
                if not _valid_spec(op, tname):
                    continue
                for ign in ((True, False) if op in ("first", "last")
                            else (True,)):
                    spec = A.AggSpec(op, None if op == "count_star" else c,
                                     ign)
                    column_err(A.masked_reduce(spec, live),
                               A._masked_reduce_torch(spec, live), 1e-12,
                               f"K1 {op}({tname}) {live_kind}")
                    checks += 1
    # all-NaN float input
    nan = Column(dt.FLOAT64, torch.full((cap,), float("nan"),
                                        dtype=torch.float64, device=device),
                 torch.ones(cap, dtype=torch.bool, device=device))
    live = torch.ones(cap, dtype=torch.bool, device=device)
    for op in ("min", "max", "sum", "avg"):
        spec = A.AggSpec(op, nan)
        column_err(A.masked_reduce(spec, live),
                   A._masked_reduce_torch(spec, live), 1e-12,
                   f"K1 {op} all-NaN")
        checks += 1
    # the main path's shape: q6's SUM(l_extendedprice * l_discount) over a
    # ~2% live mask of one 2^20-row batch
    price = torch.from_numpy(np.round(rng.uniform(900, 105000, cap), 2) *
                             np.round(rng.uniform(0, 0.1, cap), 2)).to(device)
    col = Column(dt.FLOAT64, price, torch.ones(cap, dtype=torch.bool,
                                               device=device))
    live = torch.rand(cap, device=device) < 0.02
    all_live = torch.ones(cap, dtype=torch.bool, device=device)
    spec = A.AggSpec("sum", col)
    err = max(column_err(A.masked_reduce(spec, m),
                         A._masked_reduce_torch(spec, m), 1e-12,
                         f"K1 q6 sum {what}")
              for m, what in ((live, "q6 mask"), (all_live, "all live")))
    # determinism: the same input gives the same bits
    a = A.masked_reduce(spec, live).data
    b = A.masked_reduce(spec, live).data
    if not torch.equal(a, b):
        raise AssertionError("K1 differs between two runs on one input")
    # K1 reads the whole live mask, but validity and data only where a row
    # is live (data only where it is also valid): count the sectors this
    # mask touches. It writes one 128-slot f64 column and its validity.
    out_bytes = 128 * (8 + 1)
    q6_bytes = (cap + sector_bytes(live, 1) +
                sector_bytes(live & col.validity, 8) + out_bytes)
    return {
        "name": "masked_reduce", "checks": checks + 2, "max_abs_err": err,
        "tolerance": "floats relative 1e-12, everything else exact",
        "live_rows": int(live.sum()),
        "ms": time_ms(lambda: A.masked_reduce(spec, live)),
        "plain_ms": time_ms(lambda: A._masked_reduce_torch(spec, live)),
        "library_ms": time_ms(
            lambda: torch.where(live & col.validity, price, 0.0).sum()),
        "bound_ms": bound_ms(q6_bytes),
        "ms_all_live": time_ms(lambda: A.masked_reduce(spec, all_live)),
        "bound_ms_all_live": bound_ms(cap * (8 + 1 + 1) + out_bytes),
    }


def _q1_keys(rng, cap: int, n: int, device):
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    rf = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    ls = np.array(["F", "O"])[rng.integers(0, 2, n)]
    return [Column.from_numpy(rf, dt.STRING, capacity=cap, device=device),
            Column.from_numpy(ls, dt.STRING, capacity=cap, device=device)]


def check_k2(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import kernels as K
    cap = 1 << 20
    n = cap - 999
    checks = 0
    key_sets = [
        [("bigint", True, True)],
        [("int", False, False)],
        [("double", True, True), ("bigint", False, True)],
        [("double", False, False)],
        [("float", True, False)],
        [("boolean", False, True), ("date", True, True)],
        [("string", True, True), ("string", False, False)],
    ]
    for keys in key_sets:
        cols = [(make_column(rng, t, cap, n, device), a, nf)
                for t, a, nf in keys]
        sk = [K.SortKey(c, a, nf) for c, a, nf in cols]
        for live in (None, (torch.rand(cap, device=device) < 0.7) &
                     (torch.arange(cap, device=device) < n)):
            tensor_err(K.sort_key_lanes(sk, n, cap, live),
                       K._sort_key_lanes_torch(sk, n, cap, live),
                       f"K2 lanes {keys}")
            checks += 1
    # the main path's shape: q1's group-by keys (two W=8 strings) with the
    # ~98% live mask of its shipdate filter
    keys = [K.SortKey(c) for c in _q1_keys(rng, cap, n, device)]
    live = (torch.rand(cap, device=device) < 0.98) & \
        (torch.arange(cap, device=device) < n)
    lanes = K.sort_key_lanes(keys, n, cap, live)
    err = tensor_err(lanes, K._sort_key_lanes_torch(keys, n, cap, live),
                     "K2 q1 lanes")
    nl = lanes.shape[0]
    key_bytes = sum(c.column.device_size_bytes() for c in keys) + cap
    return {
        "name": "sort_key_lanes", "checks": checks + 1, "max_abs_err": err,
        "tolerance": "exact (int64 lanes)",
        "ms": time_ms(lambda: K.sort_key_lanes(keys, n, cap, live)),
        "plain_ms": time_ms(
            lambda: K._sort_key_lanes_torch(keys, n, cap, live)),
        "library_ms": None,
        "bound_ms": bound_ms(key_bytes + nl * cap * 8),
        "lanes": nl,
    }


def _k3_outputs_err(got, want, what: str) -> float:
    for g, w, name in zip(got, want, ("starts", "seg_ids", "n_groups",
                                      "first_row")):
        tensor_err(g, w, f"{what} {name}")
    return 0.0


def check_k3(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import kernels as K
    cap = 1 << 20
    n = cap - 4321
    checks = 0
    for keys in ([("bigint", True, True)],
                 [("double", True, True), ("int", True, True)],
                 [("string", True, True)],
                 [("boolean", True, True), ("date", True, True)]):
        cols = [make_column(rng, t, cap, n, device) for t, _a, _nf in keys]
        order = K.sort_indices([K.SortKey(c) for c in cols], n, cap)
        srt = [K.gather_column(c, order) for c in cols]
        for n_live in (n, 0, 1):
            _k3_outputs_err(K.segment_bounds(srt, n_live, cap),
                            K._segment_bounds_torch(srt, n_live, cap),
                            f"K3 {keys} n_live={n_live}")
            checks += 1
    # the main path's shape: q1's sorted group-by keys
    cols = _q1_keys(rng, cap, n, device)
    live = (torch.rand(cap, device=device) < 0.98) & \
        (torch.arange(cap, device=device) < n)
    order = K.sort_indices([K.SortKey(c) for c in cols], n, cap, live)
    srt = [K.gather_column(c, order) for c in cols]
    n_live = live.sum()
    err = _k3_outputs_err(K.segment_bounds(srt, n_live, cap),
                          K._segment_bounds_torch(srt, n_live, cap),
                          "K3 q1")
    key_bytes = sum(c.device_size_bytes() for c in srt)
    return {
        "name": "segment_bounds", "checks": checks + 1, "max_abs_err": err,
        "tolerance": "exact",
        "ms": time_ms(lambda: K.segment_bounds(srt, n_live, cap)),
        "plain_ms": time_ms(lambda: K._segment_bounds_torch(srt, n_live,
                                                            cap)),
        "library_ms": None,
        "bound_ms": bound_ms(key_bytes + cap * (1 + 4 + 4) + 4),
    }


def _sorted_segments(rng, cap: int, n: int, kind: str, device):
    import torch
    if kind == "giant":
        lens = [n // 6] * 5 + [n - 5 * (n // 6)]
    elif kind == "singletons":
        lens = [1] * n
    else:
        lens = []
        left = n
        while left > 0:
            k = int(min(left, rng.integers(1, 2000)))
            lens.append(k)
            left -= k
    ids = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    full = np.full(cap, ids[-1] if n else -1, np.int32)
    full[:n] = ids
    return torch.from_numpy(full).to(device), len(lens)


def check_k4(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.columnar.column import Column, bucket
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    cap = 1 << 20
    n = cap - 777
    checks = 0
    live = torch.arange(cap, device=device) < n
    for kind in ("giant", "singletons", "random"):
        seg, ng = _sorted_segments(rng, cap, n, kind, device)
        kb = bucket(ng)
        for tname in AGG_TYPES:
            col = make_column(rng, tname, cap, n, device)
            for op in AGG_OPS:
                if not _valid_spec(op, tname):
                    continue
                for ign in ((True, False) if op in ("first", "last")
                            else (True,)):
                    spec = A.AggSpec(op, None if op == "count_star" else col,
                                     ign)
                    column_err(A.segment_reduce(spec, seg, live, kb),
                               A._segment_reduce_torch(spec, seg, live, kb),
                               1e-12, f"K4 {op}({tname}) {kind}")
                    checks += 1
    # the main path's shape: q1's SUM(l_extendedprice) update over 6 groups
    # of ~175K rows in one 2^20-row batch (rows sorted by group)
    seg, ng = _sorted_segments(rng, cap, n, "giant", device)
    price = torch.from_numpy(np.round(rng.uniform(900, 105000, cap), 2)).to(
        device)
    col = Column(dt.FLOAT64, price, live.clone())
    spec = A.AggSpec("sum", col)
    kb = bucket(ng)
    err = column_err(A.segment_reduce(spec, seg, live, kb),
                     A._segment_reduce_torch(spec, seg, live, kb), 1e-12,
                     "K4 q1 sum")
    a = A.segment_reduce(spec, seg, live, kb).data
    if not torch.equal(a, A.segment_reduce(spec, seg, live, kb).data):
        raise AssertionError("K4 differs between two runs on one input")
    lengths = torch.bincount(seg[:n].long(), minlength=ng)[:ng]
    masked = torch.where(live & col.validity, price, 0.0)[:n].contiguous()
    lib = torch.segment_reduce(masked, "sum", lengths=lengths)
    got = A.segment_reduce(spec, seg, live, kb).data[:ng]
    if not torch.allclose(lib, got, rtol=1e-12, atol=0.0):
        raise AssertionError("K4 disagrees with torch.segment_reduce")
    # segment_aggregate above DENSE_MAX_SLOTS with ids in any order: the
    # live rows are stable-sorted by id, then K4 reduces the runs; held to
    # the twin's scatter over the unsorted ids (out-of-range ids dropped)
    ids = torch.randint(0, 5000, (cap,), dtype=torch.int32, device=device)
    ids[torch.rand(cap, device=device) < 0.01] = 5003
    shuffled_live = live & (torch.rand(cap, device=device) < 0.9)
    for tname in AGG_TYPES:
        scol = make_column(rng, tname, cap, n, device)
        for op in AGG_OPS:
            if not _valid_spec(op, tname):
                continue
            for ign in ((True, False) if op in ("first", "last")
                        else (True,)):
                sspec = A.AggSpec(op, None if op == "count_star" else scol,
                                  ign)
                column_err(
                    A.segment_aggregate(sspec, ids, shuffled_live, cap, 5000),
                    A._segment_reduce_torch(sspec, ids, shuffled_live, 5000),
                    1e-12, f"K4 shuffled ids {op}({tname})")
                checks += 1
    return {
        "name": "segment_reduce", "checks": checks + 2, "max_abs_err": err,
        "tolerance": "floats relative 1e-12, everything else exact",
        "ms": time_ms(lambda: A.segment_reduce(spec, seg, live, kb)),
        "plain_ms": time_ms(
            lambda: A._segment_reduce_torch(spec, seg, live, kb)),
        "library_ms": time_ms(
            lambda: torch.segment_reduce(masked, "sum", lengths=lengths)),
        "bound_ms": bound_ms(cap * (8 + 1 + 4 + 1) + kb * (8 + 1)),
    }


def check_k5(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import kernels as K
    checks = 0
    for cap, n in ((128, 100), (1000, 1000), (1 << 20, (1 << 20) - 4321),
                   (1 << 22, (1 << 22) - 7)):
        idx = torch.arange(cap, device=device)
        for kind in ("none", "all", "alternating", "random", "sparse"):
            if kind == "none":
                keep = torch.zeros(cap, dtype=torch.bool, device=device)
            elif kind == "all":
                keep = idx < n
            elif kind == "alternating":
                keep = (idx % 2 == 0) & (idx < n)
            else:
                frac = 0.5 if kind == "random" else 0.001
                keep = (torch.rand(cap, device=device) < frac) & (idx < n)
            got = K.compaction_indices(keep)
            want = K._compaction_indices_torch(keep)
            tensor_err(got[0], want[0], f"K5 perm {kind} cap={cap}")
            tensor_err(got[1], want[1], f"K5 count {kind} cap={cap}")
            checks += 1
    # the main path's shape: q3's lineitem filter (l_shipdate > 1995-03-15
    # keeps ~55%) over one 2^20-row scan batch
    cap = 1 << 20
    keep = (torch.rand(cap, device=device) < 0.55) & \
        (torch.arange(cap, device=device) < cap - 4321)
    err = max(tensor_err(a, b, "K5 q3 filter") for a, b in zip(
        K.compaction_indices(keep), K._compaction_indices_torch(keep)))
    return {
        "name": "compact_scan", "checks": checks + 1, "max_abs_err": err,
        "tolerance": "exact (permutation and count)",
        "ms": time_ms(lambda: K.compaction_indices(keep)),
        "plain_ms": time_ms(lambda: K._compaction_indices_torch(keep)),
        "library_ms": time_ms(lambda: (torch.argsort(~keep, stable=True),
                                       keep.sum())),
        "bound_ms": bound_ms(cap * (1 + 8) + 4),
    }


def _key_column(values, valid, cap, device, tname="bigint"):
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    return Column.from_numpy(values, dt.of(tname), valid, capacity=cap,
                             device=device)


def _probe_inputs(rng, device, n_build, bcap, n_probe, pcap, key_range):
    """q3-shaped int64 keys (l_orderkey against the orders that joined):
    the sorted build side and the probe lanes."""
    from spark_rapids_tpu_torch.ops import joins as J
    bvals = rng.integers(1, key_range, n_build)
    pvals = rng.integers(1, key_range, n_probe)
    bcol = _key_column(bvals, None, bcap, device)
    pcol = _key_column(pvals, None, pcap, device)
    side = J.sort_build([bcol], n_build)
    plane, pvalid = J._normalize_words([pcol])
    return side, plane, pvalid, bvals, pvals


def _probe_err(got, want, what: str) -> float:
    for g, w, name in zip(got, want, ("lo", "count", "total")):
        tensor_err(g, w, f"{what} {name}")
    return 0.0


def _join_key_cases(rng, device):
    """(name, build keys, n_build, stream keys, n_stream): the edge cases
    of the CPU parity tests, at card sizes."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    cases = []
    n_b, n_s = 60000, 50000
    b = rng.integers(0, 20000, n_b)
    s_ = rng.integers(0, 25000, n_s)
    cases.append(("int64 dups", [_key_column(b, None, 1 << 16, device)],
                  n_b, [_key_column(s_, None, 1 << 16, device)], n_s))
    cases.append(("int64 nulls both sides",
                  [_key_column(b, rng.random(n_b) > 0.1, 1 << 16, device)],
                  n_b,
                  [_key_column(s_, rng.random(n_s) > 0.1, 1 << 16, device)],
                  n_s))
    fb = (rng.integers(-3, 4, n_b) / 2).astype(np.float64)
    fs = (rng.integers(-3, 4, n_s) / 2).astype(np.float64)
    fb[rng.random(n_b) < 0.1] = np.nan
    fs[rng.random(n_s) < 0.1] = np.nan
    fb[fb == 0] = -0.0
    cases.append(("f64 NaN and -0.0/+0.0",
                  [_key_column(fb, None, 1 << 16, device, "double")], n_b,
                  [_key_column(fs, None, 1 << 16, device, "double")], n_s))
    words_b = np.array(["MAIL", "SHIP", "AIR", "REG AIR", ""])[
        rng.integers(0, 5, n_b)]
    words_s = np.array(["MAIL", "SHIP", "TRUCK", "REG AIR XL", ""])[
        rng.integers(0, 5, n_s)]
    cases.append(("int + string, widths 8 and 16", [
        _key_column(b % 50, None, 1 << 16, device),
        Column.from_numpy(words_b, dt.STRING, capacity=1 << 16,
                          device=device, width=8)], n_b, [
        _key_column(s_ % 50, None, 1 << 16, device),
        Column.from_numpy(words_s, dt.STRING, capacity=1 << 16,
                          device=device, width=16)], n_s))
    cases.append(("empty build", [_key_column(b[:0], None, 128, device)], 0,
                  [_key_column(s_, None, 1 << 16, device)], n_s))
    cases.append(("empty stream", [_key_column(b, None, 1 << 16, device)],
                  n_b, [_key_column(s_[:0], None, 128, device)], 0))
    full = np.arange(1 << 16)
    cases.append(("build fills its capacity",
                  [_key_column(full, None, 1 << 16, device)], 1 << 16,
                  [_key_column(s_, None, 1 << 16, device)], n_s))
    return cases


# K6's and K15's register and stack use, from ``nvcc -Xptxas -v`` on their
# sources (the same flags as the build, to a cubin)
PTXAS_SOURCES = ("join_probe", "cross_expand")
_PTXAS: dict = {}


def ptxas_usage(name: str) -> list:
    """[{kernel, registers, stack_bytes, spill_stores, spill_loads}] of
    every kernel entry of csrc/<name>.cu; the sources of PTXAS_SOURCES
    compile together, once, on first use."""
    import tempfile
    from spark_rapids_tpu_torch import native
    if name not in _PTXAS:
        native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
            procs = {src: subprocess.Popen(
                [native.nvcc_path(), *native.ARCH_FLAGS, "-std=c++17", "-O3",
                 "-cubin", "-Xptxas", "-v", "-I", str(native.CSRC), "-o",
                 f"{tmp}/{src}.cubin", str(native.CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src in PTXAS_SOURCES}
            for src, proc in procs.items():
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc -Xptxas -v {src}:\n{out}")
                _PTXAS[src] = _parse_ptxas(out)
    return _PTXAS[name]


def _parse_ptxas(out: str) -> list:
    import re
    usage, entry = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            entry = usage.setdefault(m.group(1), {"kernel": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry is not None:
            entry.update(stack_bytes=int(m.group(1)),
                         spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    for e in usage.values():
        m = re.search(r"probe_kernelILi(\d+)ELb([01])E", e["kernel"])
        if m:
            e["kernel"] = (f"probe_kernel<{m.group(1)}, "
                           f"{'lower' if m.group(2) == '1' else 'full'}>")
        m = re.search(r"cross_kernelI([jx])E", e["kernel"])
        if m:
            e["kernel"] = ("cross_kernel<unsigned>" if m.group(1) == "j"
                           else "cross_kernel<long long>")
    return [e for e in usage.values() if "registers" in e]


@contextlib.contextmanager
def no_sync():
    """Inside the block, any CUDA synchronize PyTorch makes raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sync_detector_works(device) -> None:
    """The detector raises on the copy the wrappers used to make: a host
    int uploaded as a count tensor."""
    from spark_rapids_tpu_torch.ops import kernels as K
    try:
        with no_sync():
            K._count_tensor(5, device)
    except RuntimeError:
        return
    raise AssertionError("set_sync_debug_mode('error') let a pageable "
                         "host -> device copy pass")


def k6_bytes(nl: int, n_build: int, n_probe: int, pcap: int, n_valid: int,
             lower: bool) -> int:
    """What K6 must move at least: every probe row's ``nl`` 8-byte lanes
    read (lo is defined for every row of the capacity ``pcap``) and, in the
    full mode, its ``n_valid`` validity bytes; lo (and count) written for
    every row, and the totals; of the sorted build, at most its live rows'
    lanes and at most one 32-byte sector (one row, when wider) a live
    probe row: each search reads at least the row next to its answer."""
    row = 8 * nl
    build = min(n_build * row, n_probe * max(32, row))
    if lower:
        return pcap * (row + 4) + build
    return pcap * (row + n_valid + 4 + 4) + build + 16


def _raw_lane_cases(rng, device):
    """(name, sorted build lanes, n_build, probe lanes, validities, n_probe):
    raw lanes of every specialisation's lane count (1-4, 5 and 16 for the
    general one), small values so rows tie on leading lanes; builds of a
    few rows (the whole search in shared memory, lane-major) and of 300 K
    (a sample stride past 1, row-major); NULL probe keys; probes below and
    above every build row; a hot key of 100 K rows; unique keys."""
    import torch
    from spark_rapids_tpu_torch.ops import kernels as K
    cases = []

    def build_of(vals, cap):
        """Sorted lanes, lane-major below 2^16 rows, row-major (as
        sort_build gives them) above."""
        lanes = torch.zeros((vals.shape[0], cap), dtype=torch.int64,
                            device=device)
        n = vals.shape[1]
        lanes[:, :n] = torch.from_numpy(vals).to(device)
        order = K.lanes_order(lanes[:, :n])
        lanes[:, :n] = lanes[:, :n][:, order]
        return lanes if cap < 1 << 16 else lanes.t().contiguous().t()

    for nl in (1, 2, 3, 4, 5, 16):
        for n_b, bcap in ((1000, 1024), (300_000, 1 << 19)):
            n_p, pcap = 200_000, 1 << 18
            hi = 6 if nl > 1 else 400
            bv = rng.integers(0, hi, (nl, n_b))
            pv = rng.integers(-1, hi + 1, (nl, pcap))
            valid = [torch.from_numpy(rng.random(pcap) > 0.1).to(device)
                     for _ in range(min(nl, 8))]
            cases.append((f"{nl} lanes, {n_b} build rows",
                          build_of(bv, bcap), n_b,
                          torch.from_numpy(pv).to(device).contiguous(),
                          valid, n_p))
    n_b, bcap, pcap = 1 << 20, 1 << 20, 1 << 18
    hot = np.sort(np.concatenate([rng.integers(0, 50_000, n_b - 100_000),
                                  np.full(100_000, 25_000)]))
    probe = rng.integers(-5, 50_005, pcap)
    probe[::7] = 25_000
    probe[1::11] = -10**12
    probe[2::13] = 10**12
    for name, bv in (("hot key of 100 K rows", hot),
                     ("unique keys", rng.permutation(n_b))):
        cases.append((f"2 lanes, {name}", build_of(
            np.stack([np.zeros(n_b, np.int64), bv]), bcap), n_b,
            torch.from_numpy(np.stack([np.zeros(pcap, np.int64), probe])
                             ).to(device).contiguous(), [], pcap - 3))
    return cases


def _k6_both(lanes, n_build, plane, pvalid, n_probe, what: str) -> None:
    """K6 against its twin in both modes; the lower mode's lo equal to
    the full mode's; host-int and 0-d device counts alike."""
    import torch
    from spark_rapids_tpu_torch.ops import joins as J
    got = J.join_probe(lanes, n_build, plane, pvalid, n_probe)
    _probe_err(got, J._join_probe_torch(lanes, n_build, plane, pvalid,
                                        n_probe), what)
    lower, _, _ = J.join_probe(lanes, n_build, plane, pvalid, n_probe,
                               lower_only=True)
    tensor_err(lower, got[0], f"{what} lower-only lo vs full lo")
    tensor_err(lower, J._join_probe_torch(lanes, n_build, plane, pvalid,
                                          n_probe, lower_only=True)[0],
               f"{what} lower-only lo vs twin")
    on_device = J.join_probe(lanes, torch.tensor(n_build, device=lanes.device),
                             plane, pvalid,
                             torch.tensor(n_probe, device=lanes.device))
    _probe_err(on_device, got, f"{what} 0-d tensor counts")


def check_k6(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import joins as J
    usage = ptxas_usage("join_probe")
    if len(usage) != 10 or any(u["stack_bytes"] or u["spill_stores"] or
                               u["spill_loads"] for u in usage):
        raise AssertionError(f"K6's specialisations: {usage}")
    checks = 0
    for name, bk, nb, sk, ns in _join_key_cases(rng, device):
        widths = J.pair_widths(bk, sk)
        side = J.sort_build(J.widen_keys(bk, widths), nb)
        plane, pvalid = J._normalize_words(J.widen_keys(sk, widths))
        _k6_both(side.lanes, nb, plane, pvalid, ns, f"K6 {name}")
        checks += 1
    for name, lanes, nb, plane, pvalid, ns in _raw_lane_cases(rng, device):
        _k6_both(lanes, nb, plane, pvalid, ns, f"K6 {name}")
        checks += 1
    # the main path's shape: q3's second join
    n_build, n_probe, pcap = Q3_BUILD_ROWS, Q3_PROBE_ROWS, Q3_PROBE_CAP
    side, plane, pvalid, bvals, pvals = _probe_inputs(
        rng, device, n_build, Q3_BUILD_CAP, n_probe, pcap, Q3_KEY_RANGE)
    got = J.join_probe(side.lanes, n_build, plane, pvalid, n_probe)
    err = _probe_err(got, J._join_probe_torch(side.lanes, n_build, plane,
                                               pvalid, n_probe), "K6 q3")
    lower, _, _ = J.join_probe(side.lanes, n_build, plane, pvalid, n_probe,
                               lower_only=True)
    tensor_err(lower, got[0], "K6 q3 lower-only lo vs full lo")
    nl = plane.shape[0]
    srt = torch.sort(torch.from_numpy(bvals).to(device)).values
    pv = torch.from_numpy(pvals).to(device)
    lib_lo = torch.searchsorted(srt, pv, side="left")
    lib_hi = torch.searchsorted(srt, pv, side="right")
    if not torch.equal(lib_lo.to(torch.int32), got[0][:n_probe]) or \
            not torch.equal((lib_hi - lib_lo).to(torch.int32),
                            got[1][:n_probe]):
        raise AssertionError("K6 disagrees with torch.searchsorted")
    # host-int counts: no synchronize in either mode
    sync_detector_works(device)
    with no_sync():
        J.join_probe(side.lanes, n_build, plane, pvalid, n_probe)
        J.join_probe(side.lanes, n_build, plane, pvalid, n_probe,
                     lower_only=True)
    checks += 4
    lower_r = {
        "name": "join_probe_lower", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (lo)", "n_build": n_build, "n_probe": n_probe,
        "timed_at_shape": "q3's second join",
        "ms": time_ms(lambda: J.join_probe(side.lanes, n_build, plane,
                                           pvalid, n_probe,
                                           lower_only=True)),
        "plain_ms": time_ms(lambda: J._join_probe_torch(
            side.lanes, n_build, plane, pvalid, n_probe, lower_only=True),
            iters=5),
        "library_ms": time_ms(lambda: torch.searchsorted(srt, pv,
                                                         side="left")),
        "bound_ms": bound_ms(k6_bytes(nl, n_build, n_probe, pcap,
                                      len(pvalid), True))}
    return {
        "name": "join_probe", "checks": checks, "max_abs_err": err,
        "tolerance": "exact (lo, count, total)", "lanes": nl,
        "n_build": n_build, "n_probe": n_probe, "no_sync": True,
        "ptxas": usage,
        "ms": time_ms(lambda: J.join_probe(side.lanes, n_build, plane,
                                           pvalid, n_probe)),
        "plain_ms": time_ms(lambda: J._join_probe_torch(
            side.lanes, n_build, plane, pvalid, n_probe), iters=5),
        "library_ms": time_ms(lambda: (
            torch.searchsorted(srt, pv, side="left"),
            torch.searchsorted(srt, pv, side="right"))),
        "bound_ms": bound_ms(k6_bytes(nl, n_build, n_probe, pcap,
                                      len(pvalid), False)),
        "modes": [lower_r],
    }


def _main_probe_inputs(device, nl: int, bcap: int, n_build: int, pcap: int,
                       seed: int):
    """Lanes at a recorded main-path shape: the leading lanes zero, the
    last a key, the build sorted (row-major); about two build rows a
    key."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    key_range = max(1, n_build // 2)
    build = torch.zeros((nl, bcap), dtype=torch.int64, device=device)
    build[-1, :n_build] = torch.sort(torch.randint(
        0, key_range, (n_build,), generator=g, device=device)).values
    build[-1, n_build:] = key_range       # padding sorts last
    probe = torch.zeros((nl, pcap), dtype=torch.int64, device=device)
    probe[-1] = torch.randint(0, key_range, (pcap,), generator=g,
                              device=device)
    return build.t().contiguous().t(), probe    # row-major, as sort_build


TIMES = ("ms", "plain_ms", "library_ms", "bound_ms")


def check_k6_main(device, calls: list) -> dict:
    """K6 at the main path's largest full-mode call and its largest
    lower-bound-mode call (range ids) of the counted run, by probe
    capacity: checked against the twin and timed, with the library call
    beside it; the range ids' build lane-major, as they pass it, and timed
    again transposed to row-major first."""
    import torch
    from spark_rapids_tpu_torch.ops import joins as J
    timed = {}
    for lower in (False, True):
        mine = [c for c in calls if c[5] == lower]
        if not mine:
            raise AssertionError(f"no {'lower' if lower else 'full'}-mode "
                                 "join_probe call in the counted run")
        nl, bcap, n_build, pcap, n_probe, _ = max(
            mine, key=lambda c: (c[3], c[1]))
        n_build, n_probe = int(n_build), int(n_probe)
        build, probe = _main_probe_inputs(device, nl, bcap, n_build, pcap,
                                          7)
        if lower:
            build = build.contiguous()    # K2's lanes, as the range ids
        twin = J._join_probe_torch(build, n_build, probe, [], n_probe, lower)
        got = J.join_probe(build, n_build, probe, [], n_probe,
                           lower_only=lower)
        for g, w, what in zip(got, twin, ("lo", "count", "total")):
            if w is not None:
                tensor_err(g, w, f"K6 main-path shape {what}")
        srt = build[-1, :n_build].contiguous()
        key = probe[-1, :min(n_probe, pcap)]

        def library():
            if lower:
                return torch.searchsorted(srt, key, side="left")
            return (torch.searchsorted(srt, key, side="left"),
                    torch.searchsorted(srt, key, side="right"))
        timed["lower" if lower else "full"] = {
            "lanes": nl, "build_capacity": bcap, "n_build": n_build,
            "probe_capacity": pcap, "n_probe": n_probe,
            "ms": time_ms(lambda: J.join_probe(build, n_build, probe, [],
                                               n_probe, lower_only=lower)),
            "plain_ms": time_ms(lambda: J._join_probe_torch(
                build, n_build, probe, [], n_probe, lower), iters=5),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms(k6_bytes(nl, n_build, min(n_probe, pcap),
                                          pcap, 0, lower))}
        if lower:
            # what a row-major-only kernel would cost the range ids: the
            # lanes transposed before the call
            timed["lower"]["ms_transposed_first"] = time_ms(
                lambda: J.join_probe(build.t().contiguous().t(), n_build,
                                     probe, [], n_probe, lower_only=True))
    return {"name": "join_probe", "main_path_calls": len(calls),
            "timed_at_main_path": timed}


def _expand_err(got, want, what: str) -> float:
    for g, w, name in zip(got, want, ("stream_idx", "build_idx", "live")):
        tensor_err(g, w, f"{what} {name}")
    return 0.0


def check_k7(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.columnar.column import bucket
    from spark_rapids_tpu_torch.ops import joins as J
    checks = 0
    for name, bk, nb, sk, ns in _join_key_cases(rng, device):
        m = J.join_match(bk, nb, sk, ns, sk[0].capacity)
        out_cap = bucket(max(int(m.total_pairs), 1))
        _expand_err(J._expand_indices(m, out_cap),
                    J._expand_indices_torch(m, out_cap), f"K7 {name}")
        checks += 1
    # skew: one stream row matching a hot key of a million build rows
    cap = 1 << 20
    hot = np.where(np.arange(cap) < 1_000_000, 7, np.arange(cap))
    m = J.join_match([_key_column(hot, None, cap, device)], cap,
                     [_key_column(np.array([7, 3, 7]), None, 128, device)],
                     3, 128)
    out_cap = bucket(int(m.total_pairs))
    _expand_err(J._expand_indices(m, out_cap),
                J._expand_indices_torch(m, out_cap), "K7 skewed key")
    # the main path's shape: q3's second join
    n_build, n_probe, pcap = Q3_BUILD_ROWS, Q3_PROBE_ROWS, Q3_PROBE_CAP
    side, plane, pvalid, _b, _p = _probe_inputs(
        rng, device, n_build, Q3_BUILD_CAP, n_probe, pcap, Q3_KEY_RANGE)
    lo, count, totals = J.join_probe(side.lanes, n_build, plane, pvalid,
                                     n_probe)
    m = J.JoinMatch(lo, count, side.order, totals[0], None, totals)
    n_pairs = int(totals[0])
    out_cap = bucket(n_pairs)
    err = _expand_err(J._expand_indices(m, out_cap),
                      J._expand_indices_torch(m, out_cap), "K7 q3")
    rows = torch.arange(pcap, device=device)
    lib = torch.repeat_interleave(rows, count.to(torch.int64),
                                  output_size=n_pairs)
    if not torch.equal(lib, J._expand_indices(m, out_cap)[0][:n_pairs]):
        raise AssertionError("K7 disagrees with torch.repeat_interleave")
    return {
        "name": "join_expand", "checks": checks + 2, "max_abs_err": err,
        "tolerance": "exact (indices)", "pairs": n_pairs,
        "out_capacity": out_cap,
        "ms": time_ms(lambda: J._expand_indices(m, out_cap)),
        "plain_ms": time_ms(lambda: J._expand_indices_torch(m, out_cap)),
        "library_ms": time_ms(lambda: torch.repeat_interleave(
            rows, count.to(torch.int64), output_size=n_pairs)),
        # count and lo of each live probe row read, one order entry per
        # pair read, two int64 indices per pair and the total written
        "bound_ms": bound_ms(n_probe * (4 + 4) + n_pairs * (8 + 16) + 8),
    }


# -- K8-K10: the dense-range and single-word group-by -------------------------

HEADLINE_ROWS, HEADLINE_CAP = 64_000_000, 1 << 26
KEY_TYPES = ("tinyint", "smallint", "int", "bigint", "boolean", "date",
             "timestamp")
SLOT_VALUE_TYPES = ("bigint", "int", "double", "float", "date", "boolean")


def float_err(got, want, rel: float, what: str) -> float:
    """Max |got - want| of two f64 tensors; NaN and inf must match exactly,
    finite values within ``rel`` of the larger magnitude."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes differ")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    fin = torch.isfinite(got) & torch.isfinite(want)
    if not torch.equal(got[~fin & ~torch.isnan(got)],
                       want[~fin & ~torch.isnan(want)]):
        raise AssertionError(f"{what}: infinities differ")
    diff = (got - want).abs()[fin]
    if diff.numel() == 0:
        return 0.0
    scale = torch.maximum(got.abs(), want.abs())[fin]
    if bool((diff > rel * scale).any()):
        raise AssertionError(f"{what}: float error {float(diff.max())} "
                             f"beyond relative {rel}")
    return float(diff.max())


def key_column(rng, tname: str, cap: int, n: int, device, lo: int = -700,
               span: int = 1000, null_frac: float = 0.1):
    """Keys in [lo, lo + span) (0/1 for boolean), ``null_frac`` NULL."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    t = dt.of(tname)
    if t == dt.BOOL:
        vals = rng.integers(0, 2, n).astype(np.bool_)
    else:
        vals = (lo + rng.integers(0, span, n)).astype(t.numpy_dtype)
    valid = rng.random(n) >= null_frac
    return Column.from_numpy(vals, t, valid, capacity=cap, device=device)


def _all_specs(A, cols):
    specs = []
    for col in cols:
        for op in AGG_OPS:
            if op == "count_star" or not _valid_spec(op, col.dtype.name):
                continue
            for ign in ((True, False) if op in ("first", "last")
                        else (True,)):
                specs.append(A.AggSpec(op, col, ign))
    return [A.AggSpec("count_star", None)] + specs


def k9_against_twin(A, specs, src, K_slots: int, num_rows, mask, cap: int,
                    device, what: str) -> float:
    """K9 and its twin on the same features: integer features exact, f64
    sums within 1e-12 relative; then the assembled columns of every spec."""
    feats = A._Features()
    occ = feats.add("occ")
    plans = [A._plan_spec(feats, s) for s in specs]
    got = A.slot_features(feats.items, src, K_slots, num_rows, mask)
    live = A._live_mask(cap, num_rows, mask, device)
    want = A._slot_features_torch(feats.items, src, live, K_slots)
    err = 0.0
    for f, g, w in zip(feats.items, got, want):
        if f.kind == "fsum":
            err = max(err, float_err(g, w, 1e-12, f"{what} fsum"))
        else:
            tensor_err(g, w, f"{what} {f.kind}")
    for s, p in zip(specs, plans):
        column_err(A._assemble(s, p, got, occ, K_slots, False),
                   A._assemble(s, p, want, occ, K_slots, False), 1e-12,
                   f"{what} {s.op}({s.column.dtype.name if s.column else ''})")
    return err


def headline_batch(device):
    """The headline's key and projected value columns and its live mask
    (flag & v > 0 over its rows), from the root bench's data."""
    import torch
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    n, cap = HEADLINE_ROWS, HEADLINE_CAP
    keys, kv, vals, vv, flags = [torch.from_numpy(a).to(device)
                                 for a in queries.build_inputs(n, cap)]
    keep = (torch.arange(cap, device=device) < n) & flags & vv & (vals > 0)
    return (Column(dt.INT64, keys, kv),
            Column(dt.FLOAT64, vals * 2.0 + 1.0, vv), keep)


def check_k8(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import aggregates as A
    cap = 1 << 20
    n = cap - 555
    checks = 0
    floats = [make_column(rng, "double", cap, n, device),
              make_column(rng, "float", cap, n, device)]
    mask = (torch.rand(cap, device=device) < 0.6)
    for tname in KEY_TYPES:
        for case in ("rows", "mask", "device_count", "empty", "all_null",
                     "negative"):
            lo = -(1 << 40) if tname in ("bigint", "timestamp") else -700
            if tname == "tinyint":
                lo = -100
            key = key_column(rng, tname, cap, n, device, lo=lo, span=120,
                             null_frac=1.0 if case == "all_null" else 0.1)
            num_rows = 0 if case == "empty" else n
            if case == "device_count":
                num_rows = torch.tensor(n - 3, device=device)
            m = mask if case == "mask" else None
            got = A.dense_key_stats(key, num_rows, m, floats)
            want = A._dense_key_stats_torch(key, num_rows, m, floats)
            for g, w, part in zip(got, want, ("rmin", "decision")):
                if g.shape != w.shape or not torch.equal(
                        g.view(torch.int64) if g.is_floating_point() else g,
                        w.view(torch.int64) if w.is_floating_point() else w):
                    raise AssertionError(f"K8 {tname} {case} {part}: "
                                         f"{g.tolist()} vs {w.tolist()}")
            checks += 1
    # more float columns than one launch takes, and a repeated one
    key = key_column(rng, "bigint", cap, n, device)
    many = [make_column(rng, "double", cap, n, device) for _ in range(9)]
    many.append(many[0])
    got = A.dense_key_stats(key, n, None, many)[1]
    want = A._dense_key_stats_torch(key, n, None, many)[1]
    tensor_err(got.view(torch.int64), want.view(torch.int64),
               "K8 ten float columns")
    checks += 1
    out = {"name": "dense_stats", "checks": checks, "max_abs_err": 0.0,
           "tolerance": "exact (the same bits)"}
    # timings: the headline (the session's update reads the live mask, the
    # key and the one float column of SUM and AVG, with their validities;
    # key and value only where the row is live) and one 2^20-row batch
    kcol, proj, keep = headline_batch(device)
    for tag, rows, kc, pc, kp in (
            ("", HEADLINE_ROWS, kcol, proj, keep),
            ("_2p20", 1 << 20) + tuple(
                _prefix(c, 1 << 20) for c in (kcol, proj, keep))):
        cap_t = kc.capacity
        got = A.dense_key_stats(kc, rows, kp, [pc, pc])
        want = A._dense_key_stats_torch(kc, rows, kp, [pc, pc])
        tensor_err(got[0], want[0], f"K8 headline{tag} rmin")
        tensor_err(got[1].view(torch.int64), want[1].view(torch.int64),
                   f"K8 headline{tag} decision")
        usable = kp & kc.validity
        k0 = kc.data[int(usable.nonzero()[0])]
        out.update({
            f"ms{tag}": time_ms(lambda: A.dense_key_stats(kc, rows, kp,
                                                          [pc, pc])),
            f"plain_ms{tag}": time_ms(lambda: A._dense_key_stats_torch(
                kc, rows, kp, [pc, pc]), iters=5),
            f"library_ms{tag}": time_ms(lambda: torch.aminmax(
                torch.where(usable, kc.data, k0))),
            f"bound_ms{tag}": bound_ms(live_read_bytes(
                min(rows, cap_t), kp, kc, [pc]) + 8 + 4 * 8),
        })
    out["checks"] += 2
    return out


def _prefix(obj, rows: int):
    """The first ``rows`` rows of a column or mask, as their own arrays."""
    from spark_rapids_tpu_torch.columnar.column import Column
    if isinstance(obj, Column):
        return Column(obj.dtype, obj.data[:rows].clone(),
                      obj.validity[:rows].clone())
    return obj[:rows].clone()


def check_k9(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column, bucket
    from spark_rapids_tpu_torch.ops import aggregates as A
    cap = 1 << 20
    n = cap - 777
    checks = 0
    err = 0.0
    vals = [make_column(rng, t, cap, n, device) for t in SLOT_VALUE_TYPES]
    specs = _all_specs(A, vals)
    mask = (torch.rand(cap, device=device) < 0.7) & \
        (torch.arange(cap, device=device) < n)
    # every key type, negative keys, NULL keys, a live mask, a device count
    for tname in KEY_TYPES:
        lo = -100 if tname == "tinyint" else -700
        key = key_column(rng, tname, cap, n, device, lo=lo, span=120)
        for case, num_rows, m in (("rows", n, None), ("mask", n, mask),
                                  ("device_count",
                                   torch.tensor(n - 9, device=device), None)):
            rmin, dec = A.dense_key_stats(key, num_rows, m)
            K_slots = bucket(int(dec[0]) + 2, 128)
            src = ("key", key.data, key.validity, rmin)
            err = max(err, k9_against_twin(A, specs, src, K_slots, num_rows,
                                           m, cap, device,
                                           f"K9 {tname} {case}"))
            checks += 1
    key = key_column(rng, "bigint", cap, n, device)
    src = ("key", key.data, key.validity, torch.tensor(-700, device=device))
    # empty input and all-NULL keys
    err = max(err, k9_against_twin(A, specs, src, 1024, 0, None, cap,
                                   device, "K9 empty"))
    nul = Column(dt.INT64, key.data, torch.zeros_like(key.validity))
    err = max(err, k9_against_twin(
        A, specs, ("key", nul.data, nul.validity, src[3]), 128, n, None, cap,
        device, "K9 all-NULL keys"))
    checks += 2
    # the widest spans: 4094 and 4095 key slots plus the NULL slot in 4096
    for span in (4094, 4095):
        key = key_column(rng, "int", cap, n, device, lo=-2000, span=span)
        rmin, dec = A.dense_key_stats(key, n)
        assert int(dec[0]) + 2 <= A.DENSE_MAX_SLOTS
        err = max(err, k9_against_twin(
            A, specs, ("key", key.data, key.validity, rmin), 4096, n, None,
            cap, device, f"K9 {span} slots"))
        checks += 1
    # int64 sums that wrap, and a million-row hot slot
    big = np.where(rng.random(n) < 0.5, 3 * 10 ** 18, -(3 * 10 ** 18) + 7)
    wrap = Column.from_numpy(big, dt.INT64, capacity=cap, device=device)
    hot = np.where(np.arange(n) < 1_000_000, 5, rng.integers(0, 300, n))
    hkey = Column.from_numpy(hot, dt.INT64, capacity=cap, device=device)
    hsrc = ("key", hkey.data, hkey.validity, torch.tensor(0, device=device))
    err = max(err, k9_against_twin(A, [A.AggSpec("sum", wrap)] + specs, hsrc,
                                   512, n, None, cap, device,
                                   "K9 hot slot + wrapping sums"))
    checks += 1
    # the wrapped sums against numpy's int64 (mod 2^64) sums
    got = A.groupby_dense(hkey, [A.AggSpec("sum", wrap)], n, 512,
                          torch.tensor(0, device=device))
    ng = int(got[2])
    want = np.zeros(300, np.int64)
    np.add.at(want, hot, big.astype(np.int64))
    keys_got = got[0][0].data[:ng].cpu().numpy()
    if not np.array_equal(got[1][0].data[:ng].cpu().numpy(), want[keys_got]):
        raise AssertionError("K9 wrapping int64 sums differ from numpy")
    checks += 1
    # matmul-form sums over ids in any order (K4 needs runs: the reduce
    # must not take this call to it)
    ids = torch.from_numpy(rng.permutation(np.arange(cap) % 61).astype(
        np.int32)).to(device)
    live = torch.arange(cap, device=device) < n
    for s in (A.AggSpec("count_star", None), A.AggSpec("count", vals[2]),
              A.AggSpec("sum", vals[2]), A.AggSpec("avg", vals[3])):
        got = A.segment_aggregate_matmul(s, ids, live, 64)
        feats = A._Features()
        occ = feats.add("occ")
        plan = A._plan_spec(feats, s)
        want = A._assemble(s, plan, A._slot_features_torch(
            feats.items, ("ids", ids), live, 64), occ, 64, True)
        column_err(got, want, 1e-12, f"K9 shuffled ids {s.op}")
        checks += 1
    # the headline: sums against numpy (sequential f64), determinism
    kcol, proj, keep = headline_batch(device)
    hspecs = [A.AggSpec("sum", proj), A.AggSpec("count", proj),
              A.AggSpec("avg", proj)]
    rmin, _dec = A.dense_key_stats(kcol, HEADLINE_ROWS, keep)
    K_slots = 2048
    a = A.groupby_dense(kcol, hspecs, HEADLINE_ROWS, K_slots, rmin, keep)
    b = A.groupby_dense(kcol, hspecs, HEADLINE_ROWS, K_slots, rmin, keep)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        if not torch.equal(x.data.view(torch.int64) if x.data.dtype ==
                           torch.float64 else x.data,
                           y.data.view(torch.int64) if y.data.dtype ==
                           torch.float64 else y.data):
            raise AssertionError("K9 differs between two runs on one input")
    ng = int(a[2])
    sel = keep.cpu().numpy()
    kk = kcol.data.cpu().numpy()[sel]
    pp = proj.data.cpu().numpy()[sel]
    o_sum = np.bincount(kk, weights=pp, minlength=1024)
    o_cnt = np.bincount(kk, minlength=1024)
    gk = a[0][0].data[:ng].cpu().numpy()
    if not np.array_equal(a[1][1].data[:ng].cpu().numpy(), o_cnt[gk]):
        raise AssertionError("K9 headline counts differ from numpy")
    hs = a[1][0].data[:ng].cpu().numpy()
    rel = np.abs(hs - o_sum[gk]) / np.abs(o_sum[gk])
    if not (rel <= 1e-12).all():
        raise AssertionError(f"K9 headline sums: relative {rel.max()}")
    checks += 3
    out = {"name": "slot_aggregate", "checks": checks,
           "max_abs_err": max(err, float(np.abs(hs - o_sum[gk]).max())),
           "headline_sum_max_rel_err": float(rel.max()),
           "tolerance": "integers exact; f64 sums relative 1e-12 of the twin "
                        "and of numpy's sequential sums",
           "deterministic": True}
    # timings: the headline's features (occupancy, the count of p, the f64
    # sum of p) over 64M rows and one 2^20-row batch; the library call is
    # one index_add_ for the f64 feature
    for tag, rows, kc, pc, kp in (
            ("", HEADLINE_ROWS, kcol, proj, keep),
            ("_2p20", 1 << 20) + tuple(
                _prefix(c, 1 << 20) for c in (kcol, proj, keep))):
        feats = [A.SlotFeature("occ"), A.SlotFeature("cnt", None,
                                                     pc.validity),
                 A.SlotFeature("fsum", pc.data, pc.validity)]
        src = ("key", kc.data, kc.validity, rmin)
        live = A._live_mask(kc.capacity, rows, kp, device)
        seg = A._slot_ids_torch(src, live, K_slots)[0]
        contrib = torch.where(live & pc.validity, pc.data, 0.0)
        out.update({
            f"ms{tag}": time_ms(lambda: A.slot_features(feats, src, K_slots,
                                                        rows, kp)),
            f"plain_ms{tag}": time_ms(lambda: A._slot_features_torch(
                feats, src, live, K_slots), iters=5),
            f"library_ms{tag}": time_ms(lambda: torch.zeros(
                K_slots, dtype=torch.float64, device=device).index_add_(
                    0, seg, contrib)),
            f"bound_ms{tag}": bound_ms(live_read_bytes(
                min(rows, kc.capacity), kp, kc, [pc]) + 3 * K_slots * 8),
        })
    return out


def check_k10(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.ops import aggregates as A
    cap = 1 << 20
    n = cap - 333
    checks = 0
    mask = torch.rand(cap, device=device) < 0.8
    for tname in KEY_TYPES:
        for case in ("rows", "mask", "device_count", "empty", "all_null"):
            lo = -100 if tname == "tinyint" else -3000
            key = key_column(rng, tname, cap, n, device, lo=lo,
                             span=120 if tname == "tinyint" else 4000,
                             null_frac=1.0 if case == "all_null" else 0.1)
            num_rows = 0 if case == "empty" else n
            if case == "device_count":
                num_rows = torch.tensor(n - 5, device=device)
            m = mask if case == "mask" else None
            uniq = torch.unique(key.data[key.validity].to(torch.int64))
            uniq = uniq[::max(1, uniq.numel() // 4000)][:4096].contiguous()
            nu = uniq.numel()
            got = A.singleword_rank(key, uniq, num_rows, m, nu, nu + 1)
            want = A._singleword_rank_torch(key, uniq, num_rows, m, nu,
                                            nu + 1)
            tensor_err(got, want, f"K10 {tname} {case}")
            checks += 1
    # groupby_singleword on the card at 2^20 rows: the phase that launches
    # K10 (no engine path calls the single-word route)
    key = key_column(rng, "bigint", cap, n, device, lo=-(1 << 40), span=3000)
    val = make_column(rng, "double", cap, n, device, nan_frac=0.0)
    before = native.counts()["singleword_rank"]
    res = A.groupby_singleword(key, [A.AggSpec("count", val),
                                     A.AggSpec("sum", val)], n, cap)
    launches = native.counts()["singleword_rank"] - before
    ks, ag, ng = res
    kv = key.data[:n].cpu().numpy()
    valid = key.validity[:n].cpu().numpy()
    uk = np.unique(kv[valid])
    if ng != len(uk) + 1 or not np.array_equal(
            ks[0].data[:len(uk)].cpu().numpy(), uk):
        raise AssertionError("K10 groupby_singleword keys differ from numpy")
    vv = val.validity[:n].cpu().numpy()
    cnt_v = np.bincount(np.searchsorted(uk, kv[valid & vv]),
                        minlength=len(uk))
    if not np.array_equal(ag[0].data[:len(uk)].cpu().numpy(), cnt_v):
        raise AssertionError("K10 groupby_singleword counts differ")
    checks += 2
    uniq = torch.from_numpy(uk).to(device)
    out = {"name": "singleword_rank", "checks": checks, "max_abs_err": 0.0,
           "tolerance": "exact", "phase_launches": launches,
           "groups": ng}
    kcol, _proj, _keep = headline_batch(device)
    huniq = torch.arange(1024, dtype=torch.int64, device=device)
    for tag, rows, kc, uq in (("", HEADLINE_ROWS, kcol, huniq),
                              ("_2p20", cap, key, uniq)):
        got = A.singleword_rank(kc, uq, rows, None, uq.numel(), uq.numel())
        lib = torch.searchsorted(uq, kc.data)
        live = (torch.arange(kc.capacity, device=device) < rows) & \
            kc.validity
        if not torch.equal(got[live].to(torch.int64), lib[live]):
            raise AssertionError("K10 disagrees with torch.searchsorted")
        out.update({
            f"ms{tag}": time_ms(lambda: A.singleword_rank(
                kc, uq, rows, None, uq.numel(), uq.numel())),
            f"plain_ms{tag}": time_ms(lambda: A._singleword_rank_torch(
                kc, uq, rows, None, uq.numel(), uq.numel()), iters=3,
                warmup=1),
            f"library_ms{tag}": time_ms(lambda: torch.searchsorted(
                uq, kc.data)),
            # key and validity read, an int32 written per row
            f"bound_ms{tag}": bound_ms(min(rows, kc.capacity) * 13 +
                                       uq.numel() * 8),
        })
    return out


HASH_TYPES = ("tinyint", "smallint", "int", "bigint", "date", "timestamp",
              "boolean", "float", "double", "string")
# Spark's own values (tests/test_strings.py): hash(x) with seed 42
SPARK_HASHES = (("int", 0, 933211791), ("int", 42, 29417773),
                ("int", -1, -1604776387), ("bigint", 0, -1670924195),
                ("bigint", 42, 1316951768), ("string", "", 142593372),
                ("string", "abc", 1322437556))
# NaN bit patterns: the canonical one, x86's 0.0/0.0 and a signalling one
NAN_BITS = {"double": (0x7FF8000000000000, 0xFFF8000000000000,
                       0x7FF0000000000001),
            "float": (0x7FC00000, 0xFFC00000, 0x7F800001)}


def hash_column(rng, tname: str, cap: int, n: int, device, width: int = 16):
    """A key column of ``tname`` over n live rows: 10% NULL; floats with
    -0.0, +-inf and NaN in the three bit patterns; strings of 0 to
    ``width`` random bytes (any byte value, so tails hold bytes >= 0x80)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    t = dt.of(tname)
    valid = rng.random(n) >= 0.1
    if t == dt.STRING:
        lens = rng.integers(0, width + 1, n).astype(np.int32)
        data = rng.integers(0, 256, (n, width)).astype(np.uint8)
        data[np.arange(width)[None, :] >= lens[:, None]] = 0
        return Column(dt.STRING, *[torch.from_numpy(a).to(device) for a in (
            np.pad(data * valid[:, None], ((0, cap - n), (0, 0))),
            np.pad(valid, (0, cap - n)),
            np.pad(lens * valid, (0, cap - n)))])
    if t == dt.BOOL:
        vals = rng.integers(0, 2, n).astype(np.bool_)
    elif t.is_floating:
        vals = rng.normal(0, 1e3, n).astype(t.numpy_dtype)
        bits_t = np.uint64 if tname == "double" else np.uint32
        special = np.concatenate([
            np.array(NAN_BITS[tname], bits_t).view(t.numpy_dtype),
            np.array([0.0, -0.0, np.inf, -np.inf], t.numpy_dtype)])
        pick = rng.random(n) < 0.2
        vals[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    else:
        info = np.iinfo(t.numpy_dtype)
        vals = rng.integers(info.min, info.max, n, endpoint=True,
                            dtype=t.numpy_dtype)
    return Column.from_numpy(vals, t, valid, capacity=cap, device=device)


def string_read_bytes(col, rows: int) -> int:
    """Bytes a string-hashing pass must read: the 32-byte sectors holding a
    byte inside some row's length, its lengths and its validity."""
    import torch
    w = int(col.data.shape[1])
    lens = col.lengths[:rows].to(torch.int64) * col.validity[:rows]
    if w <= 32:
        rows_idx = torch.nonzero(lens > 0).flatten()
        sectors = int(torch.unique(rows_idx * w // 32).numel())
    else:
        sectors = int(((lens + 31) // 32).sum())
    return 32 * sectors + rows * 5


def check_k11(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops import hashing as H
    checks = 0

    def both(cols, cap, seed, n_parts, rows, what):
        got = H.murmur3(cols, cap, seed, n_parts, rows)
        want = H._murmur3_torch(cols, cap, seed, n_parts, rows)
        tensor_err(got[0], want[0], f"K11 hash {what}")
        if n_parts:
            tensor_err(got[1], want[1], f"K11 pid {what}")
        return got[0]

    for cap, n in ((128, 100), (5000, 4999), (1 << 20, (1 << 20) - 4321)):
        cols = {t: hash_column(rng, t, cap, n, device) for t in HASH_TYPES}
        cols["string8"] = hash_column(rng, "string", cap, n, device, 8)
        for name, c in cols.items():
            for n_parts in (0, 1, 3, 8, 200):
                both([c], cap, 42, n_parts, n, f"{name} n={n_parts} "
                     f"cap={cap}")
                checks += 1
        names = list(cols)
        for k in (2, 3):
            for _ in range(6):
                pick = [names[i] for i in rng.choice(len(names), k)]
                both([cols[x] for x in pick], cap, 42, 8,
                     torch.tensor(n - 7, device=device),
                     f"chain {pick} cap={cap}")
                checks += 1
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31, cap,
                                              dtype=np.int32)).to(device)
        both([cols["string"]], cap, seeds, 0, n, f"per-row seeds cap={cap}")
        checks += 1
    for tname, value, want in SPARK_HASHES:
        col = Column.from_numpy(np.array([value], dtype=object if
                                         tname == "string" else None),
                                dt.of(tname), device=device)
        got = int(H.murmur3_batch([col], col.capacity)[0])
        if got != want:
            raise AssertionError(f"K11 hash({tname} {value!r}) = {got}, "
                                 f"Spark {want}")
        checks += 1
    for tname, bits in NAN_BITS.items():
        t = dt.of(tname)
        vals = np.array(bits, np.uint64 if tname == "double"
                        else np.uint32).view(t.numpy_dtype)
        h = H.murmur3_batch([Column.from_numpy(vals, t, device=device)],
                            128)[:3].tolist()
        if len(set(h)) != 1 or (tname == "double" and h[0] != -1281358385):
            raise AssertionError(f"K11 NaN {tname} hashes differ: {h}")
        checks += 1
    out = {"name": "murmur3", "checks": checks, "max_abs_err": 0.0,
           "tolerance": "exact (hash and partition id, bit for bit; "
                        "Spark's values)"}
    # the main path's shapes: q3's int64 order key and q12's string ship
    # mode over one 2^20-row batch into 8 partitions (the ids only)
    cap = 1 << 20
    rows = cap - 4321
    okey = Column.from_numpy(rng.integers(1, 60_000_001, rows), dt.INT64,
                             capacity=cap, device=device)
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"])[rng.integers(0, 7, rows)]
    smode = Column.from_numpy(modes, dt.STRING, capacity=cap, device=device)
    for tag, col, read in (("", okey, rows * 9),
                           ("_string", smode, string_read_bytes(smode, rows))):
        both([col], cap, 42, 8, rows, f"main-path shape{tag}")
        out.update({
            f"ms{tag}": time_ms(lambda: H.murmur3([col], cap, 42, 8, rows,
                                                  want_hash=False)),
            f"plain_ms{tag}": time_ms(lambda: H._murmur3_torch(
                [col], cap, 42, 8, rows)),
            f"library_ms{tag}": None,
            # the key read, a 4-byte id written per row
            f"bound_ms{tag}": bound_ms(read + cap * 4)})
    out["string_width"] = int(smode.data.shape[1])
    out["library"] = "none: no PyTorch call computes murmur3"
    return out


def check_k12(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.shuffle import partitioning as P
    checks = 0

    def library(pids, rows, n):
        live = torch.arange(pids.shape[0], device=pids.device) < rows
        bins = torch.where(live, pids.to(torch.int64), n)
        return (torch.sort(bins, stable=True)[1],
                torch.bincount(bins, minlength=n + 1)[:n].to(torch.int32))

    for cap in (128, 5000, 1 << 20):
        for n in (1, 2, 3, 8, 200, 4096):
            for case in ("random", "one_partition", "padding", "empty"):
                if case == "one_partition":
                    pids = torch.full((cap,), n // 2, dtype=torch.int32,
                                      device=device)
                else:
                    pids = torch.randint(0, n, (cap,), dtype=torch.int32,
                                         device=device)
                rows = {"padding": cap - cap // 3, "empty": 0}.get(case, cap)
                if case == "padding":     # ids past the rows are ignored
                    pids[rows:] = -5
                    rows = torch.tensor(rows, device=device)
                got = P.partition_split(pids, rows, n)
                again = P.partition_split(pids, rows, n)
                want = P._partition_split_torch(pids, rows, n)
                lib = library(torch.clamp(pids, 0, n), rows, n)
                for g, a, w, l, what in zip(got, again, want, lib,
                                            ("perm", "counts")):
                    tag = f"K12 {what} {case} n={n} cap={cap}"
                    tensor_err(g, w, tag)
                    tensor_err(g, l, tag + " vs sort + bincount")
                    tensor_err(g, a, tag + " (two calls)")
                checks += 1
    cap, n = 1 << 20, 8
    rows = cap - 4321
    pids = torch.randint(0, n, (cap,), dtype=torch.int32, device=device)
    return {
        "name": "partition_split", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (permutation and counts; deterministic)",
        "ms": time_ms(lambda: P.partition_split(pids, rows, n)),
        "plain_ms": time_ms(lambda: P._partition_split_torch(pids, rows, n)),
        "library_ms": time_ms(lambda: library(pids, rows, n)),
        # 4-byte ids read, the 8-byte permutation and the counts written
        "bound_ms": bound_ms(cap * (4 + 8) + n * 4),
    }


# -- K7's outer mode, K13-K15: outer and cross joins, pattern search ----------

# q13's join at SF 10 on the shuffled plan: one of 8 hash partitions joins
# ~190 K customer rows (the stream side) against ~1.9 M filtered order rows
# (the build side); keys are customer keys
Q13_STREAM_ROWS, Q13_STREAM_CAP = 190_000, 1 << 18
Q13_BUILD_ROWS, Q13_BUILD_CAP = 1_900_000, 1 << 21


def _q13_partition(rng, device):
    """(build key column, stream key column) shaped as one partition of
    q13's join: distinct customer keys with 1% NULL and dead rows past
    them; order keys drawn from them, multiples of 3 moved up by one (as
    datagen does, so those customers have no order), 1% NULL."""
    cust = rng.choice(np.arange(1, 1_500_001), Q13_STREAM_ROWS,
                      replace=False)
    ck = cust[rng.integers(0, len(cust), Q13_BUILD_ROWS)]
    ck = np.where(ck % 3 == 0, ck + 1, ck)
    return (_key_column(ck, rng.random(Q13_BUILD_ROWS) > 0.01,
                        Q13_BUILD_CAP, device),
            _key_column(cust, rng.random(Q13_STREAM_ROWS) > 0.01,
                        Q13_STREAM_CAP, device))


def check_k7_outer(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.columnar.column import bucket
    from spark_rapids_tpu_torch.ops import joins as J
    checks = 0
    for name, bk, nb, sk, ns in _join_key_cases(rng, device):
        m = J.join_match(bk, nb, sk, ns, sk[0].capacity)
        out_cap = bucket(max(sum(m.totals.tolist()), 1))
        _expand_err(J._expand_indices(m, out_cap, True, ns),
                    J._expand_indices_torch(m, out_cap, True, ns),
                    f"K7 outer {name}")
        checks += 1
    # the main path's shape: one partition of q13's left join
    bcol, scol = _q13_partition(rng, device)
    ns = Q13_STREAM_ROWS
    m = J.join_match([bcol], Q13_BUILD_ROWS, [scol], ns, Q13_STREAM_CAP)
    pairs, lonely = m.totals.tolist()
    rows = pairs + lonely
    out_cap = bucket(rows)
    got = J._expand_indices(m, out_cap, True, ns)
    err = _expand_err(got, J._expand_indices_torch(m, out_cap, True, ns),
                      "K7 outer q13")
    if int((got[1][:rows] == -1).sum()) != lonely or lonely == 0:
        raise AssertionError("K7 outer: unmatched rows differ from K6's")
    idx = torch.arange(Q13_STREAM_CAP, device=device)
    live_rows = idx < ns

    def library():
        return torch.repeat_interleave(
            idx, torch.where(live_rows, m.count.clamp(min=1), 0),
            output_size=rows)
    if not torch.equal(library(), got[0][:rows]):
        raise AssertionError("K7 outer disagrees with repeat_interleave")
    return {
        "name": "join_expand_outer", "checks": checks + 2,
        "max_abs_err": err, "tolerance": "exact (indices)",
        "pairs": pairs, "unmatched_stream_rows": lonely,
        "out_capacity": out_cap,
        "ms": time_ms(lambda: J._expand_indices(m, out_cap, True, ns)),
        "plain_ms": time_ms(lambda: J._expand_indices_torch(
            m, out_cap, True, ns)),
        "library_ms": time_ms(library),
        # count and lo of each live stream row read, one order entry per
        # pair read, two int64 indices per output row and the total written
        "bound_ms": bound_ms(ns * (4 + 4) + pairs * 8 + rows * 16 + 8),
    }


def check_k14(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import joins as J
    checks = 0
    for name, bk, nb, sk, ns in _join_key_cases(rng, device):
        m = J.join_match(bk, nb, sk, ns, sk[0].capacity)
        bcap = m.build_order.shape[0]
        tensor_err(J.build_matched(m.lo, m.count, nb, bcap),
                   J._build_matched_torch(m.lo, m.count, nb, bcap),
                   f"K14 {name}")
        checks += 1
    bcol, scol = _q13_partition(rng, device)
    nb, ns = Q13_BUILD_ROWS, Q13_STREAM_ROWS
    m = J.join_match([bcol], nb, [scol], ns, Q13_STREAM_CAP,
                     with_build_matched=True)
    got = m.build_matched
    err = tensor_err(got, J._build_matched_torch(m.lo, m.count, nb,
                                                 Q13_BUILD_CAP), "K14 q13")
    # numpy: a build row is matched when its key is a live stream key
    bk = bcol.data[:nb].cpu().numpy()
    bv = bcol.validity[:nb].cpu().numpy()
    sk = scol.data[:ns].cpu().numpy()[scol.validity[:ns].cpu().numpy()]
    want = int((bv & np.isin(bk, sk)).sum())
    if int(got.sum()) != want:
        raise AssertionError(f"K14: {int(got.sum())} matched build rows, "
                             f"numpy {want}")
    _cols, ucnt = J.unmatched_build_gather(m, [bcol], nb)
    if int(ucnt) != nb - want:
        raise AssertionError("K14: unmatched build rows differ from numpy")
    has = m.count > 0
    start = m.lo.to(torch.int64)[has]
    end = start + m.count.to(torch.int64)[has]
    one = torch.ones(start.shape[0], dtype=torch.int32, device=device)

    def library():
        d = torch.zeros(Q13_BUILD_CAP + 1, dtype=torch.int32, device=device)
        d.index_add_(0, start, one)
        d.index_add_(0, end, -one)
        return torch.cumsum(d[:-1], 0) > 0
    if not torch.equal(library() & (torch.arange(
            Q13_BUILD_CAP, device=device) < nb), got):
        raise AssertionError("K14 disagrees with index_add_ + cumsum")
    return {
        "name": "build_matched", "checks": checks + 4, "max_abs_err": err,
        "tolerance": "exact (flags, counts)", "matched": want,
        "ms": time_ms(lambda: J.build_matched(m.lo, m.count, nb,
                                              Q13_BUILD_CAP)),
        "plain_ms": time_ms(lambda: J._build_matched_torch(
            m.lo, m.count, nb, Q13_BUILD_CAP)),
        "library_ms": time_ms(library),
        # lo and count of each live stream row read, one flag per build
        # slot written
        "bound_ms": bound_ms(ns * (4 + 4) + Q13_BUILD_CAP),
    }


# K15's main-path shapes (n_left, n_right, out_capacity) at SF 10, as the
# counted run records them: q11's one launch, q15's largest partition
K15_Q11_SHAPE = (308_000, 1, 1 << 19)
K15_Q15_SHAPE = (12_678, 1, 1 << 14)


def _k15_against_twin(device, nl: int, nr: int, cap: int, what: str):
    from spark_rapids_tpu_torch.ops import joins as J
    got = J.cross_expand(nl, nr, cap, device)
    for g, w, name in zip(got, J._cross_expand_torch(nl, nr, cap, device),
                          ("left", "right", "total")):
        tensor_err(g, w, f"K15 {what} {nl}x{nr} in {cap} {name}")
    return got


def k15_timing(device, nl: int, nr: int, cap: int) -> dict:
    """K15's wrapper, its twin and floor division + remainder (their
    arange and divisor made outside the timed call) at one shape."""
    import torch
    from spark_rapids_tpu_torch.ops import joins as J
    ar = torch.arange(cap, device=device)
    nr_t = torch.tensor(nr, device=device)

    def library():
        return (torch.div(ar, nr_t, rounding_mode="floor"),
                torch.remainder(ar, nr_t))
    # tens of microseconds of host time each: 200 calls a median, the
    # kernel and the library call in turns
    ms, library_ms = time_pair_ms(
        lambda: J.cross_expand(nl, nr, cap, device), library, 200)
    return {"n_left": nl, "n_right": nr, "out_capacity": cap, "ms": ms,
            "plain_ms": time_ms(lambda: J._cross_expand_torch(
                nl, nr, cap, device), 100),
            "library_ms": library_ms,
            # two int64 indices per output slot and the total written
            "bound_ms": bound_ms(cap * 16 + 8)}


def check_k15(device, rng) -> dict:
    """K15 against its twin at the edge cases (empty sides, one slot, the
    smallest capacities, products that are not a multiple of a block; an
    odd capacity refused) and at right sides whose divisor takes the
    multiply-high with and without its add step, then with host-int counts
    under the synchronize detector, and timed at q11's and q15's main-path
    shapes. Its recorded main-path
    shapes are checked again by :func:`check_k15_main` once the counted
    run has given them."""
    from spark_rapids_tpu_torch.columnar.column import bucket
    from spark_rapids_tpu_torch.ops import joins as J
    usage = ptxas_usage("cross_expand")
    checks = 0
    for nl, nr in ((0, 5), (5, 0), (0, 0), (1, 1), (7, 130), (130, 7),
                   (1000, 1000), (1, 1 << 20), (1 << 20, 1), (3, 3),
                   (4097, 641), (1 << 12, (1 << 12) + 1)):
        _k15_against_twin(device, nl, nr, bucket(max(nl * nr, 1)), "edge")
        checks += 1
    # right sides of 2^31 - 1 and 2^32 - 1 rows (multiply-high), 2^32 rows
    # (the 64-bit branch), over 2^20 live slots
    for nl, nr in ((2, (1 << 31) - 1), (1, (1 << 32) - 1), (1, 1 << 32)):
        _k15_against_twin(device, nl, nr, 1 << 20, "wide right side")
        checks += 1
    for cap in (2, 4, 130):
        _k15_against_twin(device, 2, 63, cap, "small capacity")
        checks += 1
    try:
        J.cross_expand(2, 63, 129, device)
    except ValueError:
        checks += 1
    else:
        raise AssertionError("K15 took an odd capacity")
    # numerators past 2^31: the multiply-high over a slot count near 2^32
    # is checked in tests (``_fast_divisor``); here n_right in 1..64 and
    # random ones over 2^20 slots
    for nr in list(range(1, 65)) + [int(x) for x in
                                    rng.integers(65, 1 << 20, 16)]:
        _k15_against_twin(device, -(-(1 << 20) // nr) + 3, nr, 1 << 20,
                          "divisor")
        checks += 1
    sync_detector_works(device)
    with no_sync():
        J.cross_expand(*K15_Q11_SHAPE, device)
        J.cross_expand(4097, 641, 1 << 22, device)
    checks += 2
    q11 = k15_timing(device, *K15_Q11_SHAPE)
    return {"name": "cross_expand", "checks": checks, "max_abs_err": 0.0,
            "tolerance": "exact (indices, total)", "no_sync": True,
            "ptxas": usage, **{k: q11[k] for k in ("ms", "plain_ms",
                                                   "library_ms",
                                                   "bound_ms")},
            "timed_at": {"q11": q11,
                         "q15": k15_timing(device, *K15_Q15_SHAPE)}}


def check_k15_main(device, shapes: dict) -> dict:
    """K15 at the shapes the counted run gave it: every (n_left, n_right,
    out_capacity) of q11's and q15's cold runs held to the twin bit for
    bit and to floor division + remainder; timed at q11's one launch (all
    its per-part sums against the threshold row) and at q15's largest
    partition (its supplier-join rows against the max row)."""
    import torch
    checks, timed = 0, {}
    for query, calls in shapes.items():
        for nl, nr, cap in calls:
            got = _k15_against_twin(device, nl, nr, cap, query)
            ar = torch.arange(cap, device=device)
            lib = (torch.div(ar, nr, rounding_mode="floor"),
                   torch.remainder(ar, nr))
            if not (torch.equal(lib[0][:nl * nr], got[0][:nl * nr]) and
                    torch.equal(lib[1][:nl * nr], got[1][:nl * nr])):
                raise AssertionError(f"K15 {query} disagrees with floor "
                                     "division and remainder")
            checks += 2
        timed[query] = k15_timing(device, *max(calls))
    return {"name": "cross_expand", "main_path_checks": checks,
            "shapes": {q: [list(c) for c in calls]
                       for q, calls in shapes.items()},
            **{k: timed["q11"][k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms")},
            "timed_at": timed}


COMMENT_WIDTH = 32


def _comments(rng, n: int, cap: int, device, null_frac: float = 0.0):
    """An o_comment column as datagen's gen_orders draws it (two of its
    words), in a 32-byte bucket."""
    from benchmarks import datagen
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    w = np.array(datagen._COMMENT_WORDS)
    vals = np.char.add(np.char.add(w[rng.integers(0, len(w), n)], " "),
                       w[rng.integers(0, len(w), n)])
    return Column.from_numpy(vals, dt.STRING, rng.random(n) >= null_frac,
                             capacity=cap, device=device,
                             width=COMMENT_WIDTH)


K13_PATTERNS = ("special", "requests", "", "s", "é", "spécial",
                "x" * COMMENT_WIDTH, "x" * (COMMENT_WIDTH + 1),
                "quickly final")


def check_k13(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops import expressions as E
    from spark_rapids_tpu_torch.ops import strings as S
    cap = 1 << 20
    n = cap - 1234
    col = _comments(rng, n, cap, device)
    w = COMMENT_WIDTH
    # junk bytes past every length
    pos = torch.arange(w, device=device)[None, :]
    junk = torch.randint(1, 256, (cap, w), dtype=torch.uint8, device=device)
    junked = torch.where(pos >= col.lengths[:, None], junk, col.data)
    # UTF-8 rows, rows exactly W bytes wide and one byte short, a match
    # ending exactly at the length and one ending a byte past it
    edge = ["spécial requests", "é", "x" * w, "x" * (w - 1), "requests",
            "xx requests", "", "special"]
    ecol = Column.from_numpy(np.array(edge), dt.STRING, capacity=128,
                             device=device, width=w)
    elen = ecol.lengths.clone()
    elen[5] = 10                       # "xx request": the match is cut
    checks = 0
    for data, lengths, what in ((col.data, col.lengths, "o_comment"),
                                (junked.contiguous(), col.lengths, "junk"),
                                (ecol.data, ecol.lengths, "edge rows"),
                                (ecol.data, elen, "cut lengths")):
        for p in K13_PATTERNS:
            pat = torch.tensor(list(p.encode("utf-8")), dtype=torch.uint8,
                               device=device)
            for mode in (S.FIRST, S.PREFIX, S.SUFFIX):
                tensor_err(S.find_pattern(data, lengths, pat, mode),
                           S._find_pattern_torch(data, lengths, pat, mode),
                           f"K13 {what} {p!r} mode {mode}")
                checks += 1
    got = S.find_pattern(ecol.data, elen, torch.tensor(
        list(b"requests"), dtype=torch.uint8, device=device), S.FIRST)
    if got[:8].tolist() != [9, -1, -1, -1, 0, -1, -1, -1]:
        raise AssertionError(f"K13 edge rows: {got[:8].tolist()}")
    # the predicates over a batch with NULL rows and dead rows
    ncol = _comments(rng, n, cap, device, null_frac=0.1)
    batch = ColumnarBatch(dt.Schema([dt.Field("c", dt.STRING)]), [ncol], n)
    live = torch.arange(cap, device=device) < n
    for cls, mode in ((S.Contains, S.FIRST), (S.StartsWith, S.PREFIX),
                      (S.EndsWith, S.SUFFIX)):
        out = cls(E.BoundReference(0, dt.STRING, True, "c"),
                  E.Literal("special", dt.STRING)).eval(batch)
        want_pos = S._find_pattern_torch(ncol.data, ncol.lengths, torch.tensor(
            list(b"special"), dtype=torch.uint8, device=device), mode)
        valid = ncol.validity & live
        tensor_err(out.validity, valid, f"K13 {cls.__name__} validity")
        tensor_err(out.data, (want_pos >= 0) & valid,
                   f"K13 {cls.__name__} data")
        checks += 1
    pat = torch.tensor(list(b"special"), dtype=torch.uint8, device=device)
    return {
        "name": "find_pattern", "checks": checks + 1, "max_abs_err": 0.0,
        "tolerance": "exact (positions)", "rows": n, "width": w,
        "ms": time_ms(lambda: S.find_pattern(col.data, col.lengths, pat)),
        "plain_ms": time_ms(lambda: S._find_pattern_torch(
            col.data, col.lengths, pat, S.FIRST)),
        "library_ms": None,            # no single PyTorch call computes it
        # the byte rows and lengths read, an int32 per row written
        "bound_ms": bound_ms(cap * (w + 4) + cap * 4),
    }


# -- K13's locate mode, K16-K18: string expressions ---------------------------

# characters of 1 to 4 UTF-8 bytes, spaces among them (the trims)
UTF8_POOL = ("a", "b", "l", "x", "Z", " ", "-", "é", "ß", "漢", "€", "😀",
             "𝄞")
STRING_WIDTHS = (8, 16, 32, 64, 256)
# c_phone's bucket (15 bytes): q22's substring batch
PHONE_WIDTH = 16


def utf8_rows(rng, n: int, cap: int, w: int, device, null_frac=0.1):
    """A string column of ``cap`` rows of width ``w``: the first ``n``
    random UTF-8 strings of 1-4-byte characters up to ``w`` bytes, some
    starting with continuation bytes, ``null_frac`` NULL (length 0); junk
    bytes past every length; the dead rows past ``n`` junk with random
    lengths and invalid."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    data = rng.integers(1, 256, (cap, w)).astype(np.uint8)
    lengths = rng.integers(0, w + 1, cap).astype(np.int32)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= null_frac
    pool = [c.encode("utf-8") for c in UTF8_POOL]
    for i in range(n):
        if not valid[i]:
            lengths[i] = 0
            continue
        limit = int(rng.integers(0, w + 1))
        b = bytearray()
        if rng.random() < 0.05:
            b.append(0x80 | int(rng.integers(0, 64)))
        for k in rng.integers(0, len(pool), w):
            c = pool[k]
            if len(b) + len(c) > limit:
                break
            b += c
        data[i, :len(b)] = np.frombuffer(bytes(b), np.uint8)
        lengths[i] = len(b)
    return Column(dt.STRING, torch.from_numpy(data).to(device),
                  torch.from_numpy(valid).to(device),
                  torch.from_numpy(lengths).to(device))


def phone_batch(device):
    """One 2^20-row batch of c_phone as datagen's gen_customer draws it
    (SF 10's 1.5 M customers come in two), in its 16-byte bucket."""
    from benchmarks import datagen
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    cap = 1 << 20
    phones = datagen.gen_customer(7.0)["c_phone"][:cap]
    return Column.from_numpy(phones, dt.STRING, capacity=cap, device=device,
                             width=PHONE_WIDTH)


def _string_cols_err(got, want, what: str) -> float:
    for g, w, part in zip(got, want, ("bytes", "lengths", "validity")):
        tensor_err(g, w, f"{what} {part}")
    return 0.0


def check_k16(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import strings as S
    checks = 0
    for w in STRING_WIDTHS:
        col = utf8_rows(rng, 3000, 4096, w, device)
        for mode in (S.LENGTH, S.UPPER, S.LOWER, S.INITCAP):
            tensor_err(S.string_map(col.data, col.lengths, col.validity,
                                    mode),
                       S._string_map_torch(col.data, col.lengths,
                                           col.validity, mode),
                       f"K16 w={w} mode {mode}")
            checks += 1
    cap = 1 << 20
    col = _comments(rng, cap - 1234, cap, device, null_frac=0.05)
    for mode in (S.LENGTH, S.UPPER, S.INITCAP):
        tensor_err(S.string_map(col.data, col.lengths, col.validity, mode),
                   S._string_map_torch(col.data, col.lengths, col.validity,
                                       mode), f"K16 o_comment mode {mode}")
        checks += 1
    w = COMMENT_WIDTH
    return {
        "name": "string_map", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (bytes, counts)", "rows": cap, "width": w,
        "timed": "UPPER over one 2^20-row batch of o_comment",
        "ms": time_ms(lambda: S.string_map(col.data, col.lengths,
                                           col.validity, S.UPPER)),
        "plain_ms": time_ms(lambda: S._string_map_torch(
            col.data, col.lengths, col.validity, S.UPPER)),
        "ms_length": time_ms(lambda: S.string_map(
            col.data, col.lengths, col.validity, S.LENGTH)),
        "library_ms": None,        # no single PyTorch call computes it
        # the byte rows read and written once
        "bound_ms": bound_ms(2 * cap * w),
    }


# (pos, length) pairs of the substring checks: positive, zero and negative
# positions (one past the start of the string: Spark's end-first rule),
# a negative and an over-long length
SUBSTRING_ARGS = ((1, 2), (0, 3), (2, 5), (-3, 2), (-20, 12), (2, -1),
                  (3, 1000))


def check_k17(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import strings as S
    checks = 0
    for w in STRING_WIDTHS:
        col = utf8_rows(rng, 3000, 4096, w, device)
        n = col.capacity
        pos_t = torch.randint(-12, 13, (n,), dtype=torch.int32, device=device)
        len_t = torch.randint(-2, 14, (n,), dtype=torch.int32, device=device)
        cases = [(S.SUBSTRING, p, l) for p, l in SUBSTRING_ARGS]
        cases += [(S.SUBSTRING, pos_t, 3), (S.SUBSTRING, 2, len_t),
                  (S.SUBSTRING, pos_t, len_t)]
        cases += [(m, 0, 0) for m in (S.TRIM, S.LTRIM, S.RTRIM)]
        for mode, p, l in cases:
            for valid in (col.validity, None):
                _string_cols_err(
                    S.string_slice(col.data, col.lengths, valid, mode, p, l),
                    S._string_slice_torch(col.data, col.lengths, valid, mode,
                                          p, l),
                    f"K17 w={w} mode {mode}")
                checks += 1
    col = phone_batch(device)
    cap = col.capacity
    args = (col.data, col.lengths, col.validity, S.SUBSTRING, 1, 2)
    _string_cols_err(S.string_slice(*args), S._string_slice_torch(*args),
                     "K17 c_phone")
    w = PHONE_WIDTH
    return {
        "name": "string_slice", "checks": checks + 1, "max_abs_err": 0.0,
        "tolerance": "exact (bytes, lengths)", "rows": cap, "width": w,
        "timed": "substring(c_phone, 1, 2) over one 2^20-row batch (q22)",
        "ms": time_ms(lambda: S.string_slice(*args)),
        "plain_ms": time_ms(lambda: S._string_slice_torch(*args), iters=5),
        "library_ms": None,        # no single PyTorch call computes it
        # rows, lengths and validity read; rows and lengths written
        "bound_ms": bound_ms(cap * (w + 4 + 1) + cap * (w + 4)),
    }


def check_k18(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import strings as S
    checks = 0

    def scalar(s: str):
        b = s.encode("utf-8")
        w = max(8, 1 << (max(len(b), 1) - 1).bit_length())
        row = torch.zeros((1, w), dtype=torch.uint8, device=device)
        if b:
            row[0, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
        return (row, torch.tensor([len(b)], dtype=torch.int32, device=device),
                torch.ones(1, dtype=torch.bool, device=device))

    null = scalar("")
    null = (null[0], null[1], torch.zeros(1, dtype=torch.bool,
                                          device=device))
    for w in STRING_WIDTHS:
        a = utf8_rows(rng, 3000, 4096, w, device)
        b = utf8_rows(rng, 3000, 4096, min(2 * w, 256), device, 0.3)
        n = a.capacity
        ca = (a.data, a.lengths, a.validity)
        cb = (b.data, b.lengths, b.validity)
        for ops in ([ca, scalar("-"), cb], [scalar("ü:"), ca], [ca, null],
                    [ca], [cb, ca, cb, scalar("𝄞")]):
            out_w = 1 << (sum(o[0].shape[1] for o in ops) - 1).bit_length()
            _string_cols_err(S.string_place(ops, n, out_w, S.CONCAT),
                             S._string_place_torch(ops, n, out_w, S.CONCAT,
                                                   0, torch.zeros(
                                                       0, dtype=torch.uint8,
                                                       device=device)),
                             f"K18 concat w={w}")
            checks += 1
        for mode in (S.LPAD, S.RPAD):
            for target in (-1, 0, 5, w, 2 * w + 3):
                for pad in ("", " ", "ab", "é"):
                    pt = torch.tensor(list(pad.encode("utf-8")),
                                      dtype=torch.uint8, device=device)
                    out_w = max(8, 1 << (max(target, w) - 1).bit_length())
                    _string_cols_err(
                        S.string_place([ca], n, out_w, mode, target, pt),
                        S._string_place_torch([ca], n, out_w, mode, target,
                                              pt),
                        f"K18 pad mode {mode} w={w} target={target} "
                        f"pad={pad!r}")
                    checks += 1
        if w <= 32:
            # more operands than one kernel call takes: the wrapper folds
            ops = [scalar("é-") if m % 4 == 3 else (cb if m % 2 else ca)
                   for m in range(70)]
            out_w = 1 << (sum(o[0].shape[1] for o in ops) - 1).bit_length()
            _string_cols_err(S.string_place(ops, n, out_w, S.CONCAT),
                             S._string_place_torch(ops, n, out_w, S.CONCAT,
                                                   0, torch.zeros(
                                                       0, dtype=torch.uint8,
                                                       device=device)),
                             f"K18 concat of 70 operands w={w}")
            checks += 1
    cap = 1 << 20
    # two independent o_comment draws, so that no byte is read twice
    col_a = _comments(rng, cap - 1234, cap, device, null_frac=0.05)
    col_b = _comments(rng, cap - 1234, cap, device, null_frac=0.05)
    ops = [(col_a.data, col_a.lengths, col_a.validity), scalar("-"),
           (col_b.data, col_b.lengths, col_b.validity)]
    out_w = 128                         # bucket(32 + 8 + 32)
    empty = torch.zeros(0, dtype=torch.uint8, device=device)
    _string_cols_err(S.string_place(ops, cap, out_w, S.CONCAT),
                     S._string_place_torch(ops, cap, out_w, S.CONCAT, 0,
                                           empty), "K18 o_comment concat")
    star = torch.tensor(list(b"*-"), dtype=torch.uint8, device=device)
    w = COMMENT_WIDTH
    return {
        "name": "string_place", "checks": checks + 1, "max_abs_err": 0.0,
        "tolerance": "exact (bytes, lengths, validity)", "rows": cap,
        "width": w,
        "timed": "concat(a, '-', b) of two independent o_comment draws "
                 "over one 2^20-row batch (out width 128)",
        "ms": time_ms(lambda: S.string_place(ops, cap, out_w, S.CONCAT)),
        "plain_ms": time_ms(lambda: S._string_place_torch(
            ops, cap, out_w, S.CONCAT, 0, empty), iters=5),
        "ms_lpad_40": time_ms(lambda: S.string_place(
            ops[:1], cap, 64, S.LPAD, 40, star)),
        "library_ms": None,        # no single PyTorch call computes it
        # both operands' rows, lengths and validity read; the output rows,
        # lengths and validity written
        "bound_ms": bound_ms(2 * cap * (w + 4 + 1) + cap * (out_w + 4 + 1)),
    }


LOCATE_PATTERNS = ("l", "", "é", "😀", "a b", "ll", "\x80", "x" * 300)


def check_locate(device, rng) -> dict:
    import torch
    from spark_rapids_tpu_torch.ops import strings as S
    checks = 0
    for w in STRING_WIDTHS:
        col = utf8_rows(rng, 3000, 4096, w, device)
        for p in LOCATE_PATTERNS:
            pat = torch.tensor(list(p.encode("utf-8")), dtype=torch.uint8,
                               device=device)
            tensor_err(S.find_pattern(col.data, col.lengths, pat, S.LOCATE),
                       S._find_pattern_torch(col.data, col.lengths, pat,
                                             S.LOCATE),
                       f"K13 locate w={w} {p!r}")
            checks += 1
    cap = 1 << 20
    col = _comments(rng, cap - 1234, cap, device)
    pat = torch.tensor(list(b"special"), dtype=torch.uint8, device=device)
    tensor_err(S.find_pattern(col.data, col.lengths, pat, S.LOCATE),
               S._find_pattern_torch(col.data, col.lengths, pat, S.LOCATE),
               "K13 locate o_comment")
    w = COMMENT_WIDTH
    return {
        "name": "find_pattern_locate", "checks": checks + 1,
        "max_abs_err": 0.0, "tolerance": "exact (character positions)",
        "rows": cap, "width": w,
        "ms": time_ms(lambda: S.find_pattern(col.data, col.lengths, pat,
                                             S.LOCATE)),
        "plain_ms": time_ms(lambda: S._find_pattern_torch(
            col.data, col.lengths, pat, S.LOCATE)),
        "library_ms": None,        # no single PyTorch call computes it
        # the byte rows and lengths read, an int32 per row written
        "bound_ms": bound_ms(cap * (w + 4) + cap * 4),
    }


# -- Wide key lists (K2, K3, K11 in blocks) and many partitions (K12) ---------

WIDE_KEY_TYPES = ("bigint", "string", "double", "int", "boolean", "date",
                  "float", "smallint")


# ---------------------------------------------------------------------------
# Generated stage kernels (K19 fused_stage, K20 fused_reduce)
# ---------------------------------------------------------------------------

GEN_SOURCE = "spark_rapids_tpu_torch/plan/stage_codegen.py"
# nation names the q7/q8 string columns draw from (with NULLs)
NATION_WORDS = ("FRANCE", "GERMANY", "BRAZIL", "ALGERIA", "", "FRANCEX",
                "UNITED STATES")


def tiny_tpch():
    """benchmarks/datagen.py tables at SF 0.001 (TPC-H, and the TPC-DS
    tables q98 and q89 read): the plans whose stages the kernel checks
    take (a stage's source depends on its expressions, not on the data's
    size)."""
    from benchmarks import datagen
    from spark_rapids_tpu_torch import queries
    sf = 0.001
    return {"lineitem": datagen.gen_lineitem(sf),
            "orders": datagen.gen_orders(sf),
            "customer": datagen.gen_customer(sf),
            "supplier": datagen.gen_supplier(sf),
            "partsupp": datagen.gen_partsupp(sf),
            "nation": datagen.gen_nation(), "part": datagen.gen_part(sf),
            "region": datagen.gen_region(), **queries.tpcds_tables(sf)}


def tiny_session(device):
    """(session on ``device``, the tiny tables and a 1000-row headline as
    its DataFrames)."""
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.api.session import TpuSession
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": str(device)}).getOrCreate()
    t = {k: session.createDataFrame(v, schema=queries.table_schema(v))
         for k, v in tiny_tpch().items()}
    t["headline"] = session.createDataFrame(queries.headline_table(1000))
    return session, t


def plan_units(session, df):
    """The fused units of ``df``'s plan that carry a generated kernel."""
    plan = session.plan(df._analyzed())
    return [n for n in _plan_nodes(plan)
            if getattr(n, "kernel", None) is not None]


def word_column(rng, words, cap: int, n: int, device, width: int = 16):
    """A STRING column of ``words`` drawn at random, 10% NULL, built as
    the byte matrix directly (no per-row encoding)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    table = np.zeros((len(words), width), np.uint8)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        b = w.encode()
        table[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    pick = rng.integers(0, len(words), cap)
    valid = (rng.random(cap) >= 0.1) & (np.arange(cap) < n)
    data = np.where(valid[:, None], table[pick], 0).astype(np.uint8)
    lengths = np.where(valid, lens[pick], 0).astype(np.int32)
    return Column(dt.STRING, torch.from_numpy(data).to(device),
                  torch.from_numpy(valid).to(device),
                  torch.from_numpy(lengths).to(device))


def random_batch(rng, schema, cap: int, n: int, device, extremes: bool):
    """A batch of ``schema`` with 10% NULLs and dead rows past ``n``:
    TPC-H-like values, or (``extremes``) NaN, +-inf, +-0.0, the integer
    extremes and days from -800000 to 800000."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    cols = []
    for f in schema:
        t = f.dtype
        if t == dt.STRING:
            cols.append(word_column(rng, NATION_WORDS, cap, n, device))
            continue
        if t == dt.BOOL:
            vals = rng.random(n) < 0.5
        elif t == dt.DATE:
            vals = (rng.integers(-800000, 800001, n) if extremes else
                    rng.integers(8036, 10592, n)).astype(np.int32)
        elif t.is_floating:
            vals = (rng.normal(0, 1e4, n) if extremes else
                    np.round(rng.uniform(0, 1e5, n), 2)).astype(
                t.numpy_dtype)
            if extremes:
                pick = rng.random(n) < 0.2
                vals[pick] = rng.choice(
                    [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -2.5],
                    int(pick.sum()))
            elif f.name.endswith("discount") or f.name.endswith("tax"):
                vals = np.round(rng.uniform(0, 0.1, n), 2).astype(
                    t.numpy_dtype)
        else:
            info = np.iinfo(t.numpy_dtype)
            vals = rng.integers(max(info.min, -10 ** 6),
                                min(info.max, 10 ** 6), n).astype(
                t.numpy_dtype)
            if extremes:
                pick = rng.random(n) < 0.2
                vals[pick] = rng.choice([info.min, info.max, -1, 0, 1],
                                        int(pick.sum()))
        valid = rng.random(n) >= 0.1
        cols.append(Column.from_numpy(vals, t, valid, capacity=cap,
                                      device=device))
    return ColumnarBatch(schema, cols, n)


def eager_unit(node, batch):
    """(columns, keep mask or None) of a fused unit by its eager torch
    ops, in the generated kernel's output order."""
    import torch
    from spark_rapids_tpu_torch.ops import expressions as ex
    from spark_rapids_tpu_torch.plan import physical as ph
    from spark_rapids_tpu_torch.plan import stage_compiler as sc
    if isinstance(node, sc.TpuWholeStageExec):
        b, mask = node.chain.eval(batch)
        return b.columns, mask
    if isinstance(node, ph.TpuProjectExec):
        return [ex.materialize(e.eval(batch), batch) for e in node.exprs], \
            None
    if isinstance(node, (ph.TpuFilterExec, types.SimpleNamespace)):
        pred = node.condition.eval(batch)
        return [], pred.data & pred.validity & batch.row_mask_raw()
    keys, cols, mask = node.eager_update_inputs(batch)
    key_slots, leaf_slots = node._prologue_slots
    out = dict(zip(key_slots, keys))
    out.update((i, c) for i, c in zip(leaf_slots, cols) if i is not None)
    return [out[i] for i in range(len(out))], mask


def unit_bytes(kernel, batch) -> int:
    """Bytes one K19 launch must move: every input column it reads once
    (data, validity, string lengths), every output it writes once, the
    keep mask."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    cap = batch.capacity
    total = 0
    for ordinal in kernel._inputs:
        c = batch.columns[ordinal]
        total += c.data.numel() * c.data.element_size() + cap
        if c.dtype == dt.STRING:
            total += cap * 4
    for kind in kernel.out_kinds:
        if kind[0] == "gen":
            total += cap * (kind[1].byte_width + 1)
    if kernel.mask_word is not None:
        total += cap
    return total


def hold_unit(node, batch, rel: float, what: str) -> float:
    """One K19 launch of a unit against its eager ops: every output's data
    and validity, and the keep mask, bit for bit (``rel`` for the
    transcendental families). Returns the largest float error."""
    import torch
    outs, mask = node.kernel.launch(batch)
    want, want_mask = eager_unit(node, batch)
    if (mask is None) != (want_mask is None) or (
            mask is not None and not torch.equal(mask, want_mask)):
        raise AssertionError(f"K19 {what}: the keep mask differs")
    if len(outs) != len(want):
        raise AssertionError(f"K19 {what}: {len(outs)} outputs, eager "
                             f"{len(want)}")
    err = 0.0
    for i, (g, w) in enumerate(zip(outs, want)):
        if g.dtype.name == "string":
            if g is not w and not torch.equal(g.data, w.data):
                raise AssertionError(f"K19 {what}: string output {i}")
            continue
        err = max(err, column_err(g, w, rel, f"K19 {what} output {i}"))
    return err


def random_chain_df(F, t):
    """A select touching every generated family over random columns: the
    scalar arithmetic, conditionals, predicates, casts, dates and math."""
    c = F.col
    return t.select(
        (c("x") + c("y")).alias("add"), (c("x") * c("y") - c("x") /
                                        c("y")).alias("muldiv"),
        F.pmod(c("l"), F.lit(7)).alias("pmod"), (c("l") % c("m")).alias(
            "rem"), (-c("i")).alias("neg"), F.abs(c("l")).alias("abs"),
        F.coalesce(c("x"), c("y"), F.lit(0.5)).alias("coal"),
        F.nullif(c("i"), F.lit(0)).alias("nullif"),
        F.greatest(c("x"), c("y")).alias("great"),
        F.least(c("l"), c("m")).alias("least"),
        F.when(c("x") > F.lit(0.0), c("y")).when(c("t"), F.lit(1.0))
        .otherwise(c("x")).alias("case"),
        F.isnan(c("x")).alias("isnan"), F.isnull(c("y")).alias("isnull"),
        c("x").eqNullSafe(c("y")).alias("ens"),
        ((c("x") < c("y")) | ~c("t")).alias("kleene"),
        c("l").isin(1, -1, 0, 7).alias("isin"),
        c("x").cast("int").alias("f2i"), c("l").cast("smallint").alias(
            "narrow"),
        F.year(c("d")).alias("year"), F.month(c("d")).alias("month"),
        F.dayofmonth(c("d")).alias("dom"), F.dayofweek(c("d")).alias("dow"),
        F.dayofyear(c("d")).alias("doy"), F.quarter(c("d")).alias("q"),
        F.last_day(c("d")).alias("last"),
        F.add_months(c("d"), c("i")).alias("addm"),
        F.date_add(c("d"), F.lit(45)).alias("dadd"),
        F.datediff(c("d"), c("e")).alias("ddiff"),
        F.floor(c("x")).alias("floor"), F.ceil(c("x")).alias("ceil"),
        F.round(c("x"), 2).alias("round"))


def random_math_df(F, t):
    """The transcendental functions (libm: ulps, 1e-12 relative)."""
    c = F.col
    return t.select(F.sqrt(c("x")).alias("sqrt"), F.exp(c("y")).alias("exp"),
                    F.log(c("x")).alias("log"), F.sin(c("x")).alias("sin"),
                    F.cos(c("y")).alias("cos"), F.tan(c("x")).alias("tan"),
                    F.pow(c("x"), c("y")).alias("pow"),
                    F.atan2(c("x"), c("y")).alias("atan2"))


RANDOM_SCHEMA = (("x", "double"), ("y", "double"), ("l", "bigint"),
                 ("m", "bigint"), ("i", "int"), ("t", "boolean"),
                 ("d", "date"), ("e", "date"))


def stage_units(device):
    """(name, unit node, rel) of the chains K19 is held on: q6's filter,
    q1's filter -> aggregate inputs, the headline's chain, q7's chain
    (string equality, year), the nation stage of q7, and the random
    chains over every generated family."""
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.plan import stage_codegen as sg
    session, t = tiny_session(device)
    units = []
    q6_agg = plan_units(session, queries.q6(t))[0]
    # q6's filter alone, as a filter-mode stage over lineitem's columns
    filters, _cols = sg.inline_chain(q6_agg.pre_stage,
                                     q6_agg.children[0].schema)
    if len(filters) != 1:
        raise AssertionError("q6's chain is not one filter")
    q6_filter = types.SimpleNamespace(
        condition=filters[0], kernel=sg.StageKernel(
            "stage", q6_agg.children[0].schema, filters, []))
    units.append(("q6 filter", q6_filter, 0.0))
    units.append(("q1 filter -> aggregate inputs",
                  plan_units(session, queries.q1(t))[0], 0.0))
    units.append(("headline chain",
                  plan_units(session, queries.headline(t))[0], 0.0))
    for k, node in enumerate(plan_units(session, queries.q7(t))):
        units.append((f"q7 {type(node).__name__} {k}", node, 0.0))
    tiny = {name: np.zeros(4, np.int32 if tn in ("int", "date") else
                           np.bool_ if tn == "boolean" else
                           np.float64 if tn == "double" else np.int64)
            for name, tn in RANDOM_SCHEMA}
    rdf = session.createDataFrame(tiny, schema=dict(RANDOM_SCHEMA))
    units.append(("random chain, every family",
                  plan_units(session, random_chain_df(F, rdf))[0], 0.0))
    units.append(("random chain, transcendental",
                  plan_units(session, random_math_df(F, rdf))[0], 1e-12))
    return units


def main_path_kernels(device) -> list:
    """The distinct generated kernels of the main path's plans (every
    query of MAIN_QUERIES planned over tiny tables): what the build phase
    compiles. A stage the SF-10 plans hold besides compiles at its first
    launch."""
    from spark_rapids_tpu_torch import queries
    session, t = tiny_session(device)
    found = {}
    for name in MAIN_QUERIES:
        for node in plan_units(session, queries.QUERIES[name](t)):
            found.setdefault(node.kernel.entry, node.kernel)
    return list(found.values())


def check_k19(device, rng) -> dict:
    """K19 against the eager chain of each unit on a 2^20-row batch."""
    import torch
    cap = 1 << 20
    n = cap - 4321
    rows, err = [], 0.0
    for name, node, rel in stage_units(device):
        kern = node.kernel
        extremes = name.startswith("random")
        batch = random_batch(rng, kern.in_schema, cap, n, device, extremes)
        err = max(err, hold_unit(node, batch, rel, name))
        torch.cuda.synchronize()
        rows.append({
            "chain": name, "entry": kern.entry,
            "inputs": len(kern._inputs),
            "outputs": sum(k[0] == "gen" for k in kern.out_kinds),
            "mask": kern.mask_word is not None,
            "ms": time_ms(lambda: kern.launch(batch)),
            "plain_ms": time_ms(lambda: eager_unit(node, batch), iters=10),
            "bound_ms": bound_ms(unit_bytes(kern, batch))})
    main = rows[1]                      # q1's chain: the main path's shape
    return {"name": "fused_stage", "checks": len(rows), "max_abs_err": err,
            "tolerance": "integer, bool, date outputs, the keep mask and "
                         "+ - * / floats bit for bit; transcendental "
                         "functions relative 1e-12",
            "chains": rows, "timed_at": main["chain"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes a stage"}


def check_k20(device, rng) -> dict:
    """K20 + K1's fold against the unfused path (the eager chain, then K1
    per aggregate) on q6's 2^20-row batch: bit for bit. Also every op on
    a random chain, and the fold alone."""
    import torch
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.ops import aggregates as A
    session, t = tiny_session(device)
    q6 = plan_units(session, queries.q6(t))[0]
    tiny = {"x": np.zeros(4), "l": np.zeros(4, np.int64),
            "d": np.zeros(4, np.int32), "t": np.zeros(4, np.bool_)}
    rdf = session.createDataFrame(tiny, schema={"d": "date"})
    c = F.col
    every = plan_units(session, rdf.filter(c("x") > F.lit(-5000.0)).agg(
        F.sum(c("x") * F.lit(2.0)).alias("s"), F.count("x").alias("n"),
        F.count("*").alias("all"), F.min("x").alias("mn"),
        F.max("x").alias("mx"), F.avg("l").alias("avg"),
        F.sum("l").alias("sl"), F.min("d").alias("md"),
        F.max("t").alias("mt"),
        F.first("l").alias("first"), F.last("x").alias("last")))[0]
    cap = 1 << 20
    n = cap - 999
    checks, err, rows = 0, 0.0, []
    for name, node, extremes in (("q6", q6, False),
                                 ("every op", every, True)):
        batch = random_batch(rng, node.kernel.in_schema, cap, n, device,
                             extremes)
        got = node.kernel.reduce(batch, A.REDUCE_SLOTS)
        kernel = node.kernel
        node.kernel = None
        want = node._update(batch).columns
        node.kernel = kernel
        for i, (g, w) in enumerate(zip(got, want)):
            err = max(err, column_err(g, w, 0.0, f"K20 {name} output {i}"))
            checks += 1
        if name == "q6":
            q6_batch = batch
        rows.append({"stage": name, "entry": kernel.entry,
                     "aggregates": len(kernel.specs)})
    kern = q6.kernel
    nparts = A.masked_reduce_parts(cap)
    parts = torch.zeros(nparts * 32, dtype=torch.uint8, device=device)
    fold_ms = time_ms(lambda: A.masked_reduce_fold(
        "sum", 5, q6.kernel.specs[0][1].dtype, parts, nparts, None, None,
        A.REDUCE_SLOTS, device))

    def eager():
        k = q6.kernel
        q6.kernel = None
        try:
            return q6._update(q6_batch)
        finally:
            q6.kernel = k
    return {"name": "fused_reduce", "checks": checks, "max_abs_err": err,
            "tolerance": "bit for bit against the eager chain + K1 (the "
                         "same grid, per-thread order and tree)",
            "stages": rows, "timed_at": "q6's update stage, one 2^20-row "
                                        "batch (K20 + K1's fold)",
            "ms": time_ms(lambda: kern.reduce(q6_batch, A.REDUCE_SLOTS)),
            "plain_ms": time_ms(eager, iters=10),
            "bound_ms": bound_ms(unit_bytes(kern, q6_batch) +
                                 nparts * 32 * len(kern.specs)),
            "library_ms": None,
            "library": "none: no single PyTorch call computes a stage",
            "fold": {"name": "masked_reduce_fold", "checks": checks,
                     "max_abs_err": err, "ms": fold_ms,
                     "plain_ms": None,
                     "bound_ms": bound_ms(nparts * 32 + 128 * 9),
                     "library_ms": None}}


# ---------------------------------------------------------------------------
# Window kernels (K21-K24)
# ---------------------------------------------------------------------------

# the windows phase's shapes: orders at SF 10 (15 M rows in one 2^24 batch,
# ~10 a customer) and lineitem (60 M rows in one 2^26 batch, ~600 a
# supplier)
W_ORDERS_ROWS, W_ORDERS_CAP, W_ORDERS_SEG = 15_000_000, 1 << 24, 10
W_LINEITEM_ROWS, W_LINEITEM_CAP, W_LINEITEM_SEG = 60_000_000, 1 << 26, 600
INT32_EDGES = (-(1 << 31), (1 << 31) - 1)


def bits_err(got, want, what: str) -> float:
    """Validity, and the data's bits on valid rows, equal."""
    import torch
    if not torch.equal(got.validity, want.validity):
        bad = (got.validity != want.validity).nonzero()[:4].flatten()
        raise AssertionError(f"{what}: validity differs at {bad.tolist()}")
    if got.data.dtype != want.data.dtype:
        raise AssertionError(f"{what}: {got.data.dtype} vs {want.data.dtype}")
    a, b = got.data, want.data
    if a.dtype.is_floating_point:
        it = torch.int64 if a.element_size() == 8 else torch.int32
        a, b = a.view(it), b.view(it)
    v = got.validity
    if not torch.equal(torch.where(v, a, 0), torch.where(v, b, 0)):
        bad = ((a != b) & v).nonzero()[:4].flatten().tolist()
        raise AssertionError(f"{what}: data bits differ at {bad}")
    return 0.0


def window_keys(rng, cap: int, n: int, seg_rows, device,
                key: str = "double", pkey_nulls: float = 0.05):
    """A partition key (int64, NULLs) of about ``seg_rows`` rows a value
    (None: one segment; 1: every row its own) and an order key: doubles
    (multiples of 1/4, ties, NaN, -0.0, NULLs), or int32/date keys at the
    int32 edges and near 0 (NULLs)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    if seg_rows is None:
        pk = np.zeros(n, np.int64)
    elif seg_rows == 1:
        pk = rng.permutation(n).astype(np.int64)
    else:
        pk = rng.integers(0, max(1, n // seg_rows), n).astype(np.int64)
    pvalid = rng.random(n) >= (pkey_nulls if seg_rows not in (None, 1)
                               else 0.0)
    pcol = Column.from_numpy(pk, dt.INT64, pvalid, capacity=cap,
                             device=device)
    if key == "double":
        ocol = make_column(rng, "double", cap, n, device)
    else:
        lo, hi = INT32_EDGES
        pick = rng.integers(0, 3, n)
        vals = np.where(pick == 0, rng.integers(lo, lo + 60, n),
                        np.where(pick == 1, rng.integers(hi - 60, hi, n),
                                 rng.integers(-100, 100, n)))
        t = dt.INT32 if key == "int" else dt.DATE
        ocol = Column.from_numpy(vals.astype(np.int32), t,
                                 rng.random(n) >= 0.1, capacity=cap,
                                 device=device)
    return pcol, ocol


class SortedWindow:
    """A batch sorted by (partition key, order key) with K3's segments over
    the partition key and its peer groups over both (the exec's steps)."""

    def __init__(self, pcol, ocol, n: int):
        from spark_rapids_tpu_torch.ops import kernels as K
        cap = pcol.capacity
        order = K.sort_indices([K.SortKey(pcol), K.SortKey(ocol)], n, cap)
        self.p = K.gather_column(pcol, order)
        self.o = K.gather_column(ocol, order)
        self.n, self.cap = n, cap
        _s, self.seg, self.ng, self.first = K.segment_bounds([self.p], n,
                                                             cap)
        _s, self.peer, _g, self.peer_first = K.segment_bounds(
            [self.p, self.o], n, cap)


def check_k21(device, rng) -> dict:
    """K21's rank modes and its offset mode against their twins over NULL,
    NaN, -0.0 and tied order keys; a one-row and a one-segment batch;
    offsets past either end."""
    from spark_rapids_tpu_torch.ops import window as W
    cap = 1 << 20
    checks = 0
    cases = [(cap, cap - 555, 8), (cap, cap - 555, 1), (cap, cap - 555, None),
             (128, 1, 8), (128, 100, None)]
    for c, n, seg_rows in cases:
        s = SortedWindow(*window_keys(rng, c, n, seg_rows, device), n)
        for kind in ("row_number", "rank", "dense_rank"):
            tensor_err(W.window_rank(kind, s.seg, s.first, n, s.peer,
                                     s.peer_first),
                       W._window_rank_torch(kind, s.seg, s.first, n, s.peer,
                                            s.peer_first),
                       f"K21 {kind} n={n} seg_rows={seg_rows}")
            checks += 1
        for off in (-3, -1, 1, 2, 7, c + 5, -(c + 5)):
            for g, w in zip(W.window_offset(s.seg, n, off),
                            W._window_offset_torch(s.seg, n, off)):
                tensor_err(g, w, f"K21 offset {off} n={n}")
            checks += 1
    # W1's shape: orders at SF 10, ~10 rows a customer, ranked by a key
    # with ties
    big = SortedWindow(*window_keys(rng, W_ORDERS_CAP, W_ORDERS_ROWS,
                                    W_ORDERS_SEG, device), W_ORDERS_ROWS)
    small = SortedWindow(*window_keys(rng, cap, cap - 555, W_ORDERS_SEG,
                                      device), cap - 555)

    def rank_bytes(s):
        """A live row's segment and peer ids, each segment's and peer
        group's first row read; the rank written over the capacity."""
        ng, npg = int(s.ng), int(s.peer[:s.n].max()) + 1
        return s.n * (4 + 4) + 4 * ng + 4 * npg + s.cap * 4

    def timed(s):
        return {
            "ms": time_ms(lambda: W.window_rank(
                "rank", s.seg, s.first, s.n, s.peer, s.peer_first)),
            "plain_ms": time_ms(lambda: W._window_rank_torch(
                "rank", s.seg, s.first, s.n, s.peer, s.peer_first),
                iters=5),
            "bound_ms": bound_ms(rank_bytes(s)),
            "offset_ms": time_ms(lambda: W.window_offset(s.seg, s.n, -1)),
            "offset_plain_ms": time_ms(
                lambda: W._window_offset_torch(s.seg, s.n, -1), iters=5),
            # a live row's segment id read (the source row's is another
            # row's own); the source row and its flag written
            "offset_bound_ms": bound_ms(s.n * 4 + s.cap * (8 + 1))}
    t_big, t_small = timed(big), timed(small)
    return {"name": "window_rank", "checks": checks, "max_abs_err": 0.0,
            "tolerance": "exact", "timed_at": "rank, W1's shape (15 M rows "
            "in 2^24, ~10 a segment); at_2_20: one 2^20 batch",
            "ms": t_big["ms"], "plain_ms": t_big["plain_ms"],
            "bound_ms": t_big["bound_ms"], "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "at_2_20": t_small,
            "modes": [{"name": "window_offset", "checks": checks,
                       "max_abs_err": 0.0, "ms": t_big["offset_ms"],
                       "plain_ms": t_big["offset_plain_ms"],
                       "bound_ms": t_big["offset_bound_ms"],
                       "library_ms": None,
                       "timed_at": "lag 1, W2's shape",
                       "at_2_20": {k: t_small[k] for k in (
                           "offset_ms", "offset_plain_ms",
                           "offset_bound_ms")}}]}


def _scan_values(rng, cap: int, n: int, device):
    """Value columns of every type a frame aggregates: doubles and floats
    (multiples of 1/4, NaN, -0.0, NULLs: sums exact in any order), int32,
    int64 near its extremes (wrapping sums), dates."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    big = make_column(rng, "bigint", cap, n, device)
    big.data[torch.rand(cap, device=device) < 0.01] = (1 << 63) - 1
    return {"double": make_column(rng, "double", cap, n, device),
            "float": make_column(rng, "float", cap, n, device),
            "int": make_column(rng, "int", cap, n, device),
            "bigint": Column(dt.INT64, big.data, big.validity),
            "date": make_column(rng, "date", cap, n, device)}


SCAN_OPS = ("count_star", "count", "sum", "avg", "min", "max")


def _scan_ok(op: str, tname: str) -> bool:
    return not (op in ("sum", "avg") and tname == "date")


def check_k22(device, rng) -> dict:
    """K22 against its twin over every op and value type, bit for bit (the
    values' sums are exact in any order)."""
    from spark_rapids_tpu_torch.ops import window as W
    checks = 0
    for c, n, seg_rows in ((1 << 20, (1 << 20) - 321, 8),
                           (1 << 20, (1 << 20) - 321, 1),
                           (1 << 20, (1 << 20) - 321, None),
                           (1 << 20, (1 << 20) - 321, 3000),
                           (128, 1, 8), (128, 90, None)):
        s = SortedWindow(*window_keys(rng, c, n, seg_rows, device), n)
        for tname, col in _scan_values(rng, c, n, device).items():
            for op in SCAN_OPS:
                if not _scan_ok(op, tname):
                    continue
                arg = None if op == "count_star" else col
                (g, gc), (w, wc, _w) = (
                    W.segmented_scan(op, arg, s.seg, n),
                    W._segmented_scan_torch(op, arg, s.seg, n))
                what = f"K22 {op}({tname}) n={n} seg_rows={seg_rows}"
                if op in ("sum", "avg"):
                    column_err(g, w, 0.0, what)
                else:
                    bits_err(g, w, what)
                tensor_err(gc, wc, what + " count")
                checks += 1
            if tname in ("double", "float"):
                # K24's prefix: finite values summed, NaN and infinities
                # counted apart
                got = W.frame_prefix("sum", col, s.seg, n)
                want = W._segmented_scan_torch("sum", col, s.seg, n, True)
                what = f"K22 finite sum({tname}) n={n} seg_rows={seg_rows}"
                column_err(got[0], want[0], 0.0, what)
                tensor_err(got[1], want[1], what + " count")
                tensor_err(got[2], want[2], what + " non-finite count")
                checks += 1
    # W3's shape: running sum of a price over orders' ~10-row segments
    out = {}
    for label, cap, n in (("w3", W_ORDERS_CAP, W_ORDERS_ROWS),
                          ("at_2_20", 1 << 20, (1 << 20) - 321)):
        s = SortedWindow(*window_keys(rng, cap, n, W_ORDERS_SEG, device), n)
        price = make_column(rng, "double", cap, n, device, nan_frac=0.0)
        out[label] = {
            "ms": time_ms(lambda: W.segmented_scan("sum", price, s.seg, n)),
            "plain_ms": time_ms(lambda: W._segmented_scan_torch(
                "sum", price, s.seg, n), iters=3, warmup=1),
            # a live row's value, validity and id read; sum, validity and
            # count written over the capacity
            "bound_ms": bound_ms(n * (8 + 1 + 4) + cap * (8 + 1 + 8))}
    return {"name": "segmented_scan", "checks": checks, "max_abs_err": 0.0,
            "tolerance": "exact (sums of multiples of 1/4, exact in any "
                         "order; min/max and counts bit for bit)",
            "timed_at": "sum, W3's shape (15 M rows in 2^24, ~10 a "
                        "segment)", **out["w3"], "library_ms": None,
            "library": "none: no single PyTorch call scans per segment",
            "at_2_20": out["at_2_20"]}


# ROWS frames (None: unbounded): both ends, empty frames near the segment
# edges, offsets past any segment; RANGE frames over int32/date keys
ROW_FRAMES = ((-3, 3), (None, 0), (-7, None), (1, 5), (-5, -2), (None, None),
              (-(1 << 40), 1 << 40), (0, 0), (-100, 100))
RANGE_FRAMES = ((-30, 0), (None, 5), (-7, None), (1, 3), (0, 0), (-2, 2))


def check_k23(device, rng) -> dict:
    """K23 against its twin: ROWS and RANGE frames (int32 and date keys at
    the int32 edges, NULL keys), one-row and one-segment batches."""
    from spark_rapids_tpu_torch.ops import window as W
    checks = 0
    for c, n, seg_rows in ((1 << 20, (1 << 20) - 77, 8),
                           (1 << 20, (1 << 20) - 77, 600),
                           (1 << 20, (1 << 20) - 77, 1),
                           (1 << 20, (1 << 20) - 77, None),
                           (128, 1, 8), (128, 100, None)):
        for key in ("int", "date"):
            s = SortedWindow(*window_keys(rng, c, n, seg_rows, device, key),
                             n)
            for lower, upper in ROW_FRAMES:
                for g, w in zip(
                        W.frame_bounds(s.seg, s.first, s.ng, n, lower,
                                       upper),
                        W._frame_bounds_torch(s.seg, s.first, s.ng, n,
                                              lower, upper, None, True)):
                    tensor_err(g, w, f"K23 rows ({lower}, {upper}) n={n}")
                checks += 1
            for lower, upper in RANGE_FRAMES:
                for g, w in zip(
                        W.frame_bounds(s.seg, s.first, s.ng, n, lower,
                                       upper, s.o),
                        W._frame_bounds_torch(s.seg, s.first, s.ng, n,
                                              lower, upper, s.o, True)):
                    tensor_err(g, w, f"K23 range {key} ({lower}, {upper}) "
                                     f"n={n} seg_rows={seg_rows}")
                checks += 1
    # W5's shape: RANGE -30..0 over lineitem's ~600-row supplier segments
    out = {}
    for label, cap, n in (("w5", W_LINEITEM_CAP, W_LINEITEM_ROWS),
                          ("at_2_20", 1 << 20, (1 << 20) - 77)):
        s = SortedWindow(*window_keys(rng, cap, n, W_LINEITEM_SEG, device,
                                      "date"), n)
        ng = int(s.ng)
        out[label] = {
            "ms": time_ms(lambda: W.frame_bounds(s.seg, s.first, s.ng, n,
                                                 -30, 0, s.o)),
            "plain_ms": time_ms(lambda: W._frame_bounds_torch(
                s.seg, s.first, s.ng, n, -30, 0, s.o, True), iters=5),
            # a live row's id, key and key validity and the segments'
            # first rows read; lo and hi written over the capacity
            "bound_ms": bound_ms(n * (4 + 4 + 1) + 4 * ng + cap * (4 + 4))}
        del s
    return {"name": "frame_bounds", "checks": checks, "max_abs_err": 0.0,
            "tolerance": "exact", "timed_at": "RANGE -30..0 over a date, "
            "W5's shape (60 M rows in 2^26, ~600 a segment)", **out["w5"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "at_2_20": out["at_2_20"]}


def check_k24(device, rng) -> dict:
    """K24 against its twin over every op and value type, on the bounds
    and running sums the kernels K23 and K22 give: narrow frames (summed
    directly), wide ones (running sums, the min/max table), empty frames
    and unbounded ends; bit for bit."""
    import torch
    from spark_rapids_tpu_torch.ops import window as W
    checks = 0
    frames = [(f, None) for f in ROW_FRAMES] + \
        [(f, "range") for f in RANGE_FRAMES]
    for c, n, seg_rows in ((1 << 20, (1 << 20) - 99, 600),
                           (1 << 20, (1 << 20) - 99, 8),
                           (1 << 20, (1 << 20) - 99, None),
                           (128, 1, 8)):
        s = SortedWindow(*window_keys(rng, c, n, seg_rows, device, "int"),
                         n)
        values = _scan_values(rng, c, n, device)
        for (lower, upper), kind in frames:
            lo, hi = W.frame_bounds(s.seg, s.first, s.ng, n, lower, upper,
                                    s.o if kind else None)
            for tname, col in values.items():
                for op in SCAN_OPS:
                    if not _scan_ok(op, tname):
                        continue
                    arg = None if op == "count_star" else col
                    prefix = W.frame_prefix(op, arg, s.seg, n)
                    g = W.frame_aggregate(op, arg, s.seg, n, lo, hi,
                                          *prefix)
                    w = W._frame_aggregate_torch(op, arg, s.seg, n, lo, hi,
                                                 *prefix)
                    what = (f"K24 {op}({tname}) {kind or 'rows'} "
                            f"({lower}, {upper}) n={n} seg_rows={seg_rows}")
                    if op in ("sum", "avg"):
                        column_err(g, w, 0.0, what)
                    else:
                        bits_err(g, w, what)
                    checks += 1
    # W4's shape: lineitem's ~600-row supplier segments; max over -7 ..
    # UNBOUNDED FOLLOWING (the min/max table) and avg over -3..3 (direct)
    out = {}
    for label, cap, n in (("w4", W_LINEITEM_CAP, W_LINEITEM_ROWS),
                          ("at_2_20", 1 << 20, (1 << 20) - 99)):
        s = SortedWindow(*window_keys(rng, cap, n, W_LINEITEM_SEG, device,
                                      "int"), n)
        qty = make_column(rng, "double", cap, n, device, nan_frac=0.0)
        lo, hi = W.frame_bounds(s.seg, s.first, s.ng, n, -7, None)
        _p, pcount, _nf = W.frame_prefix("max", qty, s.seg, n)
        alo, ahi = W.frame_bounds(s.seg, s.first, s.ng, n, -3, 3)
        nb, levels = W.frame_table_levels(cap)
        out[label] = {
            "ms": time_ms(lambda: W.frame_aggregate(
                "max", qty, s.seg, n, lo, hi, None, pcount)),
            "plain_ms": time_ms(lambda: W._frame_aggregate_torch(
                "max", qty, s.seg, n, lo, hi, None, pcount), iters=3,
                warmup=1),
            # a live row's value, validity, id, lo, hi and running count
            # read; the result and its validity written over the capacity
            # (the table is the kernel's own traffic)
            "bound_ms": bound_ms(n * (8 + 1 + 4 + 4 + 4 + 8) + cap * (8 + 1)),
            "table_bytes": levels * nb * 8,
            "avg_direct_ms": time_ms(lambda: W.frame_aggregate(
                "avg", qty, s.seg, n, alo, ahi,
                *W.frame_prefix("avg", qty, s.seg, n)))}
        del s, qty, lo, hi, pcount, alo, ahi
        torch.cuda.empty_cache()
    return {"name": "frame_aggregate", "checks": checks, "max_abs_err": 0.0,
            "tolerance": "exact (sums of multiples of 1/4; min/max and "
                         "counts bit for bit)",
            "timed_at": "max over -7..UNBOUNDED FOLLOWING, W4's shape (60 M "
                        "rows in 2^26, ~600 a segment)", **out["w4"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "at_2_20": out["at_2_20"]}

# ---------------------------------------------------------------------------
# K25-K28: nested types
# ---------------------------------------------------------------------------

NESTED_ELEM_TYPES = ("boolean", "tinyint", "smallint", "int", "bigint",
                     "float", "double", "date", "timestamp")
ARRAY_WIDTHS = (4, 8, 16, 32, 64)


def array_column(rng, tname: str, cap: int, n: int, w: int, device,
                 fill: float = 0.6):
    """An ARRAY<tname> column of ``cap`` rows, the first ``n`` live: NULL
    arrays (10%), empty ones, NULL elements (10%), lengths up to ``w``
    (about ``fill`` of it); junk values past every length; dead rows
    invalid."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    t = dt.of(f"array<{tname}>")
    et = t.element
    if et == dt.BOOL:
        data = rng.integers(0, 2, (cap, w)).astype(np.bool_)
    elif et.is_floating:
        data = (rng.integers(-4000, 4000, (cap, w)) / 4).astype(
            et.numpy_dtype)
        data[rng.random((cap, w)) < 0.05] = np.nan
    else:
        info = np.iinfo(et.numpy_dtype)
        data = rng.integers(info.min, info.max, (cap, w),
                            dtype=et.numpy_dtype, endpoint=True)
    lengths = np.minimum(rng.poisson(fill * w, cap), w).astype(np.int32)
    lengths[rng.random(cap) < 0.1] = 0
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= 0.1
    evalid = rng.random((cap, w)) >= 0.1
    evalid &= np.arange(w)[None, :] < lengths[:, None]
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    return Column(t, torch.from_numpy(data).to(device),
                  torch.from_numpy(valid).to(device),
                  torch.from_numpy(lengths).to(device),
                  torch.from_numpy(evalid).to(device))


def _exploded_err(got, want, what: str) -> float:
    if got.count != want.count:
        raise AssertionError(f"{what}: {got.count} vs {want.count} rows")
    for part in ("src", "pos", "total", "values", "values_valid"):
        a, b = getattr(got, part), getattr(want, part)
        if a is None and b is None:
            continue
        if a.dtype.is_floating_point:
            it = {8: "int64", 4: "int32", 2: "int16"}[a.element_size()]
            import torch
            a, b = a.view(getattr(torch, it)), b.view(getattr(torch, it))
        tensor_err(a.reshape(-1), b.reshape(-1), f"{what} {part}")
    return 0.0


def map_lanes_batch(rng, cap: int, n: int, device, entries: int = 3):
    """A map<bigint,bigint> column as create_map(1, a, 2, b, 3, c) builds it
    (N3's shape) and its int64 lookup keys (l_orderkey % 4 + 1: datagen's
    lineitem has no l_linenumber)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops import maps as M
    live = torch.arange(cap, device=device) < n
    ones = torch.ones(cap, dtype=torch.bool, device=device)
    keys = [Column(dt.INT64, torch.full((cap,), j + 1, dtype=torch.int64,
                                        device=device), ones)
            for j in range(entries)]
    vals = [Column(dt.INT64, torch.from_numpy(
        rng.integers(1, 60_000_000, cap)).to(device), ones)
        for _ in range(entries)]
    m = M.map_build(keys, vals, live, dt.MAP(dt.INT64, dt.INT64))
    lk = Column(dt.INT64, torch.from_numpy(
        rng.integers(1, 8, cap) % 4 + 1).to(device), live)
    return m, keys, vals, live, lk


def check_k25(device, rng) -> dict:
    """K25 against its twin, bit for bit: every primitive element type at
    widths 4-64 with NULL arrays, empty arrays, NULL elements and dead
    rows; index mode; an all-empty batch. Timed at N3(b)'s shape: one
    2^20-row batch of map_values(m) (3 elements a row)."""
    import torch
    from spark_rapids_tpu_torch.ops import arrays as A
    from spark_rapids_tpu_torch.ops import maps as M
    checks = 0
    for i, tname in enumerate(NESTED_ELEM_TYPES):
        for w in ARRAY_WIDTHS:
            cap = 4096 if w < 64 else 1024
            n = cap - int(rng.integers(0, 300))
            arr = array_column(rng, tname, cap, n, w, device)
            live = torch.arange(cap, device=device) < n
            args = (arr.lengths, arr.validity, live, arr.data,
                    arr.elem_validity)
            _exploded_err(A.explode_expand(*args),
                          A._explode_expand_torch(*args),
                          f"K25 {tname} w={w}")
            _exploded_err(A.explode_expand(*args[:3]),
                          A._explode_expand_torch(*args[:3]),
                          f"K25 index mode {tname} w={w}")
            checks += 2
    zero = torch.zeros(256, dtype=torch.int32, device=device)
    ones = torch.ones(256, dtype=torch.bool, device=device)
    _exploded_err(A.explode_expand(zero, ones, ones),
                  A._explode_expand_torch(zero, ones, ones), "K25 empty")
    cap = 1 << 20
    m, _k, _v, live, _lk = map_lanes_batch(rng, cap, cap, device)
    _keys, vals, vv, w = M._halves(m)
    arr = M._as_array(m, vals, m.dtype.element, vv)
    data, ev = arr.data.contiguous(), arr.elem_validity.contiguous()
    args = (arr.lengths, arr.validity, live, data, ev)
    _exploded_err(A.explode_expand(*args), A._explode_expand_torch(*args),
                  "K25 N3(b) batch")
    checks += 2
    out = A.explode_expand(*args)
    total = out.count
    lens = arr.lengths.to(torch.int64)
    n_el = int(lens.sum())
    # counts, validity and the live mask read; the elements of the live
    # arrays and their validity read; src, pos, value and its validity
    # written over the output capacity
    nbytes = cap * (4 + 1 + 1) + n_el * (8 + 1) + out.out_capacity * (
        4 + 4 + 8 + 1)
    idx = torch.arange(cap, device=device)
    return {
        "name": "explode_expand", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (bits)", "rows": cap, "width": w,
        "out_rows": total, "out_capacity": out.out_capacity,
        "timed": "array mode over one 2^20-row batch of N3(b)'s "
                 "map_values (3 int64 elements a row), its one size read "
                 "included",
        "ms": time_ms(lambda: A.explode_expand(*args)),
        "plain_ms": time_ms(lambda: A._explode_expand_torch(*args),
                            iters=5),
        "bound_ms": bound_ms(nbytes),
        "library_ms": time_ms(lambda: torch.repeat_interleave(
            idx, lens, output_size=total)),
        "library": "torch.repeat_interleave (the source-row half only)"}


SPLIT_DELIMS = (" ", ",", "a", "\x80")


def check_k26(device, rng) -> dict:
    """K26's count and place modes (over K25's index mode) against their
    twins, bit for bit: random UTF-8 rows with junk past every length at
    widths 8-256, delimiters at the ends and doubled, an empty string, NULL
    rows, a delimiter in the last byte of the width. Timed at N1's shape:
    one 2^20-row batch of o_comment split on ' '."""
    import torch
    from spark_rapids_tpu_torch.ops import arrays as A
    checks = 0
    for w in STRING_WIDTHS:
        col = utf8_rows(rng, 3000, 4096, w, device)
        # edge rows: '', the delimiter alone, doubled, at both ends, and
        # filling the width with the delimiter in its last byte
        for delim in SPLIT_DELIMS:
            d = delim.encode("latin-1")[0]
            data = col.data.clone()
            lens = col.lengths.clone()
            edge = [b"", bytes([d]), bytes([d, d]),
                    bytes([d]) + b"xy" + bytes([d]),
                    b"q" * (w - 1) + bytes([d]), bytes([d]) * w]
            for i, b in enumerate(edge):
                data[i] = 0
                if b:
                    data[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
                lens[i] = len(b)
            # sprinkle the delimiter inside the strings
            hit = torch.rand(data.shape, device=device) < 0.08
            data = torch.where(hit, torch.tensor(d, dtype=torch.uint8,
                                                 device=device), data)
            from spark_rapids_tpu_torch.columnar.column import Column
            valid = col.validity.clone()
            valid[:len(edge)] = True
            c = Column(col.dtype, data.contiguous(), valid, lens)
            live = torch.arange(c.capacity, device=device) < 3000
            tensor_err(A.split_count(c, d), A._split_count_torch(c, d),
                       f"K26 count w={w} delim {delim!r}")
            counts = A._split_count_torch(c, d)
            ex = A._explode_expand_torch(counts, c.validity, live)
            got = A.split_place(c, d, ex)
            want = A._split_place_torch(c, d, ex)
            _string_cols_err((got.data, got.lengths, got.validity),
                             (want.data, want.lengths, want.validity),
                             f"K26 place w={w} delim {delim!r}")
            checks += 2
    cap = 1 << 20
    col = _comments(rng, cap - 777, cap, device, null_frac=0.02)
    live = torch.arange(cap, device=device) < cap - 777
    d = ord(" ")
    counts = A.split_count(col, d)
    ex = A.explode_expand(counts, col.validity, live)
    got = A.split_place(col, d, ex)
    want = A._split_place_torch(col, d, ex)
    _string_cols_err((got.data, got.lengths, got.validity),
                     (want.data, want.lengths, want.validity),
                     "K26 N1 batch")
    checks += 1
    w = col.data.shape[1]
    lens = col.lengths.to(torch.int64)
    # count mode: every row's validity read, a valid row's bytes and
    # length read, the parts written over the capacity
    n_valid = int(col.validity.sum())
    count_bytes = (int(lens[col.validity].sum()) + n_valid * 4 +
                   cap * (1 + 4))
    # place mode: the bytes and length of each source row that has a
    # part, read once; src and pos of each output row and the total read;
    # bytes, lengths and validity written over the output capacity
    has_part = torch.zeros(cap, dtype=torch.bool, device=device)
    has_part[ex.src[:ex.count].to(torch.int64)] = True
    place_bytes = (int(lens[has_part].sum()) + int(has_part.sum()) * 4 +
                   ex.count * (4 + 4) + 8 + ex.out_capacity * (w + 4 + 1))
    count_ms = time_ms(lambda: A.split_count(col, d))
    place_ms = time_ms(lambda: A.split_place(col, d, ex))
    return {
        "name": "split_parts", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (bytes, lengths, validity)", "rows": cap,
        "width": w, "out_rows": ex.count,
        "timed": "count mode + place mode over one 2^20-row batch of "
                 "o_comment split on ' ' (N1's shape)",
        "ms": count_ms + place_ms, "count_ms": count_ms,
        "place_ms": place_ms,
        "plain_ms": time_ms(lambda: A._split_count_torch(col, d)) +
        time_ms(lambda: A._split_place_torch(col, d, ex), iters=5),
        "bound_ms": bound_ms(count_bytes + place_bytes),
        "count_bound_ms": bound_ms(count_bytes),
        "place_bound_ms": bound_ms(place_bytes),
        "library_ms": None,
        "library": "none: no PyTorch call splits strings"}


# (map type, key type, the lookup keys: column keys and scalars)
LOOKUP_CASES = (
    ("map<bigint,bigint>", "bigint", (1, 4, -7)),
    ("map<int,double>", "int", ((1 << 32) + 3, 3, 1.5)),
    ("map<double,float>", "double", (0.5, -0.0, 2, float("nan"))),
    ("map<float,int>", "float", (0.25, 3)),
    ("map<smallint,boolean>", "smallint", (5, 70000)),
    ("map<date,timestamp>", "date", (11,)),
    ("map<tinyint,tinyint>", "tinyint", (3, 300)),
    ("map<boolean,smallint>", "boolean", (True, 0)),
)


def random_map_column(rng, mtype: str, cap: int, n: int, w: int, device):
    """A MAP column of raw lanes: keys from a small range (duplicates
    inside a row, so the first match counts), NULL values, NULL maps,
    empty maps, junk lanes past every length."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import (
        Column, _bits_from_values)
    t = dt.of(mtype)

    def draw(tt, shape):
        if tt == dt.BOOL:
            return rng.integers(0, 2, shape)
        if tt.is_floating:
            return np.asarray(rng.integers(-8, 12, shape) / 4, np.float64)
        if tt == dt.INT8:
            return rng.integers(-128, 128, shape)
        return rng.integers(-6, 14, shape)
    k = draw(t.key, (cap, w))
    v = draw(t.element, (cap, w))
    mat = np.zeros((cap, 3 * w), np.int64)
    mat[:, 0::3] = (np.asarray(k, np.float64).view(np.int64)
                    if t.key.is_floating else np.asarray(k, np.int64))
    mat[:, 1::3] = (np.asarray(v, np.float64).view(np.int64)
                    if t.element.is_floating else np.asarray(v, np.int64))
    mat[:, 2::3] = rng.random((cap, w)) >= 0.15
    lengths = rng.integers(0, w + 1, cap).astype(np.int32)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) >= 0.1
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    return Column(t, torch.from_numpy(mat).to(device),
                  torch.from_numpy(valid).to(device),
                  torch.from_numpy(lengths).to(device))


def check_k27(device, rng) -> dict:
    """K27 against its twin, bit for bit, over scalar and column keys:
    duplicate keys in a row, absent keys, NULL values, NULL maps, float
    maps (float64 and float32 keys and values), a float key on an int map
    (no truncation), a bigint key on an int map (no wrap). Timed at
    N3(a)'s shape: element_at over one 2^20-row batch."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import Column, Scalar
    from spark_rapids_tpu_torch.ops import maps as M
    checks = 0
    for mtype, ktype, scalars in LOOKUP_CASES:
        for w in (4, 16, 64):
            cap = 4096
            n = cap - 100
            m = random_map_column(rng, mtype, cap, n, w, device)
            kt = dt.of(ktype)
            if kt.is_floating:
                kv = rng.integers(-8, 12, n) / 4
                kv[rng.random(n) < 0.05] = np.nan
            else:
                kv = rng.integers(-6, 14, n) if kt != dt.BOOL else \
                    rng.integers(0, 2, n)
            kcol = Column.from_numpy(kv.astype(kt.numpy_dtype), kt,
                                     rng.random(n) >= 0.1, capacity=cap,
                                     device=device)
            keys = [kcol] + [Scalar(s, dt.FLOAT64 if isinstance(s, float)
                                    else dt.BOOL if isinstance(s, bool)
                                    else dt.INT64) for s in scalars]
            for key in keys:
                kt = key.dtype
                cmp_float = m.dtype.key.is_floating or kt.is_floating
                bits_err(M.map_lookup(m, key, cmp_float),
                         M._map_lookup_torch(m, key, cmp_float),
                         f"K27 {mtype} w={w} key {kt}")
                checks += 1
    cap = 1 << 20
    m, _k, _v, live, lk = map_lanes_batch(rng, cap, cap, device)
    bits_err(M.map_lookup(m, lk, False), M._map_lookup_torch(m, lk, False),
             "K27 N3(a) batch")
    checks += 1
    # per row: the key lanes up to the match (or the length), the matched
    # value and its flag, the length, validity and key read; the value and
    # its validity written
    _keys, _vals, _vv, w = M._halves(m)
    hit = (_keys == lk.data[:, None]) & (torch.arange(w, device=device)
                                         < m.lengths[:, None].to(torch.int64))
    first = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1) + 1,
                        m.lengths.to(torch.int64))
    nbytes = int(first.sum()) * 8 + int(hit.any(dim=1).sum()) * 16 + \
        cap * (4 + 1 + 8 + 1) + cap * (8 + 1)
    return {
        "name": "map_lookup", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact (bits)", "rows": cap, "width": w,
        "timed": "element_at(m, l_orderkey % 4 + 1) over one 2^20-row "
                 "batch of create_map's 3 entries (N3(a)'s shape)",
        "ms": time_ms(lambda: M.map_lookup(m, lk, False)),
        "plain_ms": time_ms(lambda: M._map_lookup_torch(m, lk, False),
                            iters=5),
        "bound_ms": bound_ms(nbytes), "library_ms": None,
        "library": "none: no PyTorch call looks keys up in rows"}


def check_k28(device, rng) -> dict:
    """K28 against its twin, bit for bit: 1-6 pairs of integral and
    boolean keys and values of every width, duplicate keys (first
    position, last value), NULL keys (NULL map), NULL values, dead rows.
    Timed at N3's shape: 3 pairs over one 2^20-row batch."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.ops import maps as M
    types = ("bigint", "int", "smallint", "tinyint", "boolean", "date",
             "timestamp")
    checks = 0
    for p in (1, 2, 3, 4, 6):
        for trial in range(3):
            cap = 4096
            n = cap - 321
            kts = [types[(trial + j) % len(types)] for j in range(p)]
            vts = [types[(trial + 2 * j + 1) % len(types)] for j in range(p)]
            keys = []
            for kt in kts:
                c = make_column(rng, kt, cap, n, device, null_frac=0.03)
                if dt.of(kt) != dt.BOOL:
                    c.data = (c.data % 3).contiguous()
                keys.append(c)
            vals = [make_column(rng, vt, cap, n, device, null_frac=0.2)
                    for vt in vts]
            live = torch.arange(cap, device=device) < n
            mt = dt.MAP(keys[0].dtype, vals[0].dtype)
            tensor_err(M.map_build(keys, vals, live, mt).data,
                       M._map_build_torch(keys, vals, live, mt).data,
                       f"K28 {p} pairs {kts}")
            got = M.map_build(keys, vals, live, mt)
            want = M._map_build_torch(keys, vals, live, mt)
            tensor_err(got.lengths, want.lengths, f"K28 {p} lengths")
            tensor_err(got.validity, want.validity, f"K28 {p} validity")
            checks += 1
    cap = 1 << 20
    m, keys, vals, live, _lk = map_lanes_batch(rng, cap, cap, device)
    mt = m.dtype
    tensor_err(m.data, M._map_build_torch(keys, vals, live, mt).data,
               "K28 N3 batch")
    checks += 1
    w3 = m.data.shape[1]
    # 3 keys and 3 values (8 bytes and a validity byte each) and the live
    # mask read; the lanes, the length and the validity written
    nbytes = cap * (6 * 9 + 1) + cap * (w3 * 8 + 4 + 1)
    return {
        "name": "map_build", "checks": checks, "max_abs_err": 0.0,
        "tolerance": "exact", "rows": cap, "lanes": w3,
        "timed": "create_map(1, a, 2, b, 3, c) over one 2^20-row batch "
                 "of int64 columns (N3's shape)",
        "ms": time_ms(lambda: M.map_build(keys, vals, live, mt)),
        "plain_ms": time_ms(lambda: M._map_build_torch(keys, vals, live,
                                                       mt), iters=5),
        "bound_ms": bound_ms(nbytes), "library_ms": None,
        "library": "none: no PyTorch call builds map rows"}


def check_wide_keys(device, rng) -> dict:
    """9 and 17 key columns: K2's blocked lanes against the twin's lanes
    block by block and its order against the one-pass twin's; K3 and K11
    (blocks OR-ed, hashes chained through per-row seeds) against their
    one-pass twins, bit for bit."""
    import torch
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.ops import kernels as K
    cap = 1 << 16
    n = cap - 321
    out = {"phase": "wide_keys", "rows": n}
    before = native.counts()
    for n_keys in (9, 17):
        cols = [make_column(rng, WIDE_KEY_TYPES[i % len(WIDE_KEY_TYPES)],
                            cap, n, device, null_frac=0.05)
                for i in range(n_keys)]
        keys = [K.SortKey(c, i % 2 == 0, i % 3 != 0)
                for i, c in enumerate(cols)]
        lanes = K.sort_key_lanes(keys, n, cap)
        tensor_err(lanes, torch.cat([K._sort_key_lanes_torch(b, n, cap)
                                     for b in K.key_blocks(keys)]),
                   f"K2 {n_keys} keys lanes")
        order = K.lanes_order(lanes)
        tensor_err(order, K.lanes_order(K._sort_key_lanes_torch(keys, n,
                                                                cap)),
                   f"K2 {n_keys} keys order")
        srt = [K.gather_column(c, order) for c in cols]
        _k3_outputs_err(K.segment_bounds(srt, n, cap),
                        K._segment_bounds_torch(srt, n, cap),
                        f"K3 {n_keys} keys")
        for got, want, what in zip(H.murmur3(cols, cap, H.SEED, 200, n),
                                   H._murmur3_torch(cols, cap, H.SEED, 200,
                                                    n), ("hash", "pid")):
            tensor_err(got, want, f"K11 {n_keys} keys {what}")
        out[f"keys_{n_keys}"] = {
            "blocks": len(K.key_blocks(cols)), "lanes": int(lanes.shape[0]),
            "groups": int(K.segment_bounds(srt, n, cap)[2])}
    out["launches"] = {k: v - before[k] for k, v in native.counts().items()
                       if v != before[k]}
    out["checked"] = "K2 lanes and order, K3 all outputs, K11 hash and " \
                     "partition id: exact"
    return out


def check_many_partitions(device, rng) -> dict:
    """K12 above the 4096 partitions its shared memory holds: 5000 and
    65536 partitions at 2^20 rows, against its twin and itself."""
    import torch
    from spark_rapids_tpu_torch.shuffle import partitioning as P
    cap = 1 << 20
    out = {"phase": "many_partitions", "rows": cap}
    for n in (5000, 65536):
        pids = torch.randint(0, n, (cap,), dtype=torch.int32, device=device)
        for rows in (cap, cap - 4321, 0):
            got = P.partition_split(pids, rows, n)
            again = P.partition_split(pids, rows, n)
            want = P._partition_split_torch(pids, rows, n)
            for g, a, w, what in zip(got, again, want, ("perm", "counts")):
                tensor_err(g, w, f"K12 {what} n={n} rows={rows}")
                tensor_err(g, a, f"K12 {what} n={n} (two calls)")
        out[f"parts_{n}"] = {
            "ms": time_ms(lambda: P.partition_split(pids, cap, n)),
            "plain_ms": time_ms(lambda: P._partition_split_torch(
                pids, cap, n), iters=5),
            "bound_ms": bound_ms(cap * (4 + 8) + n * 4)}
    out["checked"] = "permutation and counts exact, twice alike"
    return out


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def oracle_q6(d) -> float:
    sd, disc = d["l_shipdate"], d["l_discount"]
    m = ((sd >= 8766) & (sd < 9131) & (disc >= 0.05) & (disc <= 0.07) &
         (d["l_quantity"] < 24))
    return float(np.sum(d["l_extendedprice"][m] * disc[m]))


def oracle_q1(d):
    m = d["l_shipdate"] <= 10471
    rf = d["l_returnflag"].view(np.uint32)[m].astype(np.int64)
    ls = d["l_linestatus"].view(np.uint32)[m].astype(np.int64)
    key = rf * 128 + ls
    qty = d["l_quantity"][m]
    price = d["l_extendedprice"][m]
    disc = d["l_discount"][m]
    tax = d["l_tax"][m]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    cnt = np.bincount(key, minlength=128 * 128)
    rows = []
    for k in np.nonzero(cnt)[0]:
        c = int(cnt[k])
        sel = key == k
        s_qty = int(qty[sel].sum())
        s_price = float(price[sel].sum())
        rows.append((chr(k // 128), chr(k % 128), s_qty, s_price,
                     float(disc_price[sel].sum()), float(charge[sel].sum()),
                     s_qty / c, s_price / c, float(disc[sel].sum()) / c, c))
    return rows


def close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


# what a failed comparison of a query prints beside its rows (q11: how
# close its float boundary came)
ORACLE_NOTES = {}


def check_rows(name: str, got, want, rel: float = 1e-9) -> None:
    note = ORACLE_NOTES.get(name, "")
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}"
                             f"{note}")
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                if not close(float(x), y, rel):
                    raise AssertionError(f"{name}: {g} vs oracle {w}{note}")
            elif x != y:
                raise AssertionError(f"{name}: {g} vs oracle {w}{note}")


def np_join(lk, rk):
    """Inner equi-join of two numpy key arrays by sort + searchsorted:
    (left row, right row) of every matching pair."""
    order = np.argsort(rk, kind="stable")
    srt = rk[order]
    lo = np.searchsorted(srt, lk, "left")
    cnt = np.searchsorted(srt, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    return li, order[np.arange(int(cnt.sum())) + first]


def oracle_q3(l, o, c):
    cust = np.nonzero(c["c_mktsegment"] == "BUILDING")[0]
    ords = np.nonzero(o["o_orderdate"] < 9204)[0]
    _ci, oi = np_join(c["c_custkey"][cust], o["o_custkey"][ords])
    ords = ords[oi]
    items = np.nonzero(l["l_shipdate"] > 9204)[0]
    oj, lj = np_join(o["o_orderkey"][ords], l["l_orderkey"][items])
    ords, items = ords[oj], items[lj]
    rev = l["l_extendedprice"][items] * (1.0 - l["l_discount"][items])
    keys, inv = np.unique(l["l_orderkey"][items], return_inverse=True)
    sums = np.bincount(inv, weights=rev)
    head = np.zeros(len(keys), np.int64)
    head[inv] = ords                   # every row of a group: one order
    date = o["o_orderdate"][head]
    top = np.lexsort((date, -sums))[:10]
    return [(int(keys[i]), int(date[i]), int(o["o_shippriority"][head[i]]),
             float(sums[i])) for i in top]


def oracle_q12(l, o):
    m = (np.isin(l["l_shipmode"], ["MAIL", "SHIP"]) &
         (l["l_commitdate"] < l["l_receiptdate"]) &
         (l["l_shipdate"] < l["l_commitdate"]) &
         (l["l_receiptdate"] >= 8766) & (l["l_receiptdate"] < 9131))
    items = np.nonzero(m)[0]
    oi, li = np_join(o["o_orderkey"], l["l_orderkey"][items])
    high = np.isin(o["o_orderpriority"][oi], ["1-URGENT", "2-HIGH"])
    mode = l["l_shipmode"][items[li]]
    return [(str(k), int((high & (mode == k)).sum()),
             int((~high & (mode == k)).sum())) for k in np.unique(mode)]


def oracle_q4(l, o):
    ords = np.nonzero((o["o_orderdate"] >= 8766) &
                      (o["o_orderdate"] < 8766 + 91))[0]
    late = np.unique(l["l_orderkey"][l["l_commitdate"] <
                                     l["l_receiptdate"]])
    keys = o["o_orderkey"][ords]
    pos = np.minimum(np.searchsorted(late, keys), max(len(late) - 1, 0))
    hit = (len(late) > 0) & (late[pos] == keys)
    prio = o["o_orderpriority"][ords[hit]]
    return [(str(k), int((prio == k).sum())) for k in np.unique(prio)]


def q13_order_mask(comments) -> np.ndarray:
    """The orders q13 keeps, NOT (contains 'special' AND contains
    'requests'), decided once per distinct comment."""
    uniq, inv = np.unique(comments, return_inverse=True)
    keep = np.array([not ("special" in c and "requests" in c)
                     for c in uniq.tolist()])
    return keep[inv]


def oracle_q13(o, c, mask):
    """(c_count, custdist), custdist then c_count descending: orders per
    customer (0 for one without), then customers per order count."""
    per = np.bincount(o["o_custkey"][mask],
                      minlength=len(c["c_custkey"]) + 3)[c["c_custkey"]]
    dist = np.bincount(per)
    rows = [(int(k), int(dist[k])) for k in np.nonzero(dist)[0]]
    return sorted(rows, key=lambda r: (-r[1], -r[0]))


def oracle_q11(ps, s, n, fraction: float = 0.0001):
    """(ps_partkey, value) over GERMANY's suppliers where value >
    threshold (the total times ``fraction``), value descending; and the
    relative distance of the nearest value to the threshold (a row that
    close may fall either side when the sums are added in another
    order)."""
    g = n["n_nationkey"][n["n_name"] == "GERMANY"]
    supp = s["s_suppkey"][np.isin(s["s_nationkey"], g)]
    m = np.isin(ps["ps_suppkey"], supp)
    value = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    keys, inv = np.unique(ps["ps_partkey"][m], return_inverse=True)
    sums = np.bincount(inv, weights=value)
    threshold = float(value.sum()) * fraction
    keep = sums > threshold
    order = np.lexsort((keys[keep], -sums[keep]))
    margin = float(np.min(np.abs(sums - threshold)) / threshold)
    return ([(int(k), float(v)) for k, v in
             zip(keys[keep][order], sums[keep][order])], margin)


def oracle_q15(l, s):
    """(s_suppkey, s_name, total_revenue) of the suppliers within 1e-6 of
    the top revenue of 1994's first quarter, by key."""
    m = (l["l_shipdate"] >= 8766) & (l["l_shipdate"] < 8766 + 90)
    rev = l["l_extendedprice"][m] * (1.0 - l["l_discount"][m])
    keys, inv = np.unique(l["l_suppkey"][m], return_inverse=True)
    sums = np.bincount(inv, weights=rev)
    top = sums >= sums.max() * (1.0 - 1e-6)
    name = dict(zip(s["s_suppkey"].tolist(), s["s_name"].tolist()))
    return [(int(k), name[int(k)], float(v))
            for k, v in zip(keys[top], sums[top]) if int(k) in name]


def oracle_full_outer(o, c, mask):
    """count(*), count(c_custkey), count(o_orderkey), sum(o_totalprice)
    of customer FULL OUTER JOIN q13's filtered orders on the customer
    key."""
    ck = o["o_custkey"][mask]
    known = np.isin(ck, c["c_custkey"])
    pairs = int(known.sum())
    lonely_c = int((~np.isin(c["c_custkey"], ck)).sum())
    lonely_o = int((~known).sum())
    return [(pairs + lonely_c + lonely_o, pairs + lonely_c,
             pairs + lonely_o, float(o["o_totalprice"][mask].sum()))]


def oracle_headline(n: int):
    """(key, sum, count, avg) per group of the headline over the first n
    rows of the root bench's data; sums are numpy's sequential f64 sums."""
    from spark_rapids_tpu_torch import queries
    keys, _kv, vals, vv, flags = queries.build_inputs(n, n)
    m = flags & vv & (vals > 0)
    k = keys[m]
    p = vals[m] * 2.0 + 1.0
    cnt = np.bincount(k, minlength=queries.HEADLINE_KEYS)
    sums = np.bincount(k, weights=p, minlength=queries.HEADLINE_KEYS)
    return [(int(g), float(sums[g]), int(cnt[g]), float(sums[g] / cnt[g]))
            for g in np.nonzero(cnt)[0]]


def _by_key(keys: np.ndarray, n: int) -> np.ndarray:
    """Row index of every key 1..n of a table keyed by arange(1, n + 1),
    -1 where the key is out of the table."""
    return np.where((keys >= 1) & (keys <= n), keys - 1, -1)


# q22's country codes (TPC-H's, as benchmarks/queries.py has them)
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def oracle_q22(c, o):
    """(cntrycode, numcust, totacctbal): customers of the seven phone
    country codes whose balance is above the codes' average positive
    balance and who have no order."""
    code = c["c_phone"].astype("<U2")
    keep = np.isin(code, Q22_CODES)
    bal = c["c_acctbal"]
    avg = float(np.mean(bal[keep & (bal > 0.0)]))
    sel = keep & (bal > avg) & ~np.isin(c["c_custkey"], o["o_custkey"])
    return [(str(k), int((code[sel] == k).sum()),
             float(bal[sel & (code == k)].sum()))
            for k in np.unique(code[sel])]


def oracle_q2(ps, s, n, r, p):
    """(s_acctbal, s_name, n_name, p_partkey, p_type) of EUROPE's cheapest
    suppliers of the size-15 BRASS parts, top 100."""
    rk = r["r_regionkey"][r["r_name"] == "EUROPE"]
    eu_nation = np.isin(n["n_regionkey"], rk)
    supp_nation = s["s_nationkey"]
    eu_supp = eu_nation[supp_nation]
    si = _by_key(ps["ps_suppkey"], len(s["s_suppkey"]))
    rows = np.nonzero((si >= 0) & eu_supp[np.maximum(si, 0)])[0]
    pk, cost, si = ps["ps_partkey"][rows], ps["ps_supplycost"][rows], \
        si[rows]
    min_cost = np.full(int(pk.max()) + 1, np.inf)
    np.minimum.at(min_cost, pk, cost)
    pi = _by_key(pk, len(p["p_partkey"]))
    ok = pi >= 0
    ok[ok] = (p["p_size"][pi[ok]] == 15) & \
        np.char.endswith(p["p_type"][pi[ok]], "BRASS")
    ok &= cost == min_cost[pk]
    pk, si, pi = pk[ok], si[ok], pi[ok]
    bal, sname = s["s_acctbal"][si], s["s_name"][si]
    nname = n["n_name"][supp_nation[si]]
    top = np.lexsort((pk, sname, nname, -bal))[:100]
    return [(float(bal[i]), str(sname[i]), str(nname[i]), int(pk[i]),
             str(p["p_type"][pi[i]])) for i in top]


def oracle_q17(l, p):
    """sum(l_extendedprice) / 7 over Brand#23 MED BOX parts' lines below
    0.2 x their part's average quantity."""
    part = np.zeros(int(l["l_partkey"].max()) + 1, np.bool_)
    sel = (p["p_brand"] == "Brand#23") & (p["p_container"] == "MED BOX")
    part[p["p_partkey"][sel]] = True
    pk = l["l_partkey"]
    cnt = np.bincount(pk)
    qsum = np.bincount(pk, weights=l["l_quantity"].astype(np.float64))
    limit = 0.2 * (qsum[pk] / cnt[pk])
    m = part[pk] & (l["l_quantity"] < limit)
    return [(float(l["l_extendedprice"][m].sum()) / 7.0,)]


def oracle_q5(l, o, c, s, n, r):
    """(n_name, revenue) of 1994 lines whose customer and supplier share
    an ASIA nation, revenue descending."""
    asia = np.isin(n["n_regionkey"],
                   r["r_regionkey"][r["r_name"] == "ASIA"])
    oi = l["l_orderkey"] - 1
    od = o["o_orderdate"][oi]
    ci = _by_key(o["o_custkey"][oi], len(c["c_custkey"]))
    si = _by_key(l["l_suppkey"], len(s["s_suppkey"]))
    m = (od >= 8766) & (od < 9131) & (ci >= 0) & (si >= 0)
    cn = c["c_nationkey"][np.maximum(ci, 0)]
    sn = s["s_nationkey"][np.maximum(si, 0)]
    m &= (cn == sn) & asia[sn]
    rev = np.bincount(sn[m], weights=l["l_extendedprice"][m] *
                      (1.0 - l["l_discount"][m]), minlength=25)
    hit = np.bincount(sn[m], minlength=25) > 0
    rows = [(str(n["n_name"][k]), float(rev[k])) for k in np.nonzero(hit)[0]]
    return sorted(rows, key=lambda x: -x[1])


def oracle_q10(l, o, c, n):
    """Top 20 customers by revenue of returned lines of 1994-Q1 orders."""
    oi = l["l_orderkey"] - 1
    od = o["o_orderdate"][oi]
    ck = o["o_custkey"][oi]
    m = ((od >= 8766) & (od < 8766 + 91) & (l["l_returnflag"] == "R") &
         (ck <= len(c["c_custkey"])))
    rev = np.bincount(ck[m], weights=l["l_extendedprice"][m] *
                      (1.0 - l["l_discount"][m]))
    keys = np.unique(ck[m])
    top = keys[np.lexsort((keys, -rev[keys]))[:20]]
    ci = top - 1
    return [(int(k), str(c["c_name"][i]), float(c["c_acctbal"][i]),
             str(n["n_name"][c["c_nationkey"][i]]), float(rev[k]))
            for k, i in zip(top, ci)]


def oracle_q14(l, p):
    m = (l["l_shipdate"] >= 9374) & (l["l_shipdate"] < 9374 + 30)
    pi = _by_key(l["l_partkey"][m], len(p["p_partkey"]))
    price = (l["l_extendedprice"][m] * (1.0 - l["l_discount"][m]))[pi >= 0]
    promo = np.char.startswith(p["p_type"][pi[pi >= 0]], "PROMO")
    return [(100.0 * float(np.where(promo, price, 0.0).sum()) /
             float(price.sum()),)]


def oracle_q18(l, o, c):
    """Top 100 orders by total price among those of more than 120 units,
    with their customer."""
    qty = np.bincount(l["l_orderkey"], weights=l["l_quantity"])
    keys = np.nonzero(qty > 120)[0]
    oi = keys - 1
    ck = o["o_custkey"][oi]
    ok = ck <= len(c["c_custkey"])
    keys, oi, ck = keys[ok], oi[ok], ck[ok]
    price, date = o["o_totalprice"][oi], o["o_orderdate"][oi]
    top = np.lexsort((date, -price))[:100]
    return [(str(c["c_name"][ck[i] - 1]), int(ck[i]), int(keys[i]),
             int(date[i]), float(price[i]), int(qty[keys[i]])) for i in top]


def oracle_q19(l, p):
    m = np.isin(l["l_shipmode"], ["AIR", "REG AIR"])
    pi = _by_key(l["l_partkey"], len(p["p_partkey"]))
    m &= pi >= 0
    q = l["l_quantity"][m]
    pi = pi[m]
    brand, cont, size = p["p_brand"][pi], p["p_container"][pi], \
        p["p_size"][pi]
    hit = np.zeros(len(q), np.bool_)
    for b, conts, lo, hi, smax in (
            ("Brand#12", ("SM CASE", "SM BOX"), 1, 11, 5),
            ("Brand#23", ("MED BAG", "MED BOX"), 10, 20, 10),
            ("Brand#34", ("LG CASE", "LG BOX"), 20, 30, 15)):
        hit |= ((brand == b) & np.isin(cont, conts) & (q >= lo) &
                (q <= hi) & (size <= smax))
    price = l["l_extendedprice"][m] * (1.0 - l["l_discount"][m])
    return [(float(price[hit].sum()),)]


def oracle_q20(l, ps, p, s, n):
    """CANADA's suppliers holding more of a TIN part than half its 1994
    volume, by name."""
    tin = np.zeros(len(p["p_partkey"]) + 2, np.bool_)
    tin[p["p_partkey"][np.char.find(p["p_type"], "TIN") >= 0]] = True
    m = (l["l_shipdate"] >= 8766) & (l["l_shipdate"] < 9131)
    span = int(l["l_suppkey"].max()) + 1
    lkey = l["l_partkey"][m] * span + l["l_suppkey"][m]
    keys, inv = np.unique(lkey, return_inverse=True)
    half = 0.5 * np.bincount(inv, weights=l["l_quantity"][m])
    psk = ps["ps_partkey"] * span + ps["ps_suppkey"]
    pos = np.minimum(np.searchsorted(keys, psk), len(keys) - 1)
    found = keys[pos] == psk
    qual = found & tin[ps["ps_partkey"]] & \
        (ps["ps_availqty"] > np.where(found, half[pos], np.inf))
    canada = n["n_nationkey"][n["n_name"] == "CANADA"]
    supp = np.isin(s["s_nationkey"], canada) & \
        np.isin(s["s_suppkey"], ps["ps_suppkey"][qual])
    return [(str(x),) for x in np.sort(s["s_name"][supp])]


def years_of(days: np.ndarray) -> np.ndarray:
    """The calendar year of each day count since 1970-01-01."""
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _ps_rows(l, ps):
    """Row of partsupp holding each line's (partkey, suppkey), -1 where
    none does."""
    span = int(max(l["l_suppkey"].max(), ps["ps_suppkey"].max())) + 1
    psk = ps["ps_partkey"] * span + ps["ps_suppkey"]
    order = np.argsort(psk, kind="stable")
    srt = psk[order]
    lk = l["l_partkey"] * span + l["l_suppkey"]
    pos = np.minimum(np.searchsorted(srt, lk), len(srt) - 1)
    return np.where(srt[pos] == lk, order[pos], -1)


def oracle_q7(l, o, c, s, n):
    """Revenue shipped between FRANCE and GERMANY in 1995-1996 by
    (supplier nation, customer nation, year)."""
    names = n["n_name"]
    fr = int(np.nonzero(names == "FRANCE")[0][0])
    de = int(np.nonzero(names == "GERMANY")[0][0])
    sd = l["l_shipdate"]
    si = _by_key(l["l_suppkey"], len(s["s_suppkey"]))
    ci = _by_key(o["o_custkey"][l["l_orderkey"] - 1], len(c["c_custkey"]))
    m = (sd >= 9131) & (sd <= 9131 + 730) & (si >= 0) & (ci >= 0)
    sn = s["s_nationkey"][np.maximum(si, 0)]
    cn = c["c_nationkey"][np.maximum(ci, 0)]
    m &= ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    key = (sn[m] * 25 + cn[m]) * 10000 + years_of(sd[m])
    vol = l["l_extendedprice"][m] * (1.0 - l["l_discount"][m])
    keys, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=vol)
    rows = [(str(names[k // 10000 // 25]), str(names[k // 10000 % 25]),
             int(k % 10000), float(v)) for k, v in zip(keys, sums)]
    return sorted(rows, key=lambda r: (r[0], r[1], r[2]))


def oracle_q8(l, o, c, s, n, r, p):
    """BRAZIL's share of AMERICA's ECONOMY ANODIZED STEEL volume in
    1995-1996, by order year."""
    america = np.isin(n["n_regionkey"],
                      r["r_regionkey"][r["r_name"] == "AMERICA"])
    pi = _by_key(l["l_partkey"], len(p["p_partkey"]))
    si = _by_key(l["l_suppkey"], len(s["s_suppkey"]))
    oi = l["l_orderkey"] - 1
    od = o["o_orderdate"][oi]
    ci = _by_key(o["o_custkey"][oi], len(c["c_custkey"]))
    steel = p["p_type"] == "ECONOMY ANODIZED STEEL"     # per part
    m = (pi >= 0) & (si >= 0) & (ci >= 0) & (od >= 9131) & \
        (od <= 9131 + 730)
    m &= steel[np.maximum(pi, 0)]
    m &= america[c["c_nationkey"][np.maximum(ci, 0)]]
    vol = l["l_extendedprice"][m] * (1.0 - l["l_discount"][m])
    brazil = n["n_name"][s["s_nationkey"][si[m]]] == "BRAZIL"
    years, inv = np.unique(years_of(od[m]), return_inverse=True)
    num = np.bincount(inv, weights=np.where(brazil, vol, 0.0))
    den = np.bincount(inv, weights=vol)
    return [(int(y), float(a / b)) for y, a, b in zip(years, num, den)]


def oracle_q9(l, o, s, ps, n, p):
    """Profit of BRUSHED parts' lines by (supplier nation, order year),
    nation ascending, year descending."""
    pi = _by_key(l["l_partkey"], len(p["p_partkey"]))
    si = _by_key(l["l_suppkey"], len(s["s_suppkey"]))
    brushed = np.char.find(p["p_type"], "BRUSHED") >= 0  # per part
    m = (pi >= 0) & (si >= 0)
    m &= brushed[np.maximum(pi, 0)]
    rows = np.nonzero(m)[0]
    pr = np.full(len(m), -1)
    pr[rows] = _ps_rows({k: l[k][rows] for k in ("l_partkey", "l_suppkey")},
                        ps)
    m &= pr >= 0
    amount = l["l_extendedprice"][m] * (1.0 - l["l_discount"][m]) - \
        ps["ps_supplycost"][pr[m]] * l["l_quantity"][m]
    nation = s["s_nationkey"][si[m]]
    key = nation * 10000 + years_of(o["o_orderdate"][l["l_orderkey"][m] -
                                                       1])
    keys, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=amount)
    rows = [(str(n["n_name"][k // 10000]), int(k % 10000), float(v))
            for k, v in zip(keys, sums)]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def oracle_q16(ps, s, p):
    from spark_rapids_tpu_torch.queries import Q16_SIZES
    bad = s["s_suppkey"][s["s_acctbal"] < 0]
    keep = (p["p_brand"] != "Brand#45") & \
        ~np.char.startswith(p["p_type"], "MEDIUM POLISHED") & \
        np.isin(p["p_size"], Q16_SIZES)
    # p_partkey is 1..n: a partsupp row's part is row ps_partkey - 1
    pidx = ps["ps_partkey"] - 1
    inpart = pidx < len(keep)
    rows = np.nonzero(inpart & ~np.isin(ps["ps_suppkey"], bad))[0]
    rows = rows[keep[pidx[rows]]]
    pidx = pidx[rows]
    # (brand, type, size) as one integer: codes in string order
    brands, bcode = np.unique(p["p_brand"], return_inverse=True)
    types, tcode = np.unique(p["p_type"], return_inverse=True)
    gkey = (bcode[pidx] * len(types) + tcode[pidx]) * 64 + p["p_size"][pidx]
    groups, ginv = np.unique(gkey, return_inverse=True)
    cnt = _distinct_per_key(ginv, ps["ps_suppkey"][rows], len(groups))
    order = np.lexsort((groups, -cnt))   # codes sort as the strings do
    return [(str(brands[g // 64 // len(types)]),
             str(types[g // 64 % len(types)]), int(g % 64), int(cnt[k]))
            for k, g in zip(order, groups[order])]


def _distinct_per_key(keys, vals, n_keys: int):
    """count(DISTINCT vals) per key (keys in [0, n_keys)): one sort of the
    (key, val) pairs and the changes along it. Not np.unique, whose method
    differs between numpy releases: q21's oracle, the one caller, runs it
    over lineitem's 60 M pairs and was the smoke's slowest on the card's
    host."""
    pairs = np.sort(keys.astype(np.int64) * (1 << 32) + vals)
    first = np.ones(len(pairs), bool)
    first[1:] = pairs[1:] != pairs[:-1]
    return np.bincount(pairs[first] >> 32, minlength=n_keys)


def oracle_q21(l, o, s, n):
    n_ord = len(o["o_orderkey"]) + 1     # o_orderkey is 1..n
    nsupp = _distinct_per_key(l["l_orderkey"], l["l_suppkey"], n_ord)
    late = l["l_receiptdate"] > l["l_commitdate"]
    nlate = _distinct_per_key(l["l_orderkey"][late], l["l_suppkey"][late],
                              n_ord)
    status_f = np.zeros(n_ord, bool)
    status_f[o["o_orderkey"][o["o_orderstatus"] == "F"]] = True
    france = n["n_nationkey"][n["n_name"] == "FRANCE"][0]
    fr_supp = np.zeros(len(s["s_suppkey"]) + 1, bool)   # s_suppkey is 1..n
    fr_supp[s["s_suppkey"][s["s_nationkey"] == france]] = True
    ok, sk = l["l_orderkey"][late], l["l_suppkey"][late]
    sel = status_f[ok] & fr_supp[sk] & (nsupp[ok] >= 2) & (nlate[ok] == 1)
    cnt = np.bincount(sk[sel], minlength=len(fr_supp))
    out = [(str(s["s_name"][k - 1]), int(cnt[k]))
           for k in np.nonzero(cnt)[0]]
    out.sort(key=lambda r: (-r[1], r[0]))
    return out[:100]


def _cents(x):
    return np.rint(np.asarray(x) * 100).astype(np.int64)


def oracle_tpcds_q98(ss, d, i):
    d0 = d["d_date_sk"][0]
    item_ok = np.isin(i["i_category"], ("Books", "Home", "Sports"))
    date = ss["ss_sold_date_sk"]
    it = ss["ss_item_sk"] - 1                         # i_item_sk is 1..n
    sel = (date >= d0 + 45) & (date <= d0 + 75) & item_ok[it]
    rev = np.bincount(it[sel], weights=_cents(ss["ss_ext_sales_price"][sel]),
                      minlength=len(item_ok)).astype(np.int64)
    has = np.bincount(it[sel], minlength=len(item_ok)) > 0
    cls, cinv = np.unique(i["i_class"], return_inverse=True)
    class_rev = np.bincount(cinv[has], weights=rev[has], minlength=len(cls))
    rows = []
    for k in np.nonzero(has)[0]:
        r = rev[k] / 100.0
        rows.append((str(i["i_item_id"][k]), str(i["i_category"][k]),
                     str(i["i_class"][k]), float(i["i_current_price"][k]),
                     r, r * 100 / (class_rev[cinv[k]] / 100.0)))
    rows.sort(key=lambda r: (r[1], r[2], r[0], r[3], r[5]))
    return rows[:100]


def oracle_tpcds_q89(ss, d, i, st):
    """(rows, margin): the 100 rows and how near the nearest monthly sum
    came to its 10% threshold, relative."""
    d0 = d["d_date_sk"][0]
    day = ss["ss_sold_date_sk"] - d0
    year = d["d_year"][np.clip(day, 0, len(d["d_year"]) - 1)]
    item_ok = np.isin(i["i_category"], ("Books", "Electronics", "Sports"))
    it = ss["ss_item_sk"] - 1                         # i_item_sk is 1..n
    sel = (day >= 0) & (day < len(d["d_year"])) & (year == 1999) & \
        item_ok[it] & (ss["ss_unit_sk"] <= len(st["s_store_sk"]))
    it, day = it[sel], day[sel]
    store = ss["ss_unit_sk"][sel] - 1                 # s_store_sk is 1..n
    # group (category, class, brand, store, month); every code is in the
    # order of its strings (brand ids through their "brand#N" strings)
    cats, cat = np.unique(i["i_category"], return_inverse=True)
    clss, cls = np.unique(i["i_class"], return_inverse=True)
    brands, brand = np.unique(i["i_brand"], return_inverse=True)
    nb, nc = len(brands), len(clss)
    key = ((((cat[it] * nc + cls[it]) * nb + brand[it]) * 16 + store) * 16 +
           d["d_moy"][day])
    gk, ginv = np.unique(key, return_inverse=True)
    gsum = np.bincount(ginv, weights=_cents(ss["ss_sales_price"][sel]))
    g_moy, rest = gk % 16, gk // 16
    g_store, rest = rest % 16, rest // 16
    g_brand, rest = rest % nb, rest // nb
    g_cls, g_cat = rest % nc, rest // nc
    # the window: avg over (category, brand, store)
    _wk, winv = np.unique((g_cat * nb + g_brand) * 16 + g_store,
                          return_inverse=True)
    avg = np.bincount(winv, weights=gsum)[winv] / 100.0 / \
        np.bincount(winv)[winv]
    sums = gsum / 100.0
    dev = sums - avg
    margin = float(np.min(np.abs(np.abs(dev) - np.abs(avg) * 0.1) /
                          np.maximum(np.abs(avg), 1e-300)))
    hit = np.nonzero((dev > avg * 0.1) | (dev < avg * -0.1))[0]
    top = hit[np.lexsort((g_moy[hit], g_store[hit], g_brand[hit],
                          g_cls[hit], g_cat[hit]))][:100]
    return [(str(cats[g_cat[k]]), str(clss[g_cls[k]]),
             str(brands[g_brand[k]]), str(st["s_store_id"][g_store[k]]),
             int(g_moy[k]), float(sums[k]), float(avg[k])) for k in top], \
        margin


def q11_scaled(t, fraction: float):
    """q11 with its threshold fraction given: benchmarks/queries.py keeps
    0.0001 whatever the scale, which at SF 10 leaves no part above it; the
    TPC-H rule is 0.0001 / SF."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col, lit
    n = t["nation"].filter(col("n_name") == lit("GERMANY"))
    s = t["supplier"].join(n, on=(col("s_nationkey") == col("n_nationkey")))
    ps = t["partsupp"].join(s, on=(col("ps_suppkey") == col("s_suppkey")))
    value = col("ps_supplycost") * col("ps_availqty")
    per_part = ps.groupBy("ps_partkey").agg(F.sum(value).alias("value"))
    total = ps.agg((F.sum(value) * lit(fraction)).alias("threshold"))
    return (per_part.crossJoin(total)
            .filter(col("value") > col("threshold"))
            .select(col("ps_partkey"), col("value"))
            .orderBy(col("value").desc(), col("ps_partkey").asc()))


def q11_with_rows(session, tables, data, sf: float) -> dict:
    """q11 at the TPC-H fraction 0.0001 / SF, against the numpy oracle at
    that fraction; it must return rows."""
    fraction = 0.0001 / sf
    want, margin = oracle_q11(data["partsupp"], data["supplier"],
                              data["nation"], fraction)
    ORACLE_NOTES["q11_scaled"] = f" (nearest value {margin:.3e} relative " \
                                 f"from the threshold)"
    t0 = time.perf_counter()
    rows = q11_scaled(tables, fraction).collect()
    seconds = time.perf_counter() - t0
    check_rows("q11_scaled", rows, want)
    if not rows:
        raise AssertionError("q11 at 0.0001 / SF returned no row")
    return {"phase": "q11_scaled", "fraction": fraction, "rows": len(rows),
            "seconds": seconds, "nearest_relative_margin": margin,
            "oracle": "numpy, relative 1e-9"}


# -- The string expressions through the session -------------------------------

def spark_substring(s: str, pos: int, length: int) -> str:
    """UTF8String.substringSQL over characters."""
    k = len(s)
    start = pos - 1 if pos > 0 else (k + pos if pos < 0 else 0)
    end = start + length
    start = max(start, 0)
    return "" if start >= end else s[start:end]


def spark_pad(s: str, width: int, pad: str, left: bool) -> str:
    """UTF8String.lpad/rpad over bytes (the port's declared stance)."""
    b, p = s.encode("utf-8"), pad.encode("utf-8")
    if width - len(b) <= 0 or not p:
        return b[:max(width, 0)].decode("utf-8", errors="replace")
    fill = (p * width)[:width - len(b)]
    return (fill + b if left else b + fill).decode("utf-8")


def initcap_ascii(s: str) -> str:
    return "".join(ch.upper() if i == 0 or s[i - 1] == " " else ch.lower()
                   for i, ch in enumerate(s))


def _per_value(values: np.ndarray, fn) -> np.ndarray:
    """``fn`` over each distinct value, mapped back to the rows."""
    uniq, inv = np.unique(values, return_inverse=True)
    out = np.array([fn(v) for v in uniq.tolist()])
    return out[inv]


def _string_exprs_spec(F, col, lit):
    """(table, [(name, Col, oracle over the table's numpy columns)])."""
    cust = [
        ("length_name", F.length(col("c_name")),
         lambda d: _per_value(d["c_name"], len)),
        ("upper_segment", F.upper(col("c_mktsegment")),
         lambda d: np.char.upper(d["c_mktsegment"])),
        ("lower_name", F.lower(col("c_name")),
         lambda d: np.char.lower(d["c_name"])),
        ("initcap_segment", F.initcap(F.lower(col("c_mktsegment"))),
         lambda d: _per_value(d["c_mktsegment"],
                              lambda s: initcap_ascii(s.lower()))),
        ("phone_code", F.substring(col("c_phone"), 1, 2),
         lambda d: d["c_phone"].astype("<U2")),
        ("phone_from_0", F.substring(col("c_phone"), 0, 3),
         lambda d: d["c_phone"].astype("<U3")),
        ("phone_tail", F.substring(col("c_phone"), -4, 4),
         lambda d: _per_value(d["c_phone"],
                              lambda s: spark_substring(s, -4, 4))),
        ("name_before_start", F.substring(col("c_name"), -20, 12),
         lambda d: _per_value(d["c_name"],
                              lambda s: spark_substring(s, -20, 12))),
        ("name_phone", F.concat(col("c_name"), lit("-"), col("c_phone")),
         lambda d: np.char.add(np.char.add(d["c_name"], "-"),
                               d["c_phone"])),
        ("trim", F.trim(F.lpad(col("c_mktsegment"), 12, " ")),
         lambda d: d["c_mktsegment"]),
        ("ltrim", F.ltrim(F.lpad(col("c_mktsegment"), 12, " ")),
         lambda d: d["c_mktsegment"]),
        ("rtrim", F.rtrim(F.rpad(col("c_mktsegment"), 14, " ")),
         lambda d: d["c_mktsegment"]),
        ("lpad_segment", F.lpad(col("c_mktsegment"), 12, "*-"),
         lambda d: _per_value(d["c_mktsegment"],
                              lambda s: spark_pad(s, 12, "*-", True))),
        ("rpad_cut_name", F.rpad(col("c_name"), 10, "."),
         lambda d: _per_value(d["c_name"],
                              lambda s: spark_pad(s, 10, ".", False))),
        ("locate_zero", F.locate("0", col("c_name")),
         lambda d: np.char.find(d["c_name"], "0") + 1),
        ("instr_dash", F.instr(col("c_phone"), "-"),
         lambda d: np.char.find(d["c_phone"], "-") + 1),
        ("like_eq", col("c_mktsegment").like("BUILDING"),
         lambda d: d["c_mktsegment"] == "BUILDING"),
        ("like_contains", col("c_name").like("%#0000001%"),
         lambda d: np.char.find(d["c_name"], "#0000001") >= 0),
        ("like_prefix", col("c_phone").like("13-%"),
         lambda d: np.char.startswith(d["c_phone"], "13-")),
        ("like_suffix", col("c_name").like("%7"),
         lambda d: np.char.endswith(d["c_name"], "7")),
        ("like_general", col("c_phone").like("1_-%"),
         lambda d: (d["c_phone"].astype("<U1") == "1") &
         (np.char.find(d["c_phone"], "-") == 2)),
        ("replace_segment", F.replace(col("c_mktsegment"), "I", "ii"),
         lambda d: np.char.replace(d["c_mktsegment"], "I", "ii")),
    ]
    part = [
        ("length_type", F.length(col("p_type")),
         lambda d: np.char.str_len(d["p_type"])),
        ("upper_lower_type", F.upper(F.lower(col("p_type"))),
         lambda d: d["p_type"]),
        ("initcap_type", F.initcap(F.lower(col("p_type"))),
         lambda d: _per_value(d["p_type"],
                              lambda s: initcap_ascii(s.lower()))),
        ("type_tail", F.substring(col("p_type"), -5, 5),
         lambda d: _per_value(d["p_type"],
                              lambda s: spark_substring(s, -5, 5))),
        ("locate_brass", F.locate("BRASS", col("p_type")),
         lambda d: np.char.find(d["p_type"], "BRASS") + 1),
        ("brand_container", F.concat(col("p_brand"), lit(" "),
                                     col("p_container")),
         lambda d: np.char.add(np.char.add(d["p_brand"], " "),
                               d["p_container"])),
        ("rpad_container", F.rpad(col("p_container"), 12, "_"),
         lambda d: _per_value(d["p_container"],
                              lambda s: spark_pad(s, 12, "_", False))),
        ("lpad_cut_brand", F.lpad(col("p_brand"), 6, "#"),
         lambda d: _per_value(d["p_brand"],
                              lambda s: spark_pad(s, 6, "#", True))),
        ("like_brass", col("p_type").like("%BRASS"),
         lambda d: np.char.endswith(d["p_type"], "BRASS")),
        ("like_promo", col("p_type").like("PROMO%"),
         lambda d: np.char.startswith(d["p_type"], "PROMO")),
        ("like_general_box", col("p_container").like("%_BOX"),
         lambda d: np.char.endswith(d["p_container"], "BOX") &
         (np.char.str_len(d["p_container"]) >= 4)),
        ("replace_brand", F.replace(col("p_brand"), "#", "##"),
         lambda d: np.char.replace(d["p_brand"], "#", "##")),
    ]
    return (("customer", "c_custkey", cust), ("part", "p_partkey", part))


def _column_err(col, n: int, want: np.ndarray, what: str) -> None:
    """A result column against its oracle: strings byte for byte within
    their lengths, ints and bools exactly; no row NULL."""
    valid = col.validity[:n].cpu().numpy()
    if not valid.all():
        raise AssertionError(f"string_exprs {what}: NULL rows")
    if col.data.dim() == 2:
        b = np.char.encode(np.asarray(want), "utf-8")
        wl = np.char.str_len(b)
        lens = col.lengths[:n].cpu().numpy()
        if not np.array_equal(lens, wl):
            bad = np.nonzero(lens != wl)[0][:3].tolist()
            raise AssertionError(f"string_exprs {what}: lengths differ at "
                                 f"{bad}")
        wb = max(b.dtype.itemsize, 1)
        mat = np.frombuffer(b.tobytes(), np.uint8).reshape(n, wb) \
            if b.dtype.itemsize else np.zeros((n, 1), np.uint8)
        k = min(wb, col.data.shape[1])
        got = col.data[:n, :k].cpu().numpy()
        inside = np.arange(k)[None, :] < lens[:, None]
        if not np.array_equal(np.where(inside, got, 0),
                              np.where(inside, mat[:, :k], 0)):
            raise AssertionError(f"string_exprs {what}: bytes differ")
    else:
        got = col.data[:n].cpu().numpy()
        if not np.array_equal(got, np.asarray(want).astype(got.dtype)):
            bad = np.nonzero(got != np.asarray(want))[0][:3].tolist()
            raise AssertionError(f"string_exprs {what}: differs at {bad}")


# the expressions the reference runs on the host, one pass per scan batch
HOST_EXPRS = {"customer": {"like": 1, "replace": 1},
              "part": {"like": 1, "replace": 1}}


def string_exprs(tables, data) -> dict:
    """Length, case maps, substrings, concat, trims, pads, locate, LIKE
    and replace through the session over customer and part, each column
    held to a Python oracle (Spark's rules, bytes for the pads); the host
    string passes must be exactly the general LIKE's and replace's, one
    per scan batch."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col, lit
    out = {"phase": "string_exprs", "tables": {}}
    for table, key, spec in _string_exprs_spec(F, col, lit):
        d = data[table]
        n = len(d[key])
        host = native.host_counts()
        t0 = time.perf_counter()
        batch = tables[table].select(
            col(key), *[c.alias(name) for name, c, _f in spec]).collect_batch()
        seconds = time.perf_counter() - t0
        passes = {k: v - host[k] for k, v in native.host_counts().items()}
        if batch.num_rows != n:
            raise AssertionError(f"string_exprs {table}: {batch.num_rows} "
                                 f"rows, table {n}")
        _column_err(batch.columns[0], n, d[key], f"{table} {key}")
        t1 = time.perf_counter()
        for (name, _c, oracle), c in zip(spec, batch.columns[1:]):
            _column_err(c, n, oracle(d), f"{table} {name}")
        batches = -(-n // (1 << 20))
        want = {k: v * batches for k, v in HOST_EXPRS[table].items()}
        if {k: v for k, v in passes.items() if v} != want:
            raise AssertionError(f"string_exprs {table}: host passes "
                                 f"{passes}, expected {want}")
        out["tables"][table] = {
            "rows": n, "columns": [name for name, _c, _f in spec],
            "seconds": seconds, "oracle_s": time.perf_counter() - t1,
            "host_string_passes": passes}
    out["oracle"] = "Python: Spark's rules (bytes for the pads), exact"
    return out


PATH_KERNELS = {
    "headline": ("dense_stats", "slot_aggregate", "compact_scan"),
    "q6": ("masked_reduce",),
    "q1": ("sort_key_lanes", "segment_bounds", "segment_reduce"),
    "q3": ("compact_scan", "murmur3", "partition_split", "sort_key_lanes",
           "join_probe", "join_probe_lower", "join_expand",
           "segment_bounds", "segment_reduce"),
    "q12": ("compact_scan", "murmur3", "partition_split", "sort_key_lanes",
            "join_probe", "join_probe_lower", "join_expand",
            "segment_bounds", "segment_reduce"),
    "q4": ("compact_scan", "murmur3", "partition_split", "sort_key_lanes",
           "join_probe", "join_probe_lower", "segment_bounds",
           "slot_aggregate", "segment_reduce"),
    "q13": ("find_pattern", "compact_scan", "murmur3", "partition_split",
            "sort_key_lanes", "join_probe", "join_probe_lower",
            "join_expand_outer", "segment_bounds", "segment_reduce"),
    "q11": ("sort_key_lanes", "join_probe", "join_expand", "cross_expand",
            "compact_scan"),
    "q15": ("compact_scan", "sort_key_lanes", "join_probe", "join_expand",
            "cross_expand"),
    "q22": ("string_slice", "compact_scan", "cross_expand", "murmur3",
            "partition_split", "join_probe"),
    "q2": ("find_pattern", "sort_key_lanes", "join_probe", "join_expand"),
    "q17": ("compact_scan", "join_probe", "join_expand"),
    "q5": ("compact_scan", "join_probe", "join_expand"),
    "q10": ("compact_scan", "sort_key_lanes", "join_probe", "join_expand"),
    "q14": ("find_pattern", "compact_scan", "join_probe", "join_expand"),
    "q18": ("sort_key_lanes", "join_probe", "join_expand"),
    "q19": ("compact_scan", "join_probe", "join_expand"),
    "q20": ("find_pattern", "compact_scan", "join_probe"),
    "q7": ("compact_scan", "join_probe", "join_expand"),
    "q8": ("compact_scan", "join_probe", "join_expand"),
    "q9": ("find_pattern", "compact_scan", "join_probe", "join_expand"),
    "string_exprs": ("string_map", "string_slice", "string_place",
                     "find_pattern_locate", "find_pattern"),
    # the DISTINCT rewrite: two aggregates on the sort route
    "q16": ("sort_key_lanes", "join_probe", "segment_bounds",
            "segment_reduce"),
    "q21": ("compact_scan", "sort_key_lanes", "join_probe",
            "segment_bounds", "segment_reduce"),
    # whole-partition windows: the sort, K3 and K4 + a gather
    "tpcds_q98": ("compact_scan", "sort_key_lanes", "join_probe",
                  "segment_bounds", "segment_reduce"),
    "tpcds_q89": ("compact_scan", "sort_key_lanes", "join_probe",
                  "segment_bounds", "segment_reduce"),
    # N1-N4: split and explode, map build, lookup and explode
    "nested": ("split_parts", "explode_expand", "map_build", "map_lookup"),
}
# the counter of each kind of generated kernel a plan's units carry
GENERATED_COUNTER = {"K19 fused_stage": "fused_stage",
                     "K20 fused_reduce": "fused_reduce"}
# the operators q3, q4, q12 and q13 must run on at SF 10: the reference's
# shuffled plan (their build sides are far above the 10 MiB threshold);
# q11 and q15 must cross-join their scalar subqueries
SHUFFLED_OPERATORS = ("TpuShuffledJoinExec", "TpuHashExchangeExec",
                      "TpuRangeExchangeExec")
REQUIRED_OPERATORS = {"q3": SHUFFLED_OPERATORS, "q12": SHUFFLED_OPERATORS,
                      "q4": SHUFFLED_OPERATORS, "q13": SHUFFLED_OPERATORS,
                      "q11": ("TpuCrossJoinExec",),
                      "q15": ("TpuCrossJoinExec",),
                      # the left anti join against 15 M orders, shuffled
                      "q22": ("TpuCrossJoinExec", "TpuShuffledJoinExec",
                              "TpuHashExchangeExec"),
                      "tpcds_q98": ("TpuWindowExec",),
                      "tpcds_q89": ("TpuWindowExec",)}
# launched by their own phase, not by the main path
PHASE_KERNELS = {"singleword_rank": "check_k10: groupby_singleword at 2^20 "
                 "rows (no engine path calls the single-word route)",
                 "build_matched": "outer_forms: customer FULL OUTER JOIN "
                 "q13's filtered orders (no main-path query is a full "
                 "outer join)",
                 "exchange_bucket": "mesh: M1-M5 over 4 mesh workers on "
                 "one card (with mesh.enabled at its default, auto, one "
                 "card gives no mesh)",
                 "exchange_flatten": "mesh: M1-M5 over 4 mesh workers on "
                 "one card (with mesh.enabled at its default, auto, one "
                 "card gives no mesh)"}


# ---------------------------------------------------------------------------
# The windows phase (W1-W6): K21-K24 at the sizes users run them
# ---------------------------------------------------------------------------

# the kernels each window must launch in its cold run
WINDOW_KERNELS = {
    "W1": ("sort_key_lanes", "segment_bounds", "window_rank"),
    "W2": ("window_offset",),
    "W3": ("segmented_scan",),
    "W4": ("frame_bounds", "segmented_scan", "frame_aggregate"),
    "W5": ("frame_bounds", "segmented_scan", "frame_aggregate"),
    "W6": ("segment_reduce",)}


def window_queries(t) -> dict:
    """W1-W6: ranks, offsets and running aggregates over orders (about 10
    rows a customer), bounded ROWS and RANGE frames and a whole-partition
    sum over lineitem (about 600 rows a supplier). Each selects its window
    columns alone, in the table's row order. Ties in an order keep the
    table's row order (stable sorts), as numpy's lexsort does."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window
    o, l = t["orders"], t["lineitem"]
    by_date = Window.partitionBy("o_custkey").orderBy("o_orderdate",
                                                      "o_orderkey")
    by_prio = Window.partitionBy("o_custkey").orderBy("o_orderpriority")
    run = by_date.rowsBetween(Window.unboundedPreceding, Window.currentRow)
    li = Window.partitionBy("l_suppkey").orderBy("l_shipdate", "l_orderkey")
    near = li.rowsBetween(-3, 3)
    tp, q = "o_totalprice", "l_quantity"
    return {
        "W1": o.select(F.row_number().over(by_date).alias("rn"),
                       F.rank().over(by_prio).alias("rk"),
                       F.dense_rank().over(by_prio).alias("dr")),
        "W2": o.select(F.lag("o_orderpriority", 1).over(by_date)
                       .alias("prev_priority"),
                       F.lead(tp, 2, 0.0).over(by_date).alias("next2")),
        "W3": o.select(F.sum(tp).over(run).alias("s"),
                       F.count(tp).over(run).alias("c"),
                       F.min(tp).over(run).alias("mn"),
                       F.max(tp).over(run).alias("mx"),
                       F.avg(tp).over(run).alias("a")),
        "W4": l.select(F.avg(q).over(near).alias("a"),
                       F.min(q).over(near).alias("mn"),
                       F.max(q).over(near).alias("mx"),
                       F.count("*").over(near).alias("c"),
                       F.max(q).over(li.rowsBetween(
                           -7, Window.unboundedFollowing)).alias("mx_on")),
        "W5": l.select(F.sum("l_extendedprice").over(
            Window.partitionBy("l_suppkey").orderBy("l_shipdate")
            .rangeBetween(-30, 0)).alias("rev30")),
        "W6": l.select(F.sum("l_extendedprice").over(
            Window.partitionBy("l_suppkey")).alias("rev"))}


def _sort_rows(*keys, stable: bool = True):
    """The permutation that sorts rows by integer ``keys``, most
    significant first (``stable``: ties keep row order): one argsort of the
    keys packed into an int64 where they fit in 63 bits, else
    np.lexsort."""
    cols = [np.asarray(k, np.int64) - int(np.min(k)) for k in keys]
    bits = [max(1, int(c.max()).bit_length()) for c in cols]
    if sum(bits) > 63:
        return np.lexsort(cols[::-1])
    packed = np.zeros(len(cols[0]), np.int64)
    for c, b in zip(cols, bits):
        packed = (packed << b) | c
    return np.argsort(packed, kind="stable" if stable else "quicksort")


class _Segments:
    """A numpy sort of the table by integer keys, its segments over the
    first key and each sorted row's segment start."""

    def __init__(self, *keys, stable: bool = True):
        self.perm = _sort_rows(*keys, stable=stable)
        self.part = keys[0][self.perm]
        n = len(self.part)
        self.idx = np.arange(n)
        self.start = np.r_[True, self.part[1:] != self.part[:-1]]
        self.first = np.maximum.accumulate(np.where(self.start, self.idx, 0))
        self.rank = np.cumsum(self.start) - 1     # segment number

    def shifted(self, values, off: int):
        """(values of sorted row i + off, whether it is in i's segment)."""
        j = self.idx + off
        ok = (j >= 0) & (j < len(j))
        jc = np.clip(j, 0, len(j) - 1)
        ok &= self.rank[jc] == self.rank
        return values[jc], ok

    def running(self, values, fn):
        """Segmented running max (fn=np.maximum) or min of nonnegative int64
        values in sorted order."""
        big = int(values.max()) + 1
        if fn is np.maximum:
            return fn.accumulate(values + self.rank * big) - self.rank * big
        return fn.accumulate(values - self.rank * big) + self.rank * big


def merge_window_parts(parts) -> tuple:
    """(expected, orders) of the windows phase from the parts'
    (:func:`window_oracles_orders`, :func:`window_oracles_rows`,
    :func:`window_oracles_range`, independent jobs of :class:`Oracles`):
    each window column's expected values (numpy) as (the name of the row
    order they are in, the values), and each such row order's permutation
    of the table's rows. NULLs of the string column are code -1. Prices sum
    in integer cents, exactly."""
    out, orders = {}, {}
    for part_out, part_orders in parts:
        out.update(part_out)
        orders.update(part_orders)
    return out, orders


def window_oracles_orders(o) -> tuple:
    """W1-W3 over orders (:func:`merge_window_parts`)."""
    out, orders = {}, {}
    ck, od, ok_ = o["o_custkey"], o["o_orderdate"], o["o_orderkey"]
    s = _Segments(ck, od, ok_, stable=False)      # the keys are unique
    orders["o_date"] = s.perm
    out["W1_rn"] = ("o_date", s.idx - s.first + 1)
    prio_names, prio = np.unique(o["o_orderpriority"], return_inverse=True)
    # ranks do not depend on the order of tied rows
    p = _Segments(ck, prio, stable=False)
    orders["o_prio"] = p.perm
    sp = prio[p.perm]
    peer = p.start | np.r_[True, sp[1:] != sp[:-1]]
    peer_first = np.maximum.accumulate(np.where(peer, p.idx, 0))
    npeer = np.cumsum(peer)
    out["W1_rk"] = ("o_prio", peer_first - p.first + 1)
    out["W1_dr"] = ("o_prio", npeer - npeer[p.first] + 1)
    prev, ok = s.shifted(prio[s.perm], -1)
    out["W2_prev_priority"] = ("o_date", np.where(ok, prev, -1))
    tp = o["o_totalprice"][s.perm]
    nxt, ok = s.shifted(tp, 2)
    out["W2_next2"] = ("o_date", np.where(ok, nxt, 0.0))
    cents = _cents(tp)
    cum = np.cumsum(cents)
    run = cum - (cum[s.first] - cents[s.first])
    cnt = s.idx - s.first + 1
    out["W3_s"] = ("o_date", run / 100.0)
    out["W3_c"] = ("o_date", cnt)
    out["W3_mn"] = ("o_date", s.running(cents, np.minimum) / 100.0)
    out["W3_mx"] = ("o_date", s.running(cents, np.maximum) / 100.0)
    out["W3_a"] = ("o_date", run / 100.0 / cnt)
    out["_priorities"] = prio_names
    return out, orders


def window_oracles_rows(l) -> tuple:
    """W4's ROWS frames over lineitem (:func:`merge_window_parts`)."""
    out, orders = {}, {}
    sk = l["l_suppkey"]
    # ties (one order's lines of a supplier and a day) keep row order, as
    # the engine's stable sorts do
    s = _Segments(sk, l["l_shipdate"], l["l_orderkey"])
    orders["l_date"] = s.perm
    q = l["l_quantity"][s.perm]
    tot = np.zeros(len(q), np.int64)
    n_in = np.zeros(len(q), np.int64)
    mn = np.full(len(q), np.iinfo(np.int64).max)
    mx = np.full(len(q), np.iinfo(np.int64).min)
    before = np.full(len(q), np.iinfo(np.int64).min)
    for off in range(-7, 4):
        v, ok = s.shifted(q, off)
        if off < 0:
            before = np.where(ok, np.maximum(before, v), before)
        if off < -3:
            continue
        tot += np.where(ok, v, 0)
        n_in += ok
        mn = np.where(ok, np.minimum(mn, v), mn)
        mx = np.where(ok, np.maximum(mx, v), mx)
    out["W4_a"] = ("l_date", tot / n_in)
    out["W4_mn"] = ("l_date", mn)
    out["W4_mx"] = ("l_date", mx)
    out["W4_c"] = ("l_date", n_in)
    rev_rank = s.rank[-1] - s.rank[::-1]        # increasing along reversal
    big = int(q.max()) + 1
    suffix = (np.maximum.accumulate(q[::-1] + rev_rank * big) -
              rev_rank * big)[::-1]
    out["W4_mx_on"] = ("l_date", np.maximum(before, suffix))
    return out, orders


def window_oracles_range(l) -> tuple:
    """W5's RANGE frame and W6's whole partitions over lineitem
    (:func:`merge_window_parts`)."""
    out, orders = {}, {}
    sk = l["l_suppkey"]
    sd = l["l_shipdate"].astype(np.int64)
    # a RANGE frame holds every peer: the order of tied rows is moot
    s = _Segments(sk, sd, stable=False)
    orders["l_ship"] = s.perm
    comp = s.part * (1 << 32) + sd[s.perm]
    pc = np.r_[0, np.cumsum(_cents(l["l_extendedprice"][s.perm]))]
    lo = np.searchsorted(comp, comp - 30, "left")
    hi = np.searchsorted(comp, comp, "right")
    out["W5_rev30"] = ("l_ship", (pc[hi] - pc[lo]) / 100.0)
    per = np.bincount(sk, weights=_cents(l["l_extendedprice"]))
    out["W6_rev"] = (None, per[sk] / 100.0)
    return out, orders


def _window_column(name: str, col, n: int, want, priorities,
                   order=None) -> None:
    """One window column, taken in ``order`` (a device permutation of its
    rows, None: as it is), held to its oracle: integers and string codes
    exactly, floats within 1e-9 relative."""
    import torch
    valid, data = col.validity[:n], col.data[:n]
    lens = col.lengths[:n] if col.lengths is not None else None
    if order is not None:
        valid, data = valid[order], data[order]
        lens = lens[order] if lens is not None else None
    if data.dim() == 2:                # a string: code it by its bytes
        code = torch.full((n,), -1, dtype=torch.int64, device=col.device)
        for j, text in enumerate(priorities):
            b = torch.tensor(list(str(text).encode()), dtype=torch.uint8,
                             device=col.device)
            hit = (lens == len(b)) & (data[:, :len(b)] == b).all(dim=1) & \
                valid
            code[hit] = j
        got = code.cpu().numpy()
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0][:4]
            raise AssertionError(f"{name}: rows {bad.tolist()} differ")
        return
    if not bool(valid.all()):
        raise AssertionError(f"{name}: {int((~valid).sum())} NULL rows")
    got = data.cpu().numpy()
    if got.dtype.kind == "f":
        scale = np.maximum(np.abs(got), np.abs(want))
        bad = np.abs(got - want) > 1e-9 * scale
    else:
        bad = got != want
    if bad.any():
        i = np.nonzero(bad)[0][:4]
        raise AssertionError(f"{name}: sorted rows {i.tolist()}: {got[i]} "
                             f"vs {np.asarray(want)[i]}")


def windows_phase(tables, oracle, device) -> dict:
    """W1-W6 through the session, one cold and two hot runs each, every
    run's columns held to the numpy oracles (``oracle``: what
    :func:`merge_window_parts` returned); its cold run's kernel launches, its
    peak device bytes and its plan."""
    import warnings
    import torch
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.api.window import DefaultRowsFrameWarning
    want, orders = oracle
    orders = {k: torch.from_numpy(v).to(device) for k, v in orders.items()}
    orders[None] = None
    runs = {}
    with warnings.catch_warnings():
        # rank and row_number ignore the frame the warning is about
        warnings.simplefilter("ignore", DefaultRowsFrameWarning)
        queries_ = window_queries(tables)
    for name, df in queries_.items():
        session = df.session

        def run():
            """The collect's seconds; then its columns held to the
            oracle."""
            t0 = time.perf_counter()
            batch = df.collect_batch()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n = batch.num_rows
            for f, c in zip(batch.schema, batch.columns):
                order, values = want[f"{name}_{f.name}"]
                _window_column(f"{name} {f.name}", c, n, values,
                               want["_priorities"], orders[order])
            return n, seconds
        before = native.counts()
        torch.cuda.reset_peak_memory_stats(device)
        rows, cold = run()
        launches = {k: v - before[k] for k, v in native.counts().items()
                    if v != before[k]}
        missing = [k for k in WINDOW_KERNELS[name] if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name} did not launch {missing}")
        hots = [run()[1] for _ in range(2)]
        tree = session.last_plan().operator_tree()
        if "TpuWindowExec" not in tree:
            raise AssertionError(f"{name}: no TpuWindowExec:\n{tree}")
        runs[name] = {"rows": rows, "cold_s": cold, "hot_s": min(hots),
                      "peak_device_bytes":
                          torch.cuda.max_memory_allocated(device),
                      "launches_cold_run": launches,
                      "plan": tree.splitlines()}
    return {"phase": "windows", "runs": runs,
            "note": "cold_s, hot_s (least of 2): the collect's seconds; "
                    "every run's columns are then checked; peak over the "
                    "cold and hot runs",
            "oracle": "numpy: integers exact, prices in integer cents, "
                      "floats relative 1e-9"}

# ---------------------------------------------------------------------------
# The nested phase (N1-N4): K25-K28 at the sizes users run them
# ---------------------------------------------------------------------------

# the kernels each nested query must launch in its cold run
NESTED_KERNELS = {
    "N1_word_count": ("split_parts", "explode_expand"),
    "N2_positions": ("split_parts", "explode_expand"),
    "N3a_lookup": ("map_build", "map_lookup"),
    "N3b_unpivot": ("map_build", "explode_expand"),
    "N3c_size_keys": ("map_build",),
    "N4_shredded": (),
    "N4_struct_join": ("join_probe",)}
N4_ROWS = 1 << 20
N4_WORDS = ("alpha", "beta", "gamma", "delta", "épsilon", "z")


def n4_data(n: int) -> dict:
    """N4's columns: ``s`` a struct<a: bigint, b: double, c: string> of
    python dicts (NULL structs and NULL c fields), the numpy arrays they
    were made from, and ``id``."""
    rng = np.random.default_rng(97)
    a = rng.integers(-10 ** 6, 10 ** 6, n)
    b = rng.integers(-4000, 4000, n) / 4
    c = np.array(N4_WORDS)[rng.integers(0, len(N4_WORDS), n)]
    s_null = rng.random(n) < 0.05
    c_null = rng.random(n) < 0.1
    structs = [None if sn else {"a": ai, "b": bi, "c": None if cn else ci}
               for sn, cn, ai, bi, ci in zip(
                   s_null.tolist(), c_null.tolist(), a.tolist(), b.tolist(),
                   c.tolist())]
    return {"id": np.arange(n, dtype=np.int64), "s": structs, "a": a,
            "b": b, "c": c, "s_null": s_null, "c_null": c_null,
            "dim_ids": np.sort(rng.choice(n, 4096, replace=False))}


def split_counts(values: np.ndarray, sep: str, with_pos: bool) -> dict:
    """{word or (position, word): rows} of every value split on ``sep``:
    each distinct value (found through a 64-bit hash of its characters,
    checked against the values) split once in python, weighted by how
    often it occurs."""
    import collections
    codes = np.ascontiguousarray(values).view(np.uint32).reshape(
        len(values), -1).astype(np.uint64)
    mult = np.random.default_rng(3).integers(
        1, 1 << 62, codes.shape[1], dtype=np.uint64) | np.uint64(1)
    h = codes @ mult
    _u, first, inv, cnt = np.unique(h, return_index=True,
                                    return_inverse=True, return_counts=True)
    if not np.array_equal(values[first][inv], values):
        raise AssertionError("split oracle: a hash collision")
    out = collections.Counter()
    for v, k in zip(values[first].tolist(), cnt.tolist()):
        for p, word in enumerate(v.split(sep)):
            out[(p, word) if with_pos else word] += k
    return out


def nested_oracles(o, p, l, n4) -> dict:
    """Every nested query's expected rows, sorted."""
    words = split_counts(o["o_comment"], " ", False)
    types = split_counts(p["p_type"], " ", True)
    key = l["l_orderkey"] % 4 + 1
    cols = (l["l_partkey"], l["l_suppkey"], l["l_orderkey"])
    v = np.select([key == 1, key == 2, key == 3], cols, 0)
    n = len(key)
    n_v = int((key != 4).sum())
    keep = ~n4["s_null"] & (n4["a"] > 0)
    groups = {}
    for c, cn, b in zip(n4["c"][keep].tolist(), n4["c_null"][keep].tolist(),
                        n4["b"][keep].tolist()):
        g = groups.setdefault(None if cn else c, [0.0, 0])
        g[0] += b
        g[1] += 1
    structs = n4["s"]
    out = {
        "N1_word_count": list(words.items()),
        "N2_positions": [(pw[0], pw[1], k) for pw, k in types.items()],
        "N3a_lookup": [(int(v[key != 4].sum()), n_v, n)],
        "N3b_unpivot": [(j, int(c.sum()), n) for j, c in enumerate(cols)],
        "N3c_size_keys": [(3 * n, 3, 3, n)],
        "N4_shredded": [(c, s, k) for c, (s, k) in groups.items()],
        "N4_struct_join": [(int(i), structs[i])
                           for i in n4["dim_ids"].tolist()]}
    return {k: sorted(v, key=repr) for k, v in out.items()}


def nested_queries(t, s4, dim) -> dict:
    """N1-N4 as DataFrames: word count over o_comment, positions over
    p_type, unpivot of three lineitem keys through a map (lookup keyed by
    l_orderkey % 4 + 1, datagen's lineitem having no l_linenumber;
    posexplode of its values; size and the last key), a shredded struct
    and a whole struct through a broadcast join."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col, lit
    lineitem = t["lineitem"]
    m = F.create_map(lit(1), col("l_partkey"), lit(2), col("l_suppkey"),
                     lit(3), col("l_orderkey"))
    return {
        "N1_word_count": t["orders"].select(
            F.explode(F.split(col("o_comment"), " ")).alias("word"))
        .groupBy("word").count(),
        "N2_positions": t["part"].select(
            "p_partkey", F.posexplode(F.split(col("p_type"), " ")))
        .groupBy("pos", "col").count(),
        "N3a_lookup": lineitem.select(
            F.element_at(m, (col("l_orderkey") % 4) + 1).alias("v"))
        .agg(F.sum("v"), F.count("v"), F.count("*")),
        "N3b_unpivot": lineitem.select(F.posexplode(F.map_values(m)))
        .groupBy("pos").agg(F.sum("col"), F.count("*")),
        "N3c_size_keys": lineitem.select(
            F.size(m).alias("n"),
            F.element_at(F.map_keys(m), -1).alias("last"))
        .agg(F.sum("n"), F.min("last"), F.max("last"), F.count("last")),
        "N4_shredded": s4.filter(col("s").getField("a") > 0)
        .groupBy(col("s").getField("c").alias("c"))
        .agg(F.sum(col("s").getField("b")).alias("sb"),
             F.count("*").alias("n")),
        "N4_struct_join": s4.join(dim, on=col("id") == col("did"))
        .select(col("id"), col("s"))}


def nested_phase(tables, oracle, n4, device) -> dict:
    """N1-N4 through the session, one cold and two hot runs each, every
    run's rows held to the numpy oracles; its cold run's kernel launches,
    its peak device bytes and its plan."""
    import torch
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.columnar.column import StructColumn
    session = tables["orders"].session
    t0 = time.perf_counter()
    s4 = session.createDataFrame({"id": n4["id"], "s": n4["s"]},
                                 schema={"s": "struct<a:bigint,b:double,"
                                              "c:string>"})
    dim = session.createDataFrame({"did": n4["dim_ids"],
                                   "w": n4["dim_ids"] * 0.5})
    n4_build_s = time.perf_counter() - t0
    runs = {}
    for name, df in nested_queries(tables, s4, dim).items():
        want = oracle[name]

        def run():
            t0 = time.perf_counter()
            batch = df.collect_batch()
            rows = batch.rows()
            seconds = time.perf_counter() - t0
            check_rows(name, sorted(rows, key=repr), want)
            return batch, seconds
        before = native.counts()
        torch.cuda.reset_peak_memory_stats(device)
        batch, cold = run()
        launches = {k: v - before[k] for k, v in native.counts().items()
                    if v != before[k]}
        missing = [k for k in NESTED_KERNELS[name] if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name} did not launch {missing}")
        hots = [run()[1] for _ in range(2)]
        tree = session.last_plan().operator_tree()
        if name == "N4_struct_join":
            if not isinstance(batch.columns[1], StructColumn) or \
                    "TpuBroadcastExchangeExec" not in tree:
                raise AssertionError(f"{name}: no StructColumn through a "
                                     f"broadcast join:\n{tree}")
        if name == "N4_shredded" and "s.a" not in str(session.last_plan()):
            raise AssertionError(f"{name}: the struct was not shredded")
        runs[name] = {"rows": len(want), "cold_s": cold, "hot_s": min(hots),
                      "peak_device_bytes":
                          torch.cuda.max_memory_allocated(device),
                      "launches_cold_run": launches,
                      "plan": tree.splitlines()}
    return {"phase": "nested", "runs": runs, "n4_rows": N4_ROWS,
            "n4_create_s": n4_build_s,
            "note": "cold_s, hot_s (least of 2): the collect's seconds and "
                    "its rows to python; every run's rows are then checked",
            "oracle": "numpy and python: counts and integer sums exact, "
                      "sums of quarter values exact"}


# ---------------------------------------------------------------------------
# The mesh phase (M1-M5): 4 workers on one card, K29 and K30
# ---------------------------------------------------------------------------

# SF 1, cut from the main phase's SF 10: the mesh's receive windows hold
# workers x cap rows of every array on each worker, so with 4 workers on
# one card a stage holds about 16 x its shard's capacity per array
MESH_SF = 1.0
MESH_WORKERS = 4
MESH_WINDOW_ROWS = 1 << 17
# K29/K30's timed shape: one worker's side of q3's lineitem co-partition at
# SF 1 (l_shipdate > 1995-03-15 keeps ~3.24 M of 6 M rows; a quarter of
# them in a 2^20-row shard) with its payload arrays: l_orderkey,
# l_extendedprice, l_discount (8 bytes), l_shipdate (4), each + validity
MESH_SHARD_CAP, MESH_SHARD_ROWS = 1 << 20, 810_000
MESH_PAYLOAD = (("int64", ()), ("bool", ()), ("float64", ()), ("bool", ()),
                ("float64", ()), ("bool", ()), ("int32", ()), ("bool", ()))
# the kernels each mesh query must launch in its cold run
MESH_KERNELS = {
    "M1_q1": ("exchange_bucket", "exchange_flatten", "partition_split",
              "murmur3", "sort_key_lanes", "segment_bounds",
              "segment_reduce", "join_probe"),
    "M2_q3": ("exchange_bucket", "exchange_flatten", "partition_split",
              "murmur3", "sort_key_lanes", "join_probe", "join_expand",
              "segment_bounds", "segment_reduce"),
    "M3_orderby": ("exchange_bucket", "exchange_flatten", "partition_split",
                   "sort_key_lanes", "join_probe"),
    "M4_q18_streaming": ("exchange_bucket", "exchange_flatten",
                         "partition_split", "murmur3", "sort_key_lanes",
                         "segment_bounds", "segment_reduce"),
    "M5_repartition": ("exchange_bucket", "exchange_flatten",
                       "partition_split", "murmur3")}
# the mesh operators each mesh query's plan must hold
MESH_OPERATORS = {
    "M1_q1": ("TpuMeshGroupByExec", "TpuMeshSortExec"),
    "M2_q3": ("TpuMeshJoinExec", "TpuMeshGroupByExec", "TpuMeshSortExec"),
    "M3_orderby": ("TpuMeshSortExec",),
    "M4_q18_streaming": ("TpuMeshGroupByExec",),
    "M5_repartition": ("TpuShuffleExchangeExec",)}
# session settings of one query, restored after it
MESH_QUERY_CONF = {
    "M4_q18_streaming": {"spark.rapids.tpu.sql.mesh.maxStageBytes": "1m",
                         "spark.rapids.tpu.sql.mesh.streamWindowRows":
                             MESH_WINDOW_ROWS},
    "M5_repartition": {"spark.rapids.tpu.sql.shuffle.plane": "ici"}}


def mesh_data(sf: float) -> dict:
    from benchmarks import datagen
    return {"lineitem": datagen.gen_lineitem(sf),
            "orders": datagen.gen_orders(sf),
            "customer": datagen.gen_customer(sf)}


def mesh_oracles(d) -> dict:
    """M1-M5's expected results: q1's and q3's rows, the sorted lineitem
    columns, q18's per-order quantity sums (bincount), the repartitioned
    rows as a multiset (lexsorted)."""
    l = d["lineitem"]
    ok, price, ship = l["l_orderkey"], l["l_extendedprice"], l["l_shipdate"]
    order = np.lexsort((ship, ok, -price))
    keys, inv = np.unique(ok, return_inverse=True)
    qty = np.bincount(inv, weights=l["l_quantity"])
    part = l["l_partkey"]
    rep = np.lexsort((l["l_quantity"], part, ok))
    return {"M1_q1": oracle_q1(l),
            "M2_q3": oracle_q3(l, d["orders"], d["customer"]),
            "M3_orderby": (ok[order], price[order], ship[order]),
            "M4_q18_streaming": (keys, qty),
            "M5_repartition": (ok[rep], part[rep], l["l_quantity"][rep])}


def mesh_queries(t) -> dict:
    from spark_rapids_tpu_torch import queries
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col
    l = t["lineitem"]
    return {
        "M1_q1": queries.q1(t),
        "M2_q3": queries.q3(t),
        "M3_orderby": l.select("l_orderkey", "l_extendedprice",
                               "l_shipdate")
        .orderBy(col("l_extendedprice").desc(), col("l_orderkey")),
        "M4_q18_streaming": l.groupBy("l_orderkey").agg(
            F.sum("l_quantity").alias("sum_qty")),
        "M5_repartition": l.select("l_orderkey", "l_partkey", "l_quantity")
        .repartition(8, "l_orderkey")}


def _host_columns(batch) -> list:
    n = batch.num_rows
    for c in batch.columns:
        if not bool(c.validity[:n].all()):
            raise AssertionError("a NULL where the data has none")
    return [c.data[:n].cpu().numpy() for c in batch.columns]


def _check_arrays(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: column {i} differs from its "
                                 f"oracle ({g.shape} vs {w.shape})")


def mesh_collect(name: str, df):
    """One run of a mesh query: q1's and q3's rows, the others' device
    batch (synchronized)."""
    import torch
    if name in ("M1_q1", "M2_q3"):
        return df.collect()
    batch = df.collect_batch()
    torch.cuda.synchronize()
    return batch


def mesh_check(name: str, got, want) -> None:
    """Hold one mesh query's result to its oracle."""
    if name in ("M1_q1", "M2_q3"):
        check_rows(name, got, want)
        return
    got = _host_columns(got)
    if name == "M3_orderby":
        ok, price, ship = got
        # keys in order; rows of equal keys in any order
        _check_arrays(name, (ok, price), want[:2])
        order = np.lexsort((ship, ok, -price))
        _check_arrays(name, (ok[order], price[order], ship[order]), want)
    elif name == "M4_q18_streaming":
        order = np.argsort(got[0])
        _check_arrays(name, (got[0][order], got[1][order]),
                      (want[0], want[1].astype(np.int64)))
    else:
        order = np.lexsort((got[2], got[1], got[0]))
        _check_arrays(name, [g[order] for g in got], want)


def mesh_phase(data, oracle, device) -> dict:
    """M1-M5 through a session with a 4-worker mesh on ``device``
    (mesh.enabled=true, broadcast off), over datagen's TPC-H tables at SF
    1: one cold and two hot runs each, every run held to its oracle; the
    launch counters set to 0 before the phase and read after it."""
    import torch
    from spark_rapids_tpu_torch import native, queries
    from spark_rapids_tpu_torch.api.session import TpuSession
    session = TpuSession.builder.config({
        "spark.rapids.torch.device": str(device),
        "spark.rapids.torch.mesh.workers": MESH_WORKERS,
        "spark.rapids.tpu.sql.mesh.enabled": "true",
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    ).getOrCreate()
    tables = {name: session.createDataFrame(
        cols, schema=queries.table_schema(cols))
        for name, cols in data.items()}
    native.reset_counts()
    runs = {}
    for name, df in mesh_queries(tables).items():
        conf = MESH_QUERY_CONF.get(name, {})
        saved = {k: session.conf._settings.get(k) for k in conf}
        for k, v in conf.items():
            session.conf.set(k, v)
        try:
            before = native.counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            times, check_s = [], 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                got = mesh_collect(name, df)
                times.append(time.perf_counter() - t0)
                if len(times) == 1:
                    launches = {k: v - before[k] for k, v in
                                native.counts().items() if v != before[k]}
                t0 = time.perf_counter()
                mesh_check(name, got, oracle[name])
                check_s += time.perf_counter() - t0
                del got
            cold, hots = times[0], times[1:]
            plan = session.last_plan()
        finally:
            for k, v in saved.items():
                session.conf.set(k, v)
        missing = [k for k in MESH_KERNELS[name] if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name} did not launch {missing}")
        nodes = list(_plan_nodes(plan))
        names = {n.name for n in nodes}
        absent = [op for op in MESH_OPERATORS[name] if op not in names]
        if absent:
            raise AssertionError(f"{name}: plan lacks {absent}:\n{plan}")
        if name == "M4_q18_streaming" and not any(
                getattr(n, "window_rows", None) == MESH_WINDOW_ROWS
                for n in nodes):
            raise AssertionError(f"{name} did not stream:\n{plan}")
        if name == "M5_repartition" and not any(
                n.name == "TpuShuffleExchangeExec" and n.would_use_ici()
                for n in nodes):
            raise AssertionError(f"{name}: no ICI exchange:\n{plan}")
        runs[name] = {
            "cold_s": cold, "hot_s": min(hots), "check_s": check_s,
            "peak_device_bytes": torch.cuda.max_memory_allocated(device),
            "launches_cold_run": launches,
            "mesh_execs": [n._node_string() for n in nodes
                           if "Mesh" in n.name or getattr(n, "mesh", None)],
            "plan": plan.operator_tree().splitlines()}
    return {"phase": "mesh", "sf": MESH_SF, "workers": MESH_WORKERS,
            "devices": [str(device)] * MESH_WORKERS,
            "lineitem_rows": len(data["lineitem"]["l_orderkey"]),
            "runs": runs, "phase_launches": native.counts(),
            "note": "one process, 4 mesh workers on one card: the "
                    "all_to_all is a transpose in device memory (no NVLink, "
                    "no NCCL); cold_s, hot_s (least of 2): the collect "
                    "(q1, q3: to python rows; the rest: the device batch, "
                    "synchronized); check_s: the 3 runs' checks against "
                    "the oracle",
            "oracle": "numpy: q1/q3 relative 1e-9, the rest exact"}


def _mesh_payload(rng, cap: int, device) -> list:
    import torch
    out = []
    for tname, shape in MESH_PAYLOAD:
        dt_ = getattr(torch, tname)
        if tname == "bool":
            out.append(torch.rand((cap,) + shape, device=device) < 0.9)
        elif dt_.is_floating_point:
            out.append(torch.randn((cap,) + shape, device=device,
                                   dtype=dt_))
        else:
            out.append(torch.randint(-2 ** 31, 2 ** 31 - 1, (cap,) + shape,
                                     device=device, dtype=dt_))
    return out


def _edge_payload(rng, cap: int, device) -> list:
    """Every element width (1, 2, 4, 8 bytes), strings of 16 and 24 bytes
    with junk past their lengths, float bits with NaN payloads and -0.0."""
    import torch
    f = torch.randn(cap, device=device, dtype=torch.float64)
    f[::7] = -0.0
    f[::11] = float("nan")
    bits = torch.randint(-2 ** 62, 2 ** 62, (cap,), device=device)
    return [bits, f, torch.rand(cap, device=device) < 0.5,
            torch.randint(-999, 999, (cap,), device=device,
                          dtype=torch.int16),
            torch.randint(0, 255, (cap,), device=device,
                          dtype=torch.uint8),
            torch.randint(0, 255, (cap, 16), device=device,
                          dtype=torch.uint8),
            torch.randint(0, 255, (cap, 24), device=device,
                          dtype=torch.uint8),
            torch.randint(0, 17, (cap,), device=device, dtype=torch.int32),
            f.to(torch.float32)]


def _same_bits(got, want, what: str) -> None:
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(
                g.contiguous().view(torch.uint8),
                w.contiguous().view(torch.uint8)):
            raise AssertionError(f"{what}: kernel and twin differ")


def _pids(case: str, n: int, cap: int, device):
    import torch
    pids = torch.randint(0, n, (cap,), dtype=torch.int32, device=device)
    if case == "one_slot":
        pids.fill_(n - 1)
    elif case == "empty_slots":
        pids = (pids // 2) * 2 % n
    return pids


def check_k29(device, rng) -> dict:
    """K29 (+ K12 inside its wrapper) against its twin (the reference's n
    compactions), bit for bit: n = 1, 2, 4, 8 and 1024; random targets,
    empty slots, every row in one slot, no live row; every element width,
    junk past string lengths, NaN payloads, -0.0; 33 arrays (two blocks of
    the kernel's table). Timed at the mesh phase's q3 lineitem shard."""
    import torch
    from spark_rapids_tpu_torch.parallel import mesh as M
    checks = 0
    for n in (1, 2, 4, 8, 1024):
        for case in ("random", "empty_slots", "one_slot", "no_rows"):
            cap = 4096 if n < 1024 else 1 << 14
            rows = 0 if case == "no_rows" else cap - int(
                rng.integers(0, cap // 3))
            arrays = _edge_payload(rng, cap, device)
            if n == 8 and case == "random":
                arrays = (arrays * 4)[:33]
            pids = _pids(case, n, cap, device)
            live = torch.arange(cap, device=device) < rows
            got = M.bucket_rows_for_exchange(arrays, pids, live, n, cap)
            if n == 1024:     # the twin's n compactions, on the host
                want = M._bucket_rows_torch([a.cpu() for a in arrays],
                                            pids.cpu(), live.cpu(), n, cap)
                got = ([g.cpu() for g in got[0]], got[1].cpu())
            else:
                want = M._bucket_rows_torch(arrays, pids, live, n, cap)
            _same_bits(got[0] + [got[1]], want[0] + [want[1]],
                       f"K29 {case} n={n}")
            checks += 1
    n, cap, rows = MESH_WORKERS, MESH_SHARD_CAP, MESH_SHARD_ROWS
    arrays = _mesh_payload(rng, cap, device)
    pids = torch.randint(0, n, (cap,), dtype=torch.int32, device=device)
    live = torch.arange(cap, device=device) < rows
    _same_bits(M.bucket_rows_for_exchange(arrays, pids, live, n, cap)[0],
               M._bucket_rows_torch(arrays, pids, live, n, cap)[0],
               "K29 mesh shard")
    row_bytes = sum(a.element_size() * (a[0].numel() if a.dim() > 1 else 1)
                    for a in arrays)
    # K29's launch alone, on the wrapper's K12 order and counts
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.shuffle.partitioning import partition_split
    perm, counts = partition_split(
        torch.where(live, pids, n).to(torch.int32), cap, n)
    outs = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=device)
            for a in arrays]
    descs = M._descs(list(zip(arrays, outs)))
    lib = native.library("exchange_bucket")
    stream = native.stream_ptr(device)

    def launch():
        native.check(lib.exchange_bucket(descs, len(arrays), perm.data_ptr(),
                                         counts.data_ptr(), n, cap, stream),
                     "exchange_bucket")
    return {
        "name": "exchange_bucket", "checks": checks + 1,
        "launch_only_ms": time_ms(launch),
        "max_abs_err": 0.0, "tolerance": "exact (bits, zero padding too)",
        "workers": n, "rows": rows, "capacity": cap,
        "arrays": [t for t, _s in MESH_PAYLOAD],
        "timed": "the wrapper (K12's order of the rows by target, then "
                 "K29) over one worker's q3 lineitem shard at SF 1",
        "ms": time_ms(lambda: M.bucket_rows_for_exchange(arrays, pids, live,
                                                         n, cap)),
        "plain_ms": time_ms(lambda: M._bucket_rows_torch(arrays, pids, live,
                                                         n, cap), iters=5),
        # the live rows' payload and the ids and live mask read; the n x cap
        # slots of every array and the counts written
        "bound_ms": bound_ms(rows * row_bytes + cap * (4 + 1) +
                             n * cap * row_bytes + n * 4),
        "library_ms": None,
        "library": "none: no PyTorch call buckets rows into slots"}


def check_k30(device, rng) -> dict:
    """K30 against its twin (the reference's cumsum, searchsorted, gather
    and where), bit for bit: n = 1, 2, 4, 8 and 1024; random counts, empty
    slots, one full slot, no rows; every element width and junk bytes.
    Timed at the receive side of the mesh phase's q3 lineitem exchange."""
    import torch
    from spark_rapids_tpu_torch.parallel import mesh as M
    checks = 0
    for n in (1, 2, 4, 8, 1024):
        cap = 2048 if n < 1024 else 16
        for case in ("random", "empty_slots", "one_slot", "no_rows"):
            counts = torch.randint(0, cap + 1, (n,), dtype=torch.int32,
                                   device=device)
            if case == "empty_slots":
                counts[::2] = 0
            elif case == "one_slot":
                counts.zero_()
                counts[n // 2] = cap
            elif case == "no_rows":
                counts.zero_()
            slots = [torch.stack([a] * n) for a in
                     _edge_payload(rng, cap, device)]
            out_cap = n * cap
            got = M.flatten_received(slots, counts, out_cap)
            want = M._flatten_received_torch(slots, counts, out_cap)
            _same_bits(got[0] + [got[1].reshape(1)],
                       want[0] + [want[1].reshape(1)], f"K30 {case} n={n}")
            checks += 1
    n, cap = MESH_WORKERS, MESH_SHARD_CAP
    slots = [torch.stack([a] * n) for a in _mesh_payload(rng, cap, device)]
    counts = torch.full((n,), MESH_SHARD_ROWS // n, dtype=torch.int32,
                        device=device)
    out_cap = n * cap
    _same_bits(M.flatten_received(slots, counts, out_cap)[0],
               M._flatten_received_torch(slots, counts, out_cap)[0],
               "K30 mesh shard")
    total = int(counts.sum())
    row_bytes = sum(s.element_size() * (s[0][0].numel() if s.dim() > 2
                                        else 1) for s in slots)
    return {
        "name": "exchange_flatten", "checks": checks + 1,
        "max_abs_err": 0.0, "tolerance": "exact (bits, zero padding too)",
        "workers": n, "rows": total, "capacity": cap, "out_capacity": out_cap,
        "timed": "one worker's received q3 lineitem slots at SF 1 "
                 "(n x cap in, n x cap out)",
        "ms": time_ms(lambda: M.flatten_received(slots, counts, out_cap)),
        "plain_ms": time_ms(lambda: M._flatten_received_torch(
            slots, counts, out_cap), iters=5),
        # the received live rows and the counts read; out_cap rows of every
        # array and the total written
        "bound_ms": bound_ms(total * row_bytes + n * 4 +
                             out_cap * row_bytes + 4),
        "library_ms": None,
        "library": "none: no PyTorch call flattens slots by their counts"}


def run_query(name: str, tables, cache, oracle, n_rows: int, device
              ) -> dict:
    """One cold and three hot runs of a query through the session, each
    held to the oracle; the warm runs must be served from the scan cache
    and every kernel of the query's path must launch in its cold run."""
    import torch
    from spark_rapids_tpu_torch import native, queries
    from spark_rapids_tpu_torch.plan import physical as ph
    from spark_rapids_tpu_torch.shuffle.exchange import TpuHashExchangeExec
    qfn = queries.QUERIES[name]
    table = queries.TABLES[name][-1]
    before = native.counts()
    uploads = cache.uploads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rows = qfn(tables).collect()
    cold = time.perf_counter() - t0
    cold_launches = {k: v - before[k] for k, v in native.counts().items()}
    if name == "headline":             # no ORDER BY: compare by key
        rows = sorted(rows)
    check_rows(name, rows, oracle)
    cold_uploads = cache.uploads - uploads
    resident = (cache.bytes, cache.uploads, cache.evicted)
    hots = []
    for _ in range(3):
        t0 = time.perf_counter()
        hot_rows = qfn(tables).collect()
        hots.append(time.perf_counter() - t0)
        check_rows(name, sorted(hot_rows) if name == "headline" else
                   hot_rows, oracle)
    if cache.refused or (cache.bytes, cache.uploads, cache.evicted) != \
            resident:
        now = (cache.bytes, cache.uploads, cache.evicted)
        raise AssertionError(
            f"{name}: warm runs not served from the scan cache "
            f"((bytes, uploads, evicted) {resident} -> {now}, refused "
            f"{cache.refused})")
    plan = tables[table].session.last_plan()
    decisions = tables[table].session.last_fusion_decisions()
    # every unit the planner gave a generated kernel launches it
    generated = sorted({GENERATED_COUNTER[kind]
                        for _label, kind, _e in decisions.generated})
    missing = [k for k in PATH_KERNELS[name] + tuple(generated)
               if cold_launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name} did not launch {missing}")
    n_batches = -(-n_rows // (1 << 20))
    operators = plan.operator_tree()
    absent = [op for op in REQUIRED_OPERATORS.get(name, ())
              if op not in operators]
    if absent:
        raise AssertionError(f"{name}: plan lacks {absent}:\n{operators}")
    if name == "q13" and not any(
            isinstance(n, ph.TpuShuffledJoinExec) and n.how == "left" and
            all(isinstance(c, TpuHashExchangeExec) for c in n.children)
            for n in _plan_nodes(plan)):
        raise AssertionError(f"q13 is not a shuffled left outer join over "
                             f"two hash exchanges:\n{plan}")
    windows = [(node.name, node.window) for node in _plan_nodes(plan)
               if getattr(node, "window", None) is not None]
    return {
        "phase": "main", "query": name, "tables": queries.TABLES[name],
        f"{table}_rows": n_rows, f"{table}_batches": n_batches,
        "cold_s": cold, "hot_s": min(hots),
        "hot_rows_per_s": n_rows / min(hots),
        # the kernels this query launched (the others 0); per scan batch
        # of its main table divide by the batches
        "launches_cold_run": {k: v for k, v in cold_launches.items() if v},
        "scan_column_batches_uploaded_cold": cold_uploads,
        "scan_cache_bytes": cache.bytes,
        "scan_cache_columns_evicted": cache.evicted,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device),
        # the windows of the last hot run (an aggregate's update stats, an
        # exchange's split counts: its last map partition's): batched
        # reads, the values they carried, device -> host copies
        "stats_windows_last_run": [
            {"node": node, "depth": w.depth, "reads": w.resolves,
             "values": w.resolved_scalars, "copies": w.copies}
            for node, w in windows],
        "plan": operators.splitlines(),
        # the fused units: generated kernels (unit, kind, entry) and the
        # units left eager with the generator's reason
        "generated": [list(g) for g in decisions.generated],
        "not_generated": [list(d) for d in decisions.declined],
        "result_rows": len(rows), "oracle": "numpy, relative 1e-9"}


def _plan_nodes(node):
    yield node
    for c in node.children:
        yield from _plan_nodes(c)


def main_data(sf: float) -> tuple:
    """(the main path's numpy tables at scale factor ``sf``, the seconds
    drawing them took)."""
    from benchmarks import datagen
    from spark_rapids_tpu_torch import queries
    t0 = time.perf_counter()
    data = {"lineitem": datagen.gen_lineitem(sf),
            "orders": datagen.gen_orders(sf),
            "customer": datagen.gen_customer(sf),
            "supplier": datagen.gen_supplier(sf),
            "partsupp": datagen.gen_partsupp(sf),
            "nation": datagen.gen_nation(),
            "part": datagen.gen_part(sf),
            "region": datagen.gen_region(),
            "headline": queries.headline_table(HEADLINE_ROWS),
            # TPC-DS: store_sales (2.88 M rows a scale factor) and the
            # dimensions q98 and q89 read
            **queries.tpcds_tables(sf),
            # the nested phase's struct rows (not a table of the main path)
            "n4": n4_data(N4_ROWS),
            # the mesh phase's tables at SF 1 (not the main path's)
            "mesh": mesh_data(MESH_SF)}
    return data, time.perf_counter() - t0


class Oracles:
    """The main path's numpy oracles on four host threads, started before
    the kernels build; :meth:`join` waits for them all, before the kernel
    checks, so no timed phase shares the host with them."""

    def __init__(self, data):
        l, o, c = data["lineitem"], data["orders"], data["customer"]
        s, ps = data["supplier"], data["partsupp"]
        n, r, p = data["nation"], data["region"], data["part"]
        kept = q13_order_mask(o["o_comment"])

        def q11_job():
            rows, margin = oracle_q11(ps, s, n)
            ORACLE_NOTES["q11"] = (f" (the nearest per-part value lies "
                                   f"{margin:.3e} of the threshold from "
                                   f"it, relative)")
            return rows

        def q89_job():
            rows, margin = oracle_tpcds_q89(data["store_sales"],
                                            data["date_dim"], data["item"],
                                            data["store"])
            ORACLE_NOTES["tpcds_q89"] = (f" (the nearest deviation lies "
                                         f"{margin:.3e} of its 10% "
                                         f"threshold, relative)")
            return rows
        # the longest first
        jobs = {"windows_rows": lambda: window_oracles_rows(l),
                "q9": lambda: oracle_q9(l, o, s, ps, n, p),
                "windows_range": lambda: window_oracles_range(l),
                "windows_orders": lambda: window_oracles_orders(o),
                "mesh": lambda: mesh_oracles(data["mesh"]),
                "q21": lambda: oracle_q21(l, o, s, n),
                "nested": lambda: nested_oracles(o, p, l, data["n4"]),
                "q1": lambda: oracle_q1(l),
                "q3": lambda: oracle_q3(l, o, c),
                "q19": lambda: oracle_q19(l, p),
                "q6": lambda: [(oracle_q6(l),)],
                "q12": lambda: oracle_q12(l, o),
                "q4": lambda: oracle_q4(l, o),
                "q13": lambda: oracle_q13(o, c, kept), "q11": q11_job,
                "q15": lambda: oracle_q15(l, s),
                "q22": lambda: oracle_q22(c, o),
                "q2": lambda: oracle_q2(ps, s, n, r, p),
                "q17": lambda: oracle_q17(l, p),
                "q5": lambda: oracle_q5(l, o, c, s, n, r),
                "q10": lambda: oracle_q10(l, o, c, n),
                "q14": lambda: oracle_q14(l, p),
                "q18": lambda: oracle_q18(l, o, c),
                "q20": lambda: oracle_q20(l, ps, p, s, n),
                "q7": lambda: oracle_q7(l, o, c, s, n),
                "q8": lambda: oracle_q8(l, o, c, s, n, r, p),
                "q16": lambda: oracle_q16(ps, s, p),
                "tpcds_q98": lambda: oracle_tpcds_q98(
                    data["store_sales"], data["date_dim"], data["item"]),
                "tpcds_q89": q89_job,
                "headline": lambda: oracle_headline(HEADLINE_ROWS),
                "full_outer": lambda: oracle_full_outer(o, c, kept)}
        self.own_s, self.ends = {}, {}
        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        self.pending = {name: self.pool.submit(self._timed, name, fn)
                        for name, fn in jobs.items()}

    def _timed(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        self.ends[name] = time.perf_counter()
        self.own_s[name] = self.ends[name] - t0
        return out

    def join(self) -> tuple:
        """(every oracle by name, {own_s: thread seconds summed, wall_s:
        from their start to the last one's end, waited_s: how long this
        call waited, longest_own_s: the five longest by name})."""
        t0 = time.perf_counter()
        try:
            out = {name: f.result() for name, f in self.pending.items()}
        finally:
            self.pool.shutdown()
        waited = time.perf_counter() - t0
        out["windows"] = merge_window_parts(
            [out.pop(f"windows_{part}")
             for part in ("orders", "rows", "range")])
        for name in NONEMPTY_ORACLES:
            if not out[name]:
                raise AssertionError(f"{name}'s oracle is empty")
        longest = sorted(self.own_s.items(), key=lambda kv: -kv[1])[:5]
        return out, {"own_s": sum(self.own_s.values()),
                     "wall_s": max(self.ends.values()) - self.t0,
                     "waited_s": waited, "longest_own_s": dict(longest)}


def main_path(sf: float, data, oracles, device) -> tuple:
    """The counted run over ``data`` (:func:`main_data` at scale factor
    ``sf``), every query and window held to ``oracles``
    (:meth:`Oracles.join`), then the A/B phases."""
    import torch
    from spark_rapids_tpu_torch import native, queries
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.ops import joins as J
    rows_of = {"headline": HEADLINE_ROWS}
    for name in MAIN_QUERIES:
        main = queries.TABLES[name][-1]
        rows_of.setdefault(name, len(next(iter(data[main].values()))))
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": str(device),
         # the ASCII-only case maps of the string phase
         "spark.rapids.tpu.sql.incompatibleOps.enabled": "true"}
    ).getOrCreate()
    tables = {name: session.createDataFrame(
        cols, schema=queries.table_schema(cols))
        for name, cols in data.items() if name not in ("n4", "mesh")}
    torch.cuda.reset_peak_memory_stats(device)
    lines, k15_shapes = [], {}
    with recording(J, "cross_expand") as calls, \
            recording(J, "join_probe", k6_shape) as k6_calls:
        native.reset_counts()
        for name in MAIN_QUERIES:
            start = len(calls)
            t0 = time.perf_counter()
            line = run_query(name, tables, session.scan_cache,
                             oracles[name], rows_of[name], device)
            line["phase_s"] = time.perf_counter() - t0
            emit(line)
            lines.append(line)
            k = line["launches_cold_run"].get("cross_expand", 0)
            if k:
                k15_shapes[name] = calls[start:start + k]
        before = native.counts()
        t0 = time.perf_counter()
        line = string_exprs(tables, data)
        line["phase_s"] = time.perf_counter() - t0
        line["launches"] = {k: v - before[k]
                            for k, v in native.counts().items()
                            if v != before[k]}
        emit(line)
        lines.append(line)
        missing = [k for k in PATH_KERNELS["string_exprs"]
                   if line["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"string_exprs did not launch {missing}")
        t0 = time.perf_counter()
        line = windows_phase(tables, oracles["windows"], device)
        line["phase_s"] = time.perf_counter() - t0
        emit(line)
        lines.append(line)
        before = native.counts()
        t0 = time.perf_counter()
        line = nested_phase(tables, oracles["nested"], data["n4"], device)
        line["phase_s"] = time.perf_counter() - t0
        line["launches"] = {k: v - before[k]
                            for k, v in native.counts().items()
                            if v != before[k]}
        emit(line)
        lines.append(line)
        missing = [k for k in PATH_KERNELS["nested"]
                   if line["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"nested did not launch {missing}")
        launches = native.counts()
        host_passes = native.host_counts()
    peak = max(line.get("peak_device_bytes", 0) for line in lines)
    phases = []
    for phase in (lambda: mesh_phase(data["mesh"], oracles["mesh"], device),
                  lambda: window_depth_ab(session, tables, oracles, device),
                  lambda: join_form_ab(session, tables, oracles, device),
                  lambda: q11_with_rows(session, tables, data, sf),
                  lambda: fusion_ab(session, tables, oracles, device),
                  lambda: outer_forms(session, tables, oracles, device)):
        t0 = time.perf_counter()
        r = phase()
        r["phase_s"] = time.perf_counter() - t0
        emit(r)
        phases.append(r)
    return lines, launches, host_passes, peak, phases, k15_shapes, k6_calls


def k6_shape(args, kwargs) -> tuple:
    """(lanes, build capacity, n_build, probe capacity, n_probe,
    lower_only) of a join_probe call; a tensor count is copied on the
    device (no synchronize), read after the counted run."""
    def count(n):
        return n.detach().clone() if hasattr(n, "detach") else int(n)
    build, n_build, probe = args[:3]
    n_probe = args[4] if len(args) > 4 else kwargs["n_probe"]
    lower = args[5] if len(args) > 5 else kwargs.get("lower_only", False)
    return (build.shape[0], build.shape[1], count(n_build), probe.shape[1],
            count(n_probe), bool(lower))


@contextlib.contextmanager
def recording(module, name: str, keep=lambda args, kwargs: tuple(args[:3])):
    """``module.<name>`` replaced, inside the block, by a pass-through
    that appends ``keep(args, kwargs)`` of each call (by default its first
    three positional arguments) to the list it yields: the shapes the
    engine gives a kernel's wrapper."""
    real = getattr(module, name)
    calls = []

    def record(*args, **kwargs):
        calls.append(keep(args, kwargs))
        return real(*args, **kwargs)
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


# oracles that must hold rows (a query checked against no row checks
# nothing)
NONEMPTY_ORACLES = ("q22", "q16", "q21", "tpcds_q98", "tpcds_q89")
# the counted run, in this order
MAIN_QUERIES = ("q6", "q1", "q3", "q12", "q4", "q13", "q11", "q15",
                "q22", "q2", "q17", "q5", "q10", "q14", "q18", "q19",
                "q20", "q7", "q8", "q9", "q16", "q21", "tpcds_q98",
                "tpcds_q89", "headline")


def q13_filtered_orders(t):
    from spark_rapids_tpu_torch.api.functions import col
    return t["orders"].filter(
        ~(col("o_comment").contains("special") &
          col("o_comment").contains("requests")))


def q13_right(t):
    """q13 with its join written the other way round: the filtered orders
    RIGHT OUTER JOIN customer (planned as the left join with the sides
    swapped, under _ReorderExec)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col
    per_cust = (q13_filtered_orders(t)
                .join(t["customer"],
                      on=(col("o_custkey") == col("c_custkey")),
                      how="right")
                .groupBy("c_custkey")
                .agg(F.count("o_orderkey").alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(col("custdist").desc(), col("c_count").desc()))


def full_outer(t):
    """customer FULL OUTER JOIN q13's filtered orders on the customer
    key: matched pairs, customers without an order and orders without a
    customer, counted and summed."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.functions import col
    return (t["customer"]
            .join(q13_filtered_orders(t),
                  on=(col("c_custkey") == col("o_custkey")), how="full")
            .agg(F.count("*"), F.count("c_custkey"), F.count("o_orderkey"),
                 F.sum("o_totalprice")))


OUTER_FORMS = {"q13_right": (q13_right, "q13", "_ReorderExec"),
               "full_outer": (full_outer, "full_outer", "[full]")}


def outer_forms(session, tables, oracles, device) -> dict:
    """The right and full outer joins, outside the counted run, in the
    shuffled form (the default at SF 10) and the broadcast form: per query
    and form one cold and three hot runs held to the oracle, the device
    peak over them and the kernels' launches in the cold run."""
    import torch
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch import native
    key = cfg.AUTO_BROADCAST_JOIN_THRESHOLD.key
    runs, phase = {}, {k: 0 for k in native.KERNELS}
    for form in ("shuffled", "broadcast"):
        session.conf.set(key, JOIN_FORMS[form].get(
            key, cfg.AUTO_BROADCAST_JOIN_THRESHOLD.default))
        for name, (qfn, oracle, op) in OUTER_FORMS.items():
            before = native.counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            check_rows(name, qfn(tables).collect(), oracles[oracle])
            cold = time.perf_counter() - t0
            cold_launches = {k: v - before[k]
                             for k, v in native.counts().items()}
            hots = []
            for _ in range(3):
                t0 = time.perf_counter()
                check_rows(name, qfn(tables).collect(), oracles[oracle])
                hots.append(time.perf_counter() - t0)
            after = native.counts()
            for k in phase:
                phase[k] += after[k] - before[k]
            plan = session.last_plan()
            tree = plan.operator_tree()
            want_join = "TpuShuffledJoinExec" if form == "shuffled" else \
                "TpuBroadcastExchangeExec"
            if op not in plan.tree_string() or want_join not in tree:
                raise AssertionError(f"{name} ({form}): plan lacks {op} or "
                                     f"{want_join}:\n{tree}")
            for k in ("join_expand_outer",) + (
                    ("build_matched",) if name == "full_outer" else ()):
                if cold_launches[k] <= 0:
                    raise AssertionError(f"{name} ({form}) did not launch "
                                         f"{k}")
            runs[f"{name}_{form}"] = {
                "cold_s": cold, "hot_s": min(hots),
                "peak_device_bytes": torch.cuda.max_memory_allocated(device),
                "launches_cold_run": {k: v for k, v in cold_launches.items()
                                      if v},
                "plan": tree.splitlines()}
    session.conf.set(key, cfg.AUTO_BROADCAST_JOIN_THRESHOLD.default)
    return {"phase": "outer_forms", "runs": runs, "phase_launches": phase,
            "oracle": "numpy, relative 1e-9"}


# q3 and q4 in the reference's shuffled form (the default at SF 10) and in
# the broadcast form (every build broadcast), in turns
JOIN_FORMS = {"shuffled": {}, "broadcast": {
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 40}}
JOIN_FORM_ORDER = ("shuffled", "broadcast", "broadcast", "shuffled")


def join_form_ab(session, tables, oracles, device) -> dict:
    """What the exchange costs: q3 and q4 in both join forms, in the order
    shuffled, broadcast, broadcast, shuffled. Per form and pass: one
    warm-up collect, the device peak reset, three hot runs held to the
    oracle; the least hot time, the peak and K11/K12's launches a run."""
    import torch
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch import native, queries
    key = cfg.AUTO_BROADCAST_JOIN_THRESHOLD.key
    runs = {f"{q}_{form}": {"hot_s": [], "peak_device_bytes": [],
                            "launches_per_run": [], "plan": None}
            for q in ("q3", "q4") for form in JOIN_FORMS}
    for form in JOIN_FORM_ORDER:
        session.conf.set(key, JOIN_FORMS[form].get(
            key, cfg.AUTO_BROADCAST_JOIN_THRESHOLD.default))
        for name in ("q3", "q4"):
            def run():
                check_rows(name, queries.QUERIES[name](tables).collect(),
                           oracles[name])
            run()
            before = native.counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            hots = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                hots.append(time.perf_counter() - t0)
            r = runs[f"{name}_{form}"]
            r["hot_s"].append(min(hots))
            r["peak_device_bytes"].append(
                torch.cuda.max_memory_allocated(device))
            r["launches_per_run"].append({
                k: (native.counts()[k] - before[k]) / len(hots)
                for k in ("murmur3", "partition_split")})
            r["plan"] = session.last_plan().operator_tree().splitlines()
    session.conf.set(key, cfg.AUTO_BROADCAST_JOIN_THRESHOLD.default)
    return {"phase": "join_form_ab", "order": list(JOIN_FORM_ORDER),
            "runs": runs,
            "note": "per form and pass: min of 3 hot runs, the device peak "
                    "over them, K11/K12 launches per run"}


# update-window depths of the A/B, run in three passes (in order, reversed,
# in order), so that drift of the host touches every depth alike
WINDOW_DEPTHS = (48, 8, 1)
WINDOW_ORDER = WINDOW_DEPTHS + WINDOW_DEPTHS[::-1] + WINDOW_DEPTHS


def window_depth_ab(session, tables, oracles, device) -> dict:
    """The headline and q1 at each update-window depth: after one warm-up
    collect, the device peak is reset and five hot runs are timed and held
    to the oracle. Launches do not depend on the depth (the window only
    defers reads); time and peak bytes may."""
    import torch
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch import native, queries
    runs = {f"{q}_depth{d}": {"hot_s": [], "peak_device_bytes": [],
                              "launches_per_run": []}
            for q in ("headline", "q1") for d in WINDOW_DEPTHS}
    cache = session.scan_cache
    for depth in WINDOW_ORDER:
        session.conf.set(cfg.AGG_PIPELINE_DEPTH.key, depth)
        for name in ("headline", "q1"):
            def run():
                got = queries.QUERIES[name](tables).collect()
                check_rows(name, sorted(got) if name == "headline" else got,
                           oracles[name])
            run()
            uploads = cache.uploads
            before = native.counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            hots = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()
                hots.append(time.perf_counter() - t0)
            if cache.uploads != uploads:
                raise AssertionError(f"window A/B: {name} hot runs at depth "
                                     f"{depth} uploaded columns")
            r = runs[f"{name}_depth{depth}"]
            r["hot_s"].append(min(hots))
            r["peak_device_bytes"].append(
                torch.cuda.max_memory_allocated(device))
            r["launches_per_run"].append({
                k: (native.counts()[k] - before[k]) / len(hots)
                for k in PATH_KERNELS[name]})
    session.conf.set(cfg.AGG_PIPELINE_DEPTH.key,
                     cfg.AGG_PIPELINE_DEPTH.default)
    return {"phase": "window_depth_ab", "order": list(WINDOW_ORDER),
            "runs": runs,
            "note": "per depth and pass: min of 5 hot runs, the device peak "
                    "over them and the path kernels' launches per run"}


FUSION_AB_QUERIES = ("q6", "q1", "q3", "q7", "headline")
FUSION_KEYS = ("spark.rapids.tpu.sql.wholeStageFusion.enabled",
               "spark.rapids.tpu.sql.fusion.wholeStage")


def _device_kernels(prof):
    """The device kernel events of a profile (copies and memsets apart):
    (count, {name: (calls, total us)}, total us)."""
    import torch
    by_name, total, count = {}, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        us = e.time_range.end - e.time_range.start
        calls, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, t + us)
        total += us
        count += 1
    return count, by_name, total


def update_stage_kernels(session, df) -> tuple:
    """(device kernels, input batches) of the update stage alone: the
    stage's input (the scan, join or exchange below its filters, projects
    and coalescing) is made first; then the stage (those execs, on the
    eager path, and the first non-final aggregate's update) runs over it
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.plan import physical as ph
    from spark_rapids_tpu_torch.plan import stage_compiler as sc
    plan = session.plan(df._analyzed())
    agg = next(n for n in _plan_nodes(plan)
               if isinstance(n, ph.TpuHashAggregateExec) and
               n.mode != "final")
    parent, node = agg, agg.children[0]
    while isinstance(node, (ph.TpuFilterExec, ph.TpuProjectExec,
                            ph.TpuCoalesceBatchesExec,
                            sc.TpuWholeStageExec)):
        parent, node = node, node.children[0]
    parts = [list(p) for p in node.execute()]
    parent.children[0] = _Batches(node, parts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for part in agg.children[0].execute():
            for b in part:
                if agg.grouping:
                    tok, stats = agg._update_dispatch(b)
                    agg._update_finish(tok, None, stats)
                else:
                    agg._update(b)
        torch.cuda.synchronize()
    for n in _plan_nodes(plan):
        n.release()
    node.release()
    return _device_kernels(prof)[0], sum(len(p) for p in parts)


def _Batches(node, parts):
    """An exec handing out ``parts`` (the batches ``node`` made) in its
    place."""
    from spark_rapids_tpu_torch.plan import physical as ph

    class Batches(ph.TpuExec):
        @property
        def schema(self):
            return node.schema

        @property
        def device(self):
            return node.device

        @property
        def output_partitions(self):
            return len(parts)

        def execute(self):
            return [iter(p) for p in parts]
    return Batches()


FUSION_ORDER = ("on", "off", "off", "on")


def fusion_ab(session, tables, oracles, device) -> dict:
    """q6, q1, q3, q7 and the headline with fusion on (both keys at their
    default) and off, in the order on, off, off, on: per query and pass
    the least of 3 hot runs and their peak bytes; in each setting's first
    pass also the update stage's device kernels per input batch
    (torch.profiler kernel events) and one profiled hot run's device
    busy time and top 5 device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch import queries
    runs = {}
    for name in FUSION_AB_QUERIES:
        qfn = queries.QUERIES[name]
        for setting in FUSION_ORDER:
            for key in FUSION_KEYS:
                session.conf.set(key, "true" if setting == "on" else "false")

            def run():
                got = qfn(tables).collect()
                check_rows(name, sorted(got) if name == "headline" else got,
                           oracles[name])
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            hots = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                hots.append(time.perf_counter() - t0)
            r = runs.setdefault(f"{name}_{setting}", {
                "hot_s": [], "hot_peak_device_bytes": []})
            r["hot_s"].append(min(hots))
            r["hot_peak_device_bytes"].append(
                torch.cuda.max_memory_allocated(device))
            if "update_kernels_per_batch" in r:
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            count, by_name, busy = _device_kernels(prof)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
            kernels, batches = update_stage_kernels(session, qfn(tables))
            decisions = session.last_fusion_decisions()
            r.update({
                "update_kernels_per_batch": kernels / max(batches, 1),
                "update_batches": batches,
                "profiled_run_s": wall, "device_kernels": count,
                "device_busy_s": busy / 1e6,
                "device_idle_share": max(0.0, 1.0 - busy / 1e6 / wall),
                "top5_device_kernels": [
                    {"name": k[:80], "calls": c, "ms": us / 1e3}
                    for k, (c, us) in top],
                "generated": [list(g) for g in decisions.generated]})
    for key in FUSION_KEYS:
        session.conf.set(key, "true")
    q6_on = runs["q6_on"]["update_kernels_per_batch"]
    if q6_on != 2:
        raise AssertionError(f"q6's fused update stage runs {q6_on} device "
                             f"kernels a scan batch, not 2 (K20 + K1's fold)")
    for name in FUSION_AB_QUERIES:
        on = runs[f"{name}_on"]["update_kernels_per_batch"]
        off = runs[f"{name}_off"]["update_kernels_per_batch"]
        if not on < off:
            raise AssertionError(f"{name}: fused update stage {on} kernels "
                                 f"a batch, eager {off}")
    return {"phase": "fusion_ab", "order": list(FUSION_ORDER), "runs": runs,
            "note": "hot_s: per pass the least of 3 hot runs; kernels "
                    "counted from torch.profiler's device kernel events "
                    "(copies and memsets apart) over the update stage's "
                    "input batches (scan batches for q6, q1 and the "
                    "headline, join output batches for q3 and q7); "
                    "device_idle_share = 1 - kernel time / wall time of one "
                    "profiled hot run"}


REPLACES = {
    "masked_reduce": "spark_rapids_tpu/ops/aggregates.py:227",
    "sort_key_lanes": "spark_rapids_tpu/ops/kernels.py:175",
    "segment_bounds": "spark_rapids_tpu/ops/kernels.py:338",
    "segment_reduce": "spark_rapids_tpu/ops/aggregates.py:95",
    "compact_scan": "spark_rapids_tpu/ops/kernels.py:235",
    "join_probe": "spark_rapids_tpu/ops/joins.py:119",
    "join_probe_lower": "spark_rapids_tpu/shuffle/partitioning.py:256, "
                        "spark_rapids_tpu/parallel/mesh.py:506",
    "join_expand": "spark_rapids_tpu/ops/joins.py:158",
    "dense_stats": "spark_rapids_tpu/ops/aggregates.py:382",
    "slot_aggregate": "spark_rapids_tpu/ops/aggregates.py:477",
    "singleword_rank": "spark_rapids_tpu/ops/aggregates.py:723",
    "murmur3": "spark_rapids_tpu/ops/hashing.py:123",
    "partition_split": "spark_rapids_tpu/shuffle/partitioning.py:41",
    "join_expand_outer": "spark_rapids_tpu/ops/joins.py:201",
    "find_pattern": "spark_rapids_tpu/ops/strings.py:74",
    "build_matched": "spark_rapids_tpu/ops/joins.py:147",
    "cross_expand": "spark_rapids_tpu/ops/joins.py:241",
    "string_map": "spark_rapids_tpu/ops/strings.py:110",
    "string_slice": "spark_rapids_tpu/ops/strings.py:182",
    "string_place": "spark_rapids_tpu/ops/strings.py:229",
    "find_pattern_locate": "spark_rapids_tpu/ops/strings.py:465",
    "masked_reduce_fold": "spark_rapids_tpu/ops/aggregates.py:227",
    "fused_stage": "spark_rapids_tpu/plan/stage_compiler.py:173, "
                   "spark_rapids_tpu/plan/physical.py:710",
    "fused_reduce": "spark_rapids_tpu/plan/stage_compiler.py:173, "
                    "spark_rapids_tpu/plan/physical.py:710",
    "window_rank": "spark_rapids_tpu/ops/window.py:161, 169",
    "window_offset": "spark_rapids_tpu/ops/window.py:190",
    "segmented_scan": "spark_rapids_tpu/ops/window.py:213, 264, 274",
    "frame_bounds": "spark_rapids_tpu/ops/window.py:309, 319, 330",
    "frame_aggregate": "spark_rapids_tpu/ops/window.py:368, 373",
    "explode_expand": "spark_rapids_tpu/ops/arrays.py:146, 165",
    "split_parts": "spark_rapids_tpu/ops/arrays.py:189, 200",
    "map_lookup": "spark_rapids_tpu/ops/maps.py:140",
    "map_build": "spark_rapids_tpu/ops/maps.py:74",
    "exchange_bucket": "spark_rapids_tpu/parallel/mesh.py:129",
    "exchange_flatten": "spark_rapids_tpu/parallel/mesh.py:166",
}


def bench_pipeline(device) -> dict:
    """The port bench's hand-built headline pipeline, once, at 64 M rows
    in a 2^26 capacity, validated as the bench validates it (against a
    numpy oracle here: the card's machine may lack pandas)."""
    from spark_rapids_tpu_torch import bench
    rows_per_s, sample = bench.bench_gpu(HEADLINE_ROWS, HEADLINE_CAP,
                                         device=device)
    expected = {k: (s, c, a) for k, s, c, a in oracle_headline(HEADLINE_ROWS)}
    groups = bench.validate(sample, expected)
    return {"phase": "bench_pipeline", "rows": HEADLINE_ROWS,
            "capacity": HEADLINE_CAP, "groups": groups,
            "rows_per_s": rows_per_s,
            "input_gb_per_s": rows_per_s * bench.BYTES_PER_ROW / 1e9,
            "validated": "counts exact, sums and averages 1e-6 relative"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the main path's lineitem")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the generated kernel-check inputs")
    ap.add_argument("--only", default="",
                    help="comma-separated kernel checks (check_k19,...) to "
                         "run alone, then stop without the result line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    import benchmarks.datagen  # noqa: F401  (fail early without the repo)

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    if not args.only:
        # the oracles run on host threads while nvcc builds the kernels
        data, gen_s = main_data(args.sf)
        pending = Oracles(data)
    build_s = native.build_seconds()
    gen = main_path_kernels(device)
    gen_build_s = native.build_generated(gen, device)
    emit({"phase": "build", "seconds": build_s, "built": list(native.SOURCES),
          "nvcc": native.nvcc_path(), "arch": " ".join(native.ARCH_FLAGS),
          # the main path's generated stage kernels (NVRTC, sm_90a,
          # --fmad=false), compiled and loaded once here
          "generated_kernels": len(gen), "generated_seconds": gen_build_s,
          "nvrtc_options": list(native.NVRTC_OPTIONS)})

    if not args.only:
        oracles, oracle_s = pending.join()

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    results = {}
    for check in (check_k1, check_k2, check_k3, check_k4, check_k5,
                  check_k6, check_k7, check_k7_outer, check_k8, check_k9,
                  check_k10, check_k11, check_k12, check_k13, check_k14,
                  check_k15, check_k16, check_k17, check_k18, check_locate,
                  check_k19, check_k20, check_k21, check_k22, check_k23,
                  check_k24, check_k25, check_k26, check_k27, check_k28,
                  check_k29, check_k30):
        if args.only and check.__name__ not in args.only.split(","):
            continue
        t0 = time.perf_counter()
        r = check(device, rng)
        torch.cuda.synchronize()
        r["phase_s"] = time.perf_counter() - t0
        if "fold" in r:
            results["masked_reduce_fold"] = {
                **r.pop("fold"), "timed_at": "q6's partials of one "
                                             "2^20-row batch"}
        for mode in r.pop("modes", ()):
            results[mode["name"]] = mode
            emit({"phase": "kernel", **mode})
        results[r["name"]] = r
        emit({"phase": "kernel", **r})
    if args.only:
        emit({"phase": "only", "checks": args.only,
              "generated": native.generated_stats()})
        return 0

    for check in (check_wide_keys, check_many_partitions):
        emit(check(device, rng))
        torch.cuda.synchronize()

    lines, launches, host_passes, peak, phases, k15_shapes, k6_calls = \
        main_path(args.sf, data, oracles, device)
    emit({"phase": "main_summary", "sf": args.sf, "datagen_s": gen_s,
          "oracle_s": oracle_s, "peak_device_bytes": peak,
          "launches": launches,
          # generated kernels compiled (NVRTC) or read from the cubin
          # cache, and the compile seconds, over the whole process
          "generated": native.generated_stats(),
          # the general LIKE's and replace's passes (host in the reference)
          "host_string_passes": host_passes})
    r = check_k15_main(device, k15_shapes)
    results["cross_expand"].update(r)
    emit({"phase": "kernel", **r})
    # K6 keeps q3's shape in the kernels line, its main-path call beside
    # it; the lower-bound mode's line takes its main-path call (range ids)
    r = check_k6_main(device, k6_calls)
    results["join_probe"]["timed_at_main_path"] = \
        r["timed_at_main_path"]["full"]
    lower = results["join_probe_lower"]
    lower["timed_at_q3"] = {k: lower[k] for k in TIMES}
    lower.update({k: r["timed_at_main_path"]["lower"][k] for k in TIMES},
                 timed_at_shape="its largest main-path call")
    emit({"phase": "kernel", **r})
    results["build_matched"]["phase_launches"] = \
        phases[-1]["phase_launches"]["build_matched"]
    (mesh,) = [p for p in phases if p["phase"] == "mesh"]
    for name in ("exchange_bucket", "exchange_flatten"):
        if launches[name]:
            raise AssertionError(f"the main path launched {name}: a mesh "
                                 "where mesh.enabled=auto on one card")
        results[name]["phase_launches"] = mesh["phase_launches"][name]
    unused = [k for k in native.KERNELS
              if k not in PHASE_KERNELS and launches[k] <= 0]
    if unused:
        raise AssertionError(f"main path never launched {unused}")
    for name in PHASE_KERNELS:
        if results[name]["phase_launches"] <= 0:
            raise AssertionError(f"its own phase never launched {name}")
    emit(bench_pipeline(device))

    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": GEN_SOURCE if name in native.GENERATED else
        "spark_rapids_tpu_torch/csrc/"
        f"{native.LIBRARY_OF.get(name, name)}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        **({"launched_by": PHASE_KERNELS[name],
            "phase_launches": results[name]["phase_launches"]}
           if name in PHASE_KERNELS else {}),
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": results[name]["library_ms"]}
        for name in native.KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
