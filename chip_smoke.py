#!/usr/bin/env python3
"""Drive the PyTorch port (spark_rapids_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 10] [--seed 7]

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every hand-written kernel from csrc/ with nvcc (sm_90a),
     timed; every kernel is rebuilt, whatever _build/ already holds;
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (2^20-row batches) and at edge cases, with the stated
     tolerance, plus CUDA-event timings of kernel, twin and (where one
     exists) the single PyTorch call computing the same function;
  4. the main path: TPC-H q6 and q1 through TpuSession -> DataFrame ->
     collect on benchmarks/datagen.py lineitem data at scale factor --sf,
     held to a numpy oracle computed independently from the same arrays;
     the launch counters are zeroed just before and read just after, and
     every kernel of each query's path must have launched; the warm runs
     must be served from the device scan cache (no column uploaded, no
     cache entry refused).
Then the kernel summary line, the card line and, last, the result line
{"ok": true, "device": {...}}. Any failure raises: exit code != 0 and no
result line. Without a CUDA device, or without the repository beside it,
the script exits != 0 before printing anything.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)


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


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sector_bytes(mask, elem_bytes: int) -> int:
    """Bytes of the 32-byte DRAM sectors of an array of ``elem_bytes``-byte
    elements that hold at least one element where ``mask`` is set: what a
    kernel that loads only those elements must move."""
    import torch
    idx = mask.nonzero().flatten()
    return 32 * int(torch.unique(idx * elem_bytes // 32).numel())


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


def check_rows(name: str, got, want, rel: float = 1e-9) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                if not close(float(x), y, rel):
                    raise AssertionError(f"{name}: {g} vs oracle {w}")
            elif x != y:
                raise AssertionError(f"{name}: {g} vs oracle {w}")


PATH_KERNELS = {"q6": ("masked_reduce",),
                "q1": ("sort_key_lanes", "segment_bounds", "segment_reduce")}


def main_path(sf: float, device) -> tuple:
    import torch
    from benchmarks import datagen
    from spark_rapids_tpu_torch import native, queries
    from spark_rapids_tpu_torch.api.session import TpuSession
    t0 = time.perf_counter()
    data = datagen.gen_lineitem(sf)
    gen_s = time.perf_counter() - t0
    n_rows = len(data["l_orderkey"])
    oracles = {"q6": [(oracle_q6(data),)], "q1": oracle_q1(data)}
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": str(device)}).getOrCreate()
    cache = session.scan_cache
    tables = {"lineitem": session.createDataFrame(
        data, schema=queries.lineitem_schema(data))}
    torch.cuda.reset_peak_memory_stats(device)
    native.reset_counts()
    lines = []
    for name in ("q6", "q1"):
        qfn = queries.QUERIES[name]
        before = native.counts()
        uploads = cache.uploads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = qfn(tables).collect()
        cold = time.perf_counter() - t0
        cold_launches = {k: v - before[k] for k, v in native.counts().items()}
        check_rows(name, rows, oracles[name])
        cold_uploads = cache.uploads - uploads
        resident = (cache.bytes, cache.uploads)
        hots = []
        for _ in range(3):
            t0 = time.perf_counter()
            hot_rows = qfn(tables).collect()
            hots.append(time.perf_counter() - t0)
            check_rows(name, hot_rows, oracles[name])
        if cache.refused or (cache.bytes, cache.uploads) != resident:
            raise AssertionError(
                f"{name}: warm runs not served from the scan cache "
                f"(bytes {resident[0]} -> {cache.bytes}, uploads "
                f"{resident[1]} -> {cache.uploads}, refused {cache.refused})")
        missing = [k for k in PATH_KERNELS[name] if cold_launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name} did not launch {missing}")
        n_batches = -(-n_rows // (1 << 20))
        lines.append({
            "phase": "main", "query": name, "sf": sf, "rows": n_rows,
            "batches": n_batches, "cold_s": cold,
            "hot_s": min(hots), "hot_rows_per_s": n_rows / min(hots),
            "launches_cold_run": cold_launches,
            "launches_per_batch": {k: v / n_batches
                                   for k, v in cold_launches.items()},
            "scan_column_batches_uploaded_cold": cold_uploads,
            "scan_cache_bytes": cache.bytes,
            "result_rows": len(rows), "oracle": "numpy, relative 1e-9"})
    launches = native.counts()
    peak = torch.cuda.max_memory_allocated(device)
    return lines, launches, peak, gen_s


REPLACES = {
    "masked_reduce": "spark_rapids_tpu/ops/aggregates.py:227",
    "sort_key_lanes": "spark_rapids_tpu/ops/kernels.py:175",
    "segment_bounds": "spark_rapids_tpu/ops/kernels.py:338",
    "segment_reduce": "spark_rapids_tpu/ops/aggregates.py:95",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the main path's lineitem")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the generated kernel-check inputs")
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

    build_s = native.build_seconds()
    emit({"phase": "build", "seconds": build_s, "built": list(native.KERNELS),
          "nvcc": native.nvcc_path(), "arch": " ".join(native.ARCH_FLAGS)})

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    results = {}
    for check in (check_k1, check_k2, check_k3, check_k4):
        r = check(device, rng)
        torch.cuda.synchronize()
        results[r["name"]] = r
        emit({"phase": "kernel", **r})

    lines, launches, peak, gen_s = main_path(args.sf, device)
    for line in lines:
        emit(line)
    emit({"phase": "main_summary", "sf": args.sf, "datagen_s": gen_s,
          "peak_device_bytes": peak, "launches": launches})
    unused = [k for k in native.KERNELS if launches[k] <= 0]
    if unused:
        raise AssertionError(f"main path never launched {unused}")

    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"spark_rapids_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
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
