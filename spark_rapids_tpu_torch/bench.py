"""Benchmark of the PyTorch port on one NVIDIA GPU: the root bench.py's
headline and engine lines, measured through the port.

    python -m spark_rapids_tpu_torch.bench [--rows 64000000] [--sf 4]

Run from the repository root (the engine lines read benchmarks/datagen.py).
The headline is the root bench's pipeline, filter -> project -> dense-range
group-by (sum, count, avg of v * 2 + 1 where flag and v > 0, grouped by an
int64 key over 1024 values), built by hand from the port's eager ops over
one ``--rows``-row batch in a 2^26 capacity: K8 finds the key range, K9
aggregates the slots, K5 compacts them. Iterations are launched back to
back with the row count varied, and every result is read at the end. The
same query on single-core pandas is the baseline; the first run must agree
with it (counts exact, sums and averages within 1e-6 relative) or the
bench fails. The engine lines run TPC-H q6 and q1 at ``--sf`` through the
port's session (one cold run, then the best of two warm runs).

Prints ONE json line with the root bench's keys for what it measures. The
root bench's ``matmul_tflops`` has no counterpart: the port's group-by does
no matrix product (K9 adds in f64 in shared memory). Without a CUDA device
the bench fails: its numbers are device numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from .queries import HEADLINE_KEYS, build_inputs

BYTES_PER_ROW = 8 + 1 + 8 + 1 + 1      # key, key validity, v, v validity, flag


def k_slots() -> int:
    """The slot bucket of the key span: bucket(span + 2), the dense
    dispatch's own derivation."""
    from .columnar.column import bucket
    return bucket(HEADLINE_KEYS + 2, 128)


def pipeline(keys, key_valid, vals, val_valid, flags, num_rows: int,
             K_slots: int):
    """One run of the headline pipeline on device tensors: (group keys, key
    validity, sum, count, avg, group count), all on the device."""
    import torch
    from .columnar import dtypes as dt
    from .columnar.column import Column
    from .ops import aggregates as A
    cap = keys.shape[0]
    live = torch.arange(cap, device=keys.device) < num_rows
    keep = live & flags & val_valid & (vals > 0)
    kcol = Column(dt.INT64, keys, key_valid)
    proj = Column(dt.FLOAT64, vals * 2.0 + 1.0, val_valid)
    rmin, _decision = A.dense_key_stats(kcol, num_rows, extra_mask=keep)
    out_keys, out_aggs, n_groups = A.groupby_dense(
        kcol, [A.AggSpec("sum", proj), A.AggSpec("count", proj),
               A.AggSpec("avg", proj)], num_rows, K_slots, rmin,
        extra_mask=keep)
    return (out_keys[0].data, out_keys[0].validity, out_aggs[0].data,
            out_aggs[1].data, out_aggs[2].data, n_groups)


def bench_gpu(n_rows: int, cap: int, iters: int = 8, device="cuda"):
    """The root bench's bench_tpu on the card: (rows/s, host arrays of the
    first run for validation)."""
    import torch
    args = [torch.from_numpy(a).to(device) for a in build_inputs(n_rows, cap)]
    K_slots = k_slots()
    sample = [x.cpu().numpy() for x in pipeline(*args, n_rows, K_slots)]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = [pipeline(*args, n_rows - i, K_slots) for i in range(iters)]
    for o in outs:                                # read EVERY iteration
        o[3].cpu()
    dt_s = (time.perf_counter() - t0) / iters
    return n_rows / dt_s, sample


def bench_pandas(n_rows: int, cap: int, iters: int = 2):
    import pandas as pd
    keys, key_valid, vals, val_valid, flags = build_inputs(n_rows, cap)
    df = pd.DataFrame({
        "k": keys[:n_rows],
        "v": np.where(val_valid[:n_rows], vals[:n_rows], np.nan),
        "flag": flags[:n_rows]})
    t0 = time.perf_counter()
    for _ in range(iters):
        sub = df[df["flag"] & (df["v"] > 0)]
        proj = sub.assign(p=sub["v"] * 2.0 + 1.0)
        res = proj.groupby("k")["p"].agg(["sum", "count", "mean"])
    dt_s = (time.perf_counter() - t0) / iters
    return n_rows / dt_s, res


def validate(sample, expected) -> int:
    """The run must agree with the oracle (counts exact, sums and averages
    within 1e-6 relative, the same group set): a bench that drifts from it
    is void. ``expected`` maps key -> (sum, count, mean); returns the group
    count."""
    gk, gkv, gsum, gcnt, gavg, ng = sample
    ng = int(ng)
    got = {int(k): (s, int(c), a)
           for k, kv, s, c, a in zip(gk[:ng], gkv[:ng], gsum[:ng],
                                     gcnt[:ng], gavg[:ng]) if kv}
    assert ng == len(got) == len(expected), (ng, len(got), len(expected))
    for k, (e_sum, e_cnt, e_mean) in expected.items():
        s, c, a = got[int(k)]
        assert c == int(e_cnt), (k, c, e_cnt)
        assert abs(s - e_sum) <= 1e-6 * max(1.0, abs(e_sum)), (k, s, e_sum)
        assert abs(a - e_mean) <= 1e-6 * max(1.0, abs(e_mean)), (k, a, e_mean)
    return len(got)


def pandas_expected(res) -> dict:
    return {int(k): (float(r["sum"]), int(r["count"]), float(r["mean"]))
            for k, r in res.iterrows()}


def _pandas_query(query: str, li):
    if query == "q6":
        sub = li[(li.l_shipdate >= 8766) & (li.l_shipdate < 9131) &
                 (li.l_discount >= 0.05) & (li.l_discount <= 0.07) &
                 (li.l_quantity < 24)]
        return (sub.l_extendedprice * sub.l_discount).sum()
    sub = li[li.l_shipdate <= 10471]
    g = sub.assign(
        disc_price=sub.l_extendedprice * (1 - sub.l_discount),
        charge=sub.l_extendedprice * (1 - sub.l_discount) * (1 + sub.l_tax))
    return g.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))


def bench_engine(sf: float, query: str, iters: int = 2, device="cuda"):
    """TPC-H ``query`` through the port's session: (warm rows/s, pandas
    rows/s, cold s)."""
    import pandas as pd
    from benchmarks import datagen
    from . import queries
    from .api.session import TpuSession
    session = TpuSession.builder.config(
        {"spark.rapids.torch.device": str(device)}).getOrCreate()
    cols = datagen.gen_lineitem(sf)
    tables = {"lineitem": session.createDataFrame(
        cols, schema=queries.table_schema(cols))}
    n_rows = len(cols["l_orderkey"])
    qfn = queries.QUERIES[query]
    t0 = time.perf_counter()
    qfn(tables).collect()
    cold_s = time.perf_counter() - t0
    hots = []
    for _ in range(iters):
        t0 = time.perf_counter()
        qfn(tables).collect()
        hots.append(time.perf_counter() - t0)
    li = pd.DataFrame(cols)
    t0 = time.perf_counter()
    _pandas_query(query, li)
    pd_s = time.perf_counter() - t0
    return n_rows / min(hots), n_rows / pd_s, cold_s


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64_000_000,
                    help="rows of the headline batch (capacity 2^26)")
    ap.add_argument("--sf", type=float, default=4.0,
                    help="TPC-H scale factor of the engine lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    from .columnar.column import bucket
    device = torch.device("cuda", 0)
    n_rows = args.rows
    cap = bucket(n_rows)
    gpu_rows_per_s, sample = bench_gpu(n_rows, cap, device=device)
    cpu_rows_per_s, pd_res = bench_pandas(n_rows, cap)
    n_groups = validate(sample, pandas_expected(pd_res))
    engine = {}
    for q in ("q6", "q1"):
        eng_rps, pd_rps, cold_s = bench_engine(args.sf, q, device=device)
        engine[f"engine_{q}_mrows_per_s"] = round(eng_rps / 1e6, 3)
        engine[f"engine_{q}_vs_pandas"] = round(eng_rps / pd_rps, 2)
        engine[f"engine_{q}_cold_s"] = round(cold_s, 1)
    print(json.dumps({
        "metric": "fused filter+project+groupby throughput",
        "value": round(gpu_rows_per_s / 1e6, 2),
        "unit": "Mrows/s",
        "vs_baseline": round(gpu_rows_per_s / cpu_rows_per_s, 2),
        "rows": n_rows,
        "groups": n_groups,
        "input_gb_per_s": round(gpu_rows_per_s * BYTES_PER_ROW / 1e9, 2),
        "baseline_mrows_per_s": round(cpu_rows_per_s / 1e6, 2),
        "engine_sf": args.sf,
        **engine,
        "backend": "gpu",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
