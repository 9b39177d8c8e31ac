"""SPMD execution over a mesh of workers: the port of
spark_rapids_tpu/parallel/mesh.py.

The reference runs one controller over a jax device mesh: every stage is
one ``shard_map`` program whose exchange is ``lax.all_to_all``, and the
host drivers (``run_*``) take one ColumnarBatch per worker and return one
per worker. The port keeps that shape. A :class:`Mesh` is n workers, each
bound to a torch device (round robin over the visible devices of the
session's type, ``spark.rapids.torch.mesh.workers`` of them); when there
are fewer devices than workers, workers share a device, the counterpart of
the reference's virtual CPU mesh. A stage is a per-worker generator
function written as the reference's ``per_worker``: where the reference
calls a collective, it yields :class:`AllToAll` or :class:`AllGather`, and
:func:`run_spmd` runs every worker up to that point, performs the
collective (:class:`Collective`) and resumes them with its result.

  map side:   per-worker partial op (partial aggregate, sort keys, ids)
  exchange:   K29 buckets rows into [n, cap] slots by target worker, the
              all_to_all moves slot t of worker w to slot w of worker t,
              K30 flattens the received slots into n x cap rows
  reduce:     per-worker final op (merge aggregate, join, sort)

Two hand-written CUDA kernels live here, each with a plain PyTorch twin
that is the reference's formula:

* K29 :func:`bucket_rows_for_exchange` (csrc/exchange_bucket.cu, twin
  :func:`_bucket_rows_torch`): K12's stable order of the rows by target,
  then every payload array placed into its slots in one launch.
* K30 :func:`flatten_received` (csrc/exchange_flatten.cu, twin
  :func:`_flatten_received_torch`): the received slots into one array per
  payload array, the prefix sum of the counts in shared memory.

A wrapper runs its twin only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises. The all_to_all between workers of one
device is one transpose of the stacked [n_src, n_dst, cap, ...] tensors;
between devices it copies each slot to its owner. Every other step reuses
ported kernels: K2-K4 (the aggregates' sort route, the sorts), K6 (range
ids), K11 (murmur3) and K12 (the receiver's partition sort).

The layout is the reference's, so every array compares one for one:
``bucket()`` capacities, bool validity, strings as uint8[N, W] + int32
lengths, receive windows of n x cap rows (key skew cannot drop a row).
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cfg
from .. import native
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, bucket, build_column, storage_dtype
from ..ops import aggregates as agg_k
from ..ops import hashing
from ..ops import joins as join_k
from ..ops import kernels as K
from ..shuffle.partitioning import partition_split


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def visible_devices(device_type: str) -> List[torch.device]:
    """The devices of one type a mesh may place workers on."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no mesh over {device_type!r} devices")


class Collective:
    """all_to_all and all_gather between the workers of a mesh."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        # one device for every worker: a transpose is the whole exchange
        self.shared = len({str(d) for d in self.devices}) == 1

    def all_to_all(self, sends: List[List[torch.Tensor]]
                   ) -> List[List[torch.Tensor]]:
        """``sends[w][i]``: worker w's i-th array, its slot t (leading
        axis) bound for worker t. Returns ``recv[t][i]`` with
        ``recv[t][i][w] = sends[w][i][t]`` (the reference's
        ``all_to_all(a, axis, 0, 0, tiled=False)``)."""
        n = len(sends)
        k = len(sends[0])
        recv: List[List[torch.Tensor]] = [[] for _ in range(n)]
        for i in range(k):
            if self.shared:
                moved = torch.stack([s[i] for s in sends]).transpose(
                    0, 1).contiguous()
                for t in range(n):
                    recv[t].append(moved[t])
                continue
            for t in range(n):
                a = sends[0][i]
                r = torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                                device=self.devices[t])
                for w in range(n):
                    r[w].copy_(sends[w][i][t])
                recv[t].append(r)
        return recv

    def all_gather(self, parts: List[List[torch.Tensor]]
                   ) -> List[List[torch.Tensor]]:
        """``parts[w][i]``: worker w's i-th array; every worker receives
        the arrays of all workers concatenated in worker order (the
        reference's ``all_gather(a, axis, tiled=True)``)."""
        n = len(parts)
        k = len(parts[0])
        if self.shared:
            gathered = [torch.cat([p[i] for p in parts]) for i in range(k)]
            return [gathered for _ in range(n)]
        return [[torch.cat([p[i].to(self.devices[t]) for p in parts])
                 for i in range(k)] for t in range(n)]


class Mesh:
    """n workers, worker w on ``devices[w]``. ``devices.size`` is the
    worker count, as on a jax Mesh."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i] = torch.device(d)
        self.collective = Collective(list(self.devices))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """``n_devices`` workers (default: one per visible device of the
    type), placed round robin on the visible devices."""
    devs = visible_devices(device_type)
    if not devs:
        raise RuntimeError(f"no visible {device_type} device for a mesh")
    n = n_devices or len(devs)
    return Mesh([devs[w % len(devs)] for w in range(n)])


def maybe_mesh(conf: Optional[cfg.TorchConf] = None,
               device: Optional[torch.device] = None) -> Optional[Mesh]:
    """The active mesh per ``spark.rapids.tpu.sql.mesh.enabled``: 'true'
    forces one over ``spark.rapids.torch.mesh.workers`` workers and raises
    below 2; 'auto' gives one on a CUDA session with at least 2 workers;
    'false' none. Planner entry point. No failure is swallowed: the
    reference's 'auto' returns None on any exception, which would plan
    the host path quietly."""
    conf = conf or cfg.TorchConf()
    device = torch.device(device if device is not None else
                          conf.get(cfg.DEVICE))
    mode = conf.get(cfg.MESH_ENABLED)
    if mode in ("false", "0"):
        return None
    workers = conf.get(cfg.MESH_WORKERS)
    if workers is None:
        workers = len(visible_devices(device.type))
    if mode in ("true", "1"):
        if workers < 2:
            raise RuntimeError(
                f"{cfg.MESH_ENABLED.key}=true but the mesh has {workers} "
                f"worker(s) ({cfg.MESH_WORKERS.key}): SPMD execution needs "
                "at least 2")
        return make_mesh(workers, device.type)
    if device.type != "cuda" or workers < 2:
        return None
    return make_mesh(workers, device.type)


class AllToAll(NamedTuple):
    """A worker's side of one all_to_all: its [n, cap, ...] slot stacks
    and int32[n] counts. The worker resumes with (received stacks,
    received counts)."""
    arrays: List[torch.Tensor]
    counts: torch.Tensor


class AllGather(NamedTuple):
    """A worker's side of one all_gather; it resumes with the gathered
    arrays."""
    arrays: List[torch.Tensor]


def _current(device: torch.device):
    """The worker's device as the current CUDA device while its code runs
    (the kernels launch on the current device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_spmd(mesh: Mesh, per_worker: Callable, inputs: Sequence[tuple]
             ) -> List[Any]:
    """Run ``per_worker(*inputs[w])`` for every worker w, on its device,
    and return their results. A per-worker generator yields its
    collectives: every worker runs to its next yield, the collective runs
    over all of them, and each resumes with its share. All workers must
    yield the same collectives in the same order."""
    n = mesh.size
    if len(inputs) != n:
        raise ValueError(f"{len(inputs)} inputs for {n} workers")
    runs = []
    for device, args in zip(mesh.devices, inputs):
        with _current(device):
            runs.append(per_worker(*args))
    if not all(inspect.isgenerator(r) for r in runs):
        return runs
    replies: List[Any] = [None] * n
    while True:
        asks, results = [], []
        for device, run, reply in zip(mesh.devices, runs, replies):
            try:
                with _current(device):
                    asks.append(run.send(reply))
            except StopIteration as stop:
                results.append(stop.value)
        if len(results) == n:
            return results
        if results or len({type(a) for a in asks}) != 1:
            raise RuntimeError("mesh workers diverged: not every worker "
                               "reached the same collective")
        if isinstance(asks[0], AllToAll):
            moved = mesh.collective.all_to_all(
                [list(a.arrays) + [a.counts] for a in asks])
            replies = [(m[:-1], m[-1]) for m in moved]
        elif isinstance(asks[0], AllGather):
            replies = mesh.collective.all_gather([list(a.arrays)
                                                  for a in asks])
        else:
            raise TypeError(f"unknown collective {asks[0]!r}")


# ---------------------------------------------------------------------------
# K29 / K30: the exchange's data plane
# ---------------------------------------------------------------------------

def _unit(t: torch.Tensor, row_bytes: int) -> int:
    """The widest of 8, 4, 2, 1 bytes dividing a row and the alignment."""
    for u in (8, 4, 2):
        if row_bytes % u == 0 and t.data_ptr() % u == 0:
            return u
    return 1


def _row_bytes(t: torch.Tensor) -> int:
    return int(t.element_size() * (t[0].numel() if t.dim() > 1 else 1))


def _descs(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
           ) -> ctypes.Array:
    out = (native.ExchangeArray * max(1, len(pairs)))()
    for d, (src, dst) in zip(out, pairs):
        rb = _row_bytes(src)
        d.src, d.dst, d.row_bytes = src.data_ptr(), dst.data_ptr(), rb
        d.unit = min(_unit(src, rb), _unit(dst, rb))
    return out


def _check_arrays(arrays: Sequence[torch.Tensor], rows: int, device,
                  what: str) -> None:
    for a in arrays:
        if a.device != device or a.shape[0] != rows:
            raise ValueError(f"{what}: array {tuple(a.shape)} on "
                             f"{a.device} does not hold {rows} rows on "
                             f"{device}")


def bucket_rows_for_exchange(arrays: Sequence[torch.Tensor],
                             pids: torch.Tensor, live: torch.Tensor,
                             n_workers: int, cap: int
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pack rows into [n_workers, cap] slots by target worker id: slot t
    holds, in their original order, the live rows with ``pids == t``,
    compacted to the front and zero-padded. Returns (stacked arrays
    [n, cap, ...], counts int32[n]). K12 + K29 on the card."""
    device = pids.device
    if device.type == "cpu":
        return _bucket_rows_torch(arrays, pids, live, n_workers, cap)
    if device.type != "cuda":
        raise RuntimeError(
            f"bucket_rows_for_exchange: unsupported device {device}")
    n = int(n_workers)
    lib = native.library("exchange_bucket")
    if not 1 <= n <= lib.exchange_bucket_max_workers():
        raise ValueError(f"exchange over {n} workers")
    _check_arrays(list(arrays) + [pids, live], cap, device,
                  "bucket_rows_for_exchange")
    target = torch.where(live & (pids >= 0) & (pids < n), pids,
                         n).to(torch.int32).contiguous()
    perm, counts = partition_split(target, cap, n)
    srcs = [a.contiguous() for a in arrays]
    outs = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=device)
            for a in srcs]
    step = lib.exchange_bucket_max_arrays()
    for lo in range(0, len(srcs), step):
        pairs = list(zip(srcs[lo:lo + step], outs[lo:lo + step]))
        rc = lib.exchange_bucket(_descs(pairs), len(pairs), perm.data_ptr(),
                                 counts.data_ptr(), n, cap,
                                 native.stream_ptr(device))
        native.check(rc, "exchange_bucket")
        native.bump("exchange_bucket")
    return outs, counts


def _bucket_rows_torch(arrays: Sequence[torch.Tensor], pids: torch.Tensor,
                       live: torch.Tensor, n_workers: int, cap: int
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch twin of K29: the reference's n compactions, gathers
    and wheres."""
    outs: List[List[torch.Tensor]] = [[] for _ in arrays]
    counts = []
    for t in range(n_workers):
        keep = live & (pids == t)
        perm, cnt = K._compaction_indices_torch(keep)
        slot_live = torch.arange(cap, device=pids.device) < cnt
        for i, a in enumerate(arrays):
            g = a[perm]
            mask = slot_live if g.dim() == 1 else \
                slot_live.reshape((cap,) + (1,) * (g.dim() - 1))
            outs[i].append(torch.where(mask, g, torch.zeros(
                (), dtype=g.dtype, device=g.device)))
        counts.append(cnt)
    return [torch.stack(o) for o in outs], \
        torch.stack(counts).to(torch.int32)


def flatten_received(stacked: Sequence[torch.Tensor], counts: torch.Tensor,
                     out_cap: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """[n, cap, ...] received slots -> one [out_cap, ...] array each, the
    slots' live rows in slot order, zeros after; and the total (int32
    0-d, on the device). K30 on the card."""
    device = counts.device
    if device.type == "cpu":
        return _flatten_received_torch(stacked, counts, out_cap)
    if device.type != "cuda":
        raise RuntimeError(f"flatten_received: unsupported device {device}")
    n = int(counts.shape[0])
    lib = native.library("exchange_flatten")
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous int32[n] tensor")
    srcs = [a.contiguous() for a in stacked]
    cap = int(srcs[0].shape[1]) if srcs else 1
    for a in srcs:
        if a.device != device or tuple(a.shape[:2]) != (n, cap):
            raise ValueError(f"flatten_received: slots {tuple(a.shape)} on "
                             f"{a.device}, want [{n}, {cap}, ...] on "
                             f"{device}")
    outs = [torch.empty((out_cap,) + tuple(a.shape[2:]), dtype=a.dtype,
                        device=device) for a in srcs]
    total = torch.empty(1, dtype=torch.int32, device=device)
    step = lib.exchange_flatten_max_arrays()
    for lo in range(0, max(len(srcs), 1), step):
        # a slot's row layout; s[0] starts where the whole [n, cap, ...]
        pairs = [(s[0], o) for s, o in zip(srcs[lo:lo + step],
                                           outs[lo:lo + step])]
        rc = lib.exchange_flatten(_descs(pairs), len(pairs),
                                  counts.data_ptr(), n,
                                  cap, out_cap, total.data_ptr(),
                                  native.stream_ptr(device))
        native.check(rc, "exchange_flatten")
        native.bump("exchange_flatten")
    return outs, total.reshape(())


def _flatten_received_torch(stacked: Sequence[torch.Tensor],
                            counts: torch.Tensor, out_cap: int
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch twin of K30: the reference's cumsum, searchsorted,
    gather and where."""
    n = int(counts.shape[0])
    cap = int(stacked[0].shape[1]) if stacked else 1
    c = counts.to(torch.int64)
    incl = torch.cumsum(c, 0)
    starts = incl - c
    total = c.sum()
    out_i = torch.arange(out_cap, device=counts.device)
    live = out_i < total
    slot = torch.clamp(torch.searchsorted(incl, out_i, right=True), 0, n - 1)
    offset = torch.clamp(out_i - starts[slot], 0, cap - 1)
    outs = []
    for a in stacked:
        flat = a[slot, offset]
        mask = live if flat.dim() == 1 else \
            live.reshape((out_cap,) + (1,) * (flat.dim() - 1))
        outs.append(torch.where(mask, flat, torch.zeros(
            (), dtype=flat.dtype, device=flat.device)))
    return outs, total.to(torch.int32)


# ---------------------------------------------------------------------------
# Columns <-> flat arrays
# ---------------------------------------------------------------------------

def _column_arrays(cols: Sequence[Column]) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for c in cols:
        out.extend(c.arrays())
    return out


def _rebuild_columns(schema_dtypes: Sequence[dt.DType],
                     arrays: Sequence[torch.Tensor]) -> List[Column]:
    cols, i = [], 0
    for t in schema_dtypes:
        c, i = build_column(t, arrays, i)
        cols.append(c)
    return cols


def _n_arrays(dtypes: Sequence[dt.DType]) -> int:
    return sum(3 if t.var_width else 2 for t in dtypes)


def _update_plan(agg_ops: Sequence[str], val_dtypes: Sequence[dt.DType]
                 ) -> List[List[Tuple[str, dt.DType]]]:
    """Per input aggregate, the update-phase partial columns carried
    through the exchange: avg is sum + count, divided only after the
    merge, which keeps a distributed avg exact."""
    plan = []
    for op, t in zip(agg_ops, val_dtypes):
        if op == "avg":
            plan.append([("sum", dt.FLOAT64), ("count", dt.INT64)])
        elif op in ("count", "count_star"):
            plan.append([(op, dt.INT64)])
        else:
            plan.append([(op, agg_k.result_dtype(op, t))])
    return plan


def output_dtypes(agg_ops: Sequence[str], val_dtypes: Sequence[dt.DType]
                  ) -> List[dt.DType]:
    return [agg_k.result_dtype(op, t) for op, t in zip(agg_ops, val_dtypes)]


def _merge_ops(plan) -> List[str]:
    """Counts and avg partials merge by SUM, the rest with their own op."""
    return ["sum" if op in ("count", "count_star") else op
            for cols in plan for (op, _t) in cols]


def _update_specs(plan, val_cols: Sequence[Column]) -> List[agg_k.AggSpec]:
    specs = []
    for cols_plan, c in zip(plan, val_cols):
        for (uop, ut) in cols_plan:
            cc = c
            if ut == dt.FLOAT64 and c.dtype != dt.FLOAT64 and uop == "sum":
                cc = Column(dt.FLOAT64, c.data.to(torch.float64), c.validity)
            specs.append(agg_k.AggSpec(uop, cc))
    return specs


def _finalize(agg_ops, plan, aggs: Sequence[Column]) -> List[Column]:
    """Divide the avg partials after the merge."""
    out: List[Column] = []
    ai = 0
    for op, cols_plan in zip(agg_ops, plan):
        if op == "avg":
            s, c = aggs[ai], aggs[ai + 1]
            valid = s.validity & (c.data > 0)
            data = torch.where(
                valid, s.data / torch.clamp(c.data.to(torch.float64),
                                            min=1.0), 0.0)
            out.append(Column(dt.FLOAT64, data, valid))
        else:
            out.append(aggs[ai])
        ai += len(cols_plan)
    return out


def _live(cap: int, n, device) -> torch.Tensor:
    return torch.arange(cap, device=device) < n


def _to_host(values: Sequence[torch.Tensor]) -> np.ndarray:
    """Every worker's tensor (one shape), stacked, in one device -> host
    copy."""
    return torch.stack([v.to(values[0].device) for v in values]).cpu(
    ).numpy()


def _host_counts(counts: Sequence[torch.Tensor]) -> List[int]:
    return [int(v) for v in _to_host([c.reshape(()) for c in counts])]


def _stack_shards(batches: Sequence[ColumnarBatch], cap: int,
                  devices) -> List[List[torch.Tensor]]:
    """Per worker, its batch's arrays rebucketed to the common ``cap``
    (strings widened to the widest shard's width) on its device."""
    widths = {}
    for b in batches:
        for i, c in enumerate(b.columns):
            if c.dtype.var_width:
                widths[i] = max(widths.get(i, 0), int(c.data.shape[1]))
    out = []
    for b, device in zip(batches, devices):
        arrays = []
        for i, c in enumerate(b.columns):
            if c.capacity != cap:
                c = K.rebucket_column(c, b.num_rows, cap)
            if i in widths and c.data.shape[1] < widths[i]:
                c = Column(c.dtype, torch.nn.functional.pad(
                    c.data, (0, widths[i] - c.data.shape[1])), c.validity,
                    c.lengths)
            arrays.extend(a.to(device) for a in c.arrays())
        out.append(arrays)
    return out


def _results(schema: dt.Schema, dtypes, outs) -> List[ColumnarBatch]:
    rows = _host_counts([o[1] for o in outs])
    return [ColumnarBatch(schema, _rebuild_columns(dtypes, arrays), n)
            for (arrays, _c), n in zip(outs, rows)]


def _agg_schema(key_dtypes, agg_dtypes) -> dt.Schema:
    fields = [dt.Field(f"k{i}", t) for i, t in enumerate(key_dtypes)]
    fields += [dt.Field(f"a{i}", t) for i, t in enumerate(agg_dtypes)]
    return dt.Schema(fields)


# ---------------------------------------------------------------------------
# Reduce-partition exchange: the ICI plane of TpuShuffleExchangeExec
# ---------------------------------------------------------------------------

def partition_exchange_fn(mesh: Mesh, col_dtypes: Sequence[dt.DType],
                          cap: int, num_partitions: int):
    """Per-worker exchange of rows to their reduce partition's owner: every
    worker buckets its rows by owning worker (``pid % n``), one all_to_all
    delivers them, and the receiver orders its rows stably by partition id
    (K12), so each owned partition is one contiguous run. Output per
    worker: every payload array sorted by partition id (padding last) and
    the int32 per-partition counts."""
    n = mesh.size
    out_cap = n * cap

    def per_worker(arrays, pids, local_n):
        live = _live(cap, local_n, pids.device)
        owner = torch.remainder(pids, n).to(torch.int32)
        payload = list(arrays) + [pids]
        stacked, counts = bucket_rows_for_exchange(payload, owner, live, n,
                                                   cap)
        moved, moved_counts = yield AllToAll(stacked, counts)
        flat, recv_n = flatten_received(moved, moved_counts, out_cap)
        order, pcounts = partition_split(flat[-1], recv_n, num_partitions)
        return [a[order] for a in flat[:-1]], pcounts

    return per_worker


def run_partition_exchange(mesh: Mesh, batches: List[ColumnarBatch],
                           pids: List[torch.Tensor], num_partitions: int
                           ) -> List[Tuple[List[Column], np.ndarray]]:
    """Host driver of the ICI exchange plane: one shard and its int32[cap]
    partition ids per worker in; per worker out (columns sorted by reduce
    partition id, host counts int32[num_partitions]). Worker w holds the
    partitions with ``p % n == w`` as contiguous runs. The counts read is
    the exchange's one host sync."""
    n = mesh.size
    assert len(batches) == n and len(pids) == n, "one shard per worker"
    cap = max(b.capacity for b in batches)
    col_dtypes = [c.dtype for c in batches[0].columns]
    stacked = _stack_shards(batches, cap, mesh.devices)
    pid_stack = [torch.nn.functional.pad(p.to(torch.int32),
                                         (0, cap - p.shape[0])).to(d)
                 for p, d in zip(pids, mesh.devices)]
    fn = partition_exchange_fn(mesh, col_dtypes, cap, num_partitions)
    outs = run_spmd(mesh, fn, [(s, p, b.num_rows) for s, p, b in
                               zip(stacked, pid_stack, batches)])
    pcounts = _to_host([o[1] for o in outs])     # the one read
    return [(_rebuild_columns(col_dtypes, arrays), pcounts[w])
            for w, (arrays, _c) in enumerate(outs)]


# ---------------------------------------------------------------------------
# Distributed group-by
# ---------------------------------------------------------------------------

def distributed_groupby_fn(mesh: Mesh, key_dtypes: Sequence[dt.DType],
                           val_dtypes: Sequence[dt.DType],
                           agg_ops: Sequence[str], cap: int):
    """The per-worker SPMD group-by: partial aggregate -> bucket the groups
    by ``pmod(murmur3(keys), n)`` (K11) -> all_to_all -> merge aggregate
    -> avg finalize. Output per worker: its final groups (disjoint key
    ownership). Receive windows are n x cap: each of the n peers may send
    all of its ``cap`` groups to one owner under key skew."""
    n = mesh.size
    plan = _update_plan(agg_ops, val_dtypes)
    partial_dtypes = [t for cols in plan for (_op, t) in cols]
    merge_ops = _merge_ops(plan)
    out_cap = n * cap
    nk = _n_arrays(key_dtypes)

    def per_worker(arrays, local_n):
        key_cols = _rebuild_columns(key_dtypes, arrays[:nk])
        val_cols = _rebuild_columns(val_dtypes, arrays[nk:])
        # 1. local partial aggregate (update phase)
        out_keys, out_aggs, n_groups = agg_k.groupby_aggregate(
            key_cols, _update_specs(plan, val_cols), local_n, cap)
        # 2. bucket the groups by owner -> all_to_all
        pids = hashing.hash_partition_ids(out_keys, n_groups, cap, n)
        live = _live(cap, n_groups, pids.device)
        payload = _column_arrays(out_keys) + _column_arrays(out_aggs)
        stacked, counts = bucket_rows_for_exchange(payload, pids, live, n,
                                                   cap)
        moved, moved_counts = yield AllToAll(stacked, counts)
        flat, recv_n = flatten_received(moved, moved_counts, out_cap)
        # 3. merge aggregate over the received partials
        recv_keys = _rebuild_columns(key_dtypes, flat[:nk])
        recv_aggs = _rebuild_columns(partial_dtypes, flat[nk:])
        f_keys, f_aggs, f_groups = agg_k.groupby_aggregate(
            recv_keys, [agg_k.AggSpec(m, c)
                        for m, c in zip(merge_ops, recv_aggs)],
            recv_n, out_cap)
        # 4. finalize
        out_cols = _finalize(agg_ops, plan, f_aggs)
        return _column_arrays(f_keys) + _column_arrays(out_cols), f_groups

    return per_worker


def run_distributed_groupby(mesh: Mesh, batches: List[ColumnarBatch],
                            key_idx: List[int], val_idx: List[int],
                            agg_ops: List[str],
                            window_rows: Optional[int] = None
                            ) -> List[ColumnarBatch]:
    """Host driver: one shard per worker in, one result batch per worker
    out (columns k0.., a0..). ``window_rows`` switches to the multi-round
    streaming path (bounded per-round residency)."""
    n = mesh.size
    assert len(batches) == n, "one shard per worker"
    cap = max(b.capacity for b in batches)
    key_dtypes = [batches[0].columns[i].dtype for i in key_idx]
    val_dtypes = [batches[0].columns[i].dtype for i in val_idx]
    if window_rows is not None and window_rows < cap:
        if all(not t.var_width for t in key_dtypes + val_dtypes):
            return run_distributed_groupby_streaming(
                mesh, batches, key_idx, val_idx, agg_ops, window_rows)
        if all(t == dt.STRING or not t.var_width for t in key_dtypes) and \
                all(not t.var_width for t in val_dtypes):
            return _run_streaming_string_keys(
                mesh, batches, key_idx, val_idx, agg_ops, window_rows)
    proj = [ColumnarBatch(
        _agg_schema(key_dtypes, val_dtypes),
        [b.columns[i] for i in key_idx + val_idx], b.num_rows)
        for b in batches]
    stacked = _stack_shards(proj, cap, mesh.devices)
    fn = distributed_groupby_fn(mesh, key_dtypes, val_dtypes, agg_ops, cap)
    outs = run_spmd(mesh, fn, [(s, b.num_rows)
                               for s, b in zip(stacked, batches)])
    agg_dtypes = output_dtypes(agg_ops, val_dtypes)
    return _results(_agg_schema(key_dtypes, agg_dtypes),
                    key_dtypes + agg_dtypes, outs)


# ---------------------------------------------------------------------------
# Co-partition exchange (the SPMD shuffled join's data plane)
# ---------------------------------------------------------------------------

def copartition_exchange_fn(mesh: Mesh, col_dtypes: Sequence[dt.DType],
                            key_positions: Sequence[int], cap: int):
    """Per-worker row exchange by ``pmod(murmur3(keys), n)``: one
    all_to_all delivers every row to its key's owner, so the per-worker
    join runs on co-partitioned shards. Receive windows are n x cap."""
    n = mesh.size
    out_cap = n * cap

    def per_worker(arrays, local_n):
        cols = _rebuild_columns(col_dtypes, arrays)
        key_cols = [cols[i] for i in key_positions]
        pids = hashing.hash_partition_ids(key_cols, local_n, cap, n)
        live = _live(cap, local_n, pids.device)
        stacked, counts = bucket_rows_for_exchange(
            _column_arrays(cols), pids, live, n, cap)
        moved, moved_counts = yield AllToAll(stacked, counts)
        return flatten_received(moved, moved_counts, out_cap)

    return per_worker


def run_copartition_exchange(mesh: Mesh, batches: List[ColumnarBatch],
                             key_positions: Sequence[int]
                             ) -> List[ColumnarBatch]:
    """Host driver of one side of an SPMD shuffled join: per-worker
    co-partitioned batches (same key -> same worker)."""
    n = mesh.size
    assert len(batches) == n, "one shard per worker"
    cap = max(b.capacity for b in batches)
    col_dtypes = [c.dtype for c in batches[0].columns]
    stacked = _stack_shards(batches, cap, mesh.devices)
    fn = copartition_exchange_fn(mesh, col_dtypes, key_positions, cap)
    outs = run_spmd(mesh, fn, [(s, b.num_rows)
                               for s, b in zip(stacked, batches)])
    return _results(batches[0].schema, col_dtypes, outs)


# ---------------------------------------------------------------------------
# Distributed sort: sample -> all_gather -> bounds -> all_to_all -> sort
# ---------------------------------------------------------------------------

_SAMPLE_PER_WORKER = 64


def distributed_sort_fn(mesh: Mesh, col_dtypes: Sequence[dt.DType],
                        key_positions: Sequence[int],
                        ascending: Sequence[bool],
                        nulls_first: Sequence[bool], cap: int):
    """The per-worker SPMD global sort:

      1. sample 64 evenly spaced live rows; all_gather the samples
      2. every worker sorts the same global sample (K2 + stable
         ``torch.sort``, invalid samples last) and takes the same n - 1
         bound rows
      3. a row's partition is the count of bounds strictly below it: K2
         lanes of bounds and rows, K6's lower bound
      4. all_to_all to the range owner (n x cap receive windows)
      5. local sort of the received shard (K2 + ``torch.sort``)

    Worker w's output is the w-th key range, sorted, so the workers'
    outputs in order are the total order."""
    n = mesh.size
    out_cap = n * cap
    s = _SAMPLE_PER_WORKER
    keys_of = list(zip(key_positions, ascending, nulls_first))
    key_dtypes = [col_dtypes[p] for p in key_positions]

    def sort_keys(cols):
        return [K.SortKey(cols[p], a, f) for p, a, f in keys_of]

    def per_worker(arrays, local_n):
        device = arrays[0].device
        cols = _rebuild_columns(col_dtypes, arrays)
        # 1. sample s evenly spaced live rows (invalid when local_n == 0)
        pick = (torch.arange(s, device=device) * max(local_n, 1)) // s
        pick = torch.clamp(pick, 0, cap - 1)
        s_valid = torch.arange(s, device=device) < local_n
        s_cols = [K.gather_column(cols[p], pick) for p in key_positions]
        gathered = yield AllGather(_column_arrays(s_cols) + [s_valid])
        g_cols = _rebuild_columns(key_dtypes, gathered[:-1])
        g_valid = gathered[-1]
        # 2. the same global-sample order on every worker -> bound rows
        g_keys = [K.SortKey(c, a, f) for c, (_p, a, f) in
                  zip(g_cols, keys_of)]
        pid = torch.zeros(cap, dtype=torch.int32, device=device)
        if n > 1:
            order = K.sort_indices(g_keys, n * s, n * s, live_mask=g_valid)
            total = g_valid.sum()
            gi = torch.clamp((torch.arange(1, n, device=device) * total)
                             // n, 0, n * s - 1)
            bcap = bucket(n - 1)
            bidx = torch.nn.functional.pad(order[gi], (0, bcap - (n - 1)))
            blive = torch.arange(bcap, device=device) < n - 1
            b_keys = [K.SortKey(K.gather_column(c, bidx, out_valid=blive),
                                a, f) for c, (_p, a, f) in
                      zip(g_cols, keys_of)]
            # 3. partition id = bounds strictly below the row
            b_lanes = K.sort_key_lanes(b_keys, n - 1, bcap)
            r_lanes = K.sort_key_lanes(sort_keys(cols), cap, cap)
            lo, _, _ = join_k.join_probe(b_lanes, n - 1, r_lanes, [], cap,
                                         lower_only=True)
            pid = torch.clamp(lo, 0, n - 1).to(torch.int32)
        # 4. route rows to their range owner
        live = _live(cap, local_n, device)
        stacked, counts = bucket_rows_for_exchange(
            _column_arrays(cols), pid, live, n, cap)
        moved, moved_counts = yield AllToAll(stacked, counts)
        flat, recv_n = flatten_received(moved, moved_counts, out_cap)
        # 5. local sort of the received shard
        recv_cols = _rebuild_columns(col_dtypes, flat)
        idx = K.sort_indices(sort_keys(recv_cols), recv_n, out_cap)
        return _column_arrays([K.gather_column(c, idx)
                               for c in recv_cols]), recv_n

    return per_worker


def run_distributed_sort(mesh: Mesh, batches: List[ColumnarBatch],
                         key_positions: Sequence[int],
                         ascending: Sequence[bool],
                         nulls_first: Sequence[bool]) -> List[ColumnarBatch]:
    """Host driver: per-worker sorted range shards (their concatenation in
    worker order is the total order)."""
    n = mesh.size
    assert len(batches) == n, "one shard per worker"
    cap = max(b.capacity for b in batches)
    col_dtypes = [c.dtype for c in batches[0].columns]
    stacked = _stack_shards(batches, cap, mesh.devices)
    fn = distributed_sort_fn(mesh, col_dtypes, key_positions,
                             tuple(ascending), tuple(nulls_first), cap)
    outs = run_spmd(mesh, fn, [(s, b.num_rows)
                               for s, b in zip(stacked, batches)])
    return _results(batches[0].schema, col_dtypes, outs)


# ---------------------------------------------------------------------------
# Streaming group-by: bounded windows per round, a carried accumulator
# ---------------------------------------------------------------------------

def distributed_groupby_round_fn(mesh: Mesh, key_dtypes, val_dtypes,
                                 agg_ops, w_cap: int, acc_cap: int):
    """One streaming round of the SPMD group-by: partial-aggregate a window
    of input, exchange the partials, merge them into the carried
    accumulator of merge-phase partials. A round holds n x w_cap received
    rows and the accumulator, whatever the input's size. Fixed-width keys
    and values only. The group count comes back unclamped, so the host
    can see an accumulator overflow instead of dropping groups."""
    n = mesh.size
    assert all(not t.var_width for t in key_dtypes), "fixed-width keys only"
    plan = _update_plan(agg_ops, val_dtypes)
    partial_dtypes = [t for cols in plan for (_op, t) in cols]
    assert all(not t.var_width for t in partial_dtypes)
    merge_ops = _merge_ops(plan)
    recv_cap = n * w_cap
    mid_cap = acc_cap + recv_cap
    nk = len(key_dtypes) * 2

    def per_worker(win, local_n, acc, acc_n):
        device = win[0].device
        key_cols = _rebuild_columns(key_dtypes, win[:nk])
        val_cols = _rebuild_columns(val_dtypes, win[nk:])
        # 1. partial aggregate of this window
        out_keys, out_aggs, n_groups = agg_k.groupby_aggregate(
            key_cols, _update_specs(plan, val_cols), local_n, w_cap)
        # 2. route the partials to their owners
        pids = hashing.hash_partition_ids(out_keys, n_groups, w_cap, n)
        live = _live(w_cap, n_groups, device)
        payload = _column_arrays(out_keys) + _column_arrays(out_aggs)
        stacked, counts = bucket_rows_for_exchange(payload, pids, live, n,
                                                   w_cap)
        moved, moved_counts = yield AllToAll(stacked, counts)
        flat, recv_n = flatten_received(moved, moved_counts, recv_cap)
        # 3. merge the received partials into the accumulator: both blocks
        # are live in a prefix of their own range, so a live mask over
        # their concatenation needs no compaction in between
        def cat(a: Column, b: Column) -> Column:
            return Column(a.dtype, torch.cat([a.data, b.data]),
                          torch.cat([a.validity, b.validity]))
        m_keys = [cat(a, b) for a, b in zip(
            _rebuild_columns(key_dtypes, acc[:nk]),
            _rebuild_columns(key_dtypes, flat[:nk]))]
        m_aggs = [cat(a, b) for a, b in zip(
            _rebuild_columns(partial_dtypes, acc[nk:]),
            _rebuild_columns(partial_dtypes, flat[nk:]))]
        live_mask = torch.cat([_live(acc_cap, acc_n, device),
                               _live(recv_cap, recv_n, device)])
        f_keys, f_aggs, f_groups = agg_k.groupby_aggregate(
            m_keys, [agg_k.AggSpec(m, c) for m, c in zip(merge_ops, m_aggs)],
            mid_cap, mid_cap, live_mask=live_mask)
        # 4. carry: groups come first; the accumulator keeps acc_cap slots
        out = []
        for c in f_keys + f_aggs:
            out.append(c.data[:acc_cap])
            out.append(c.validity[:acc_cap])
        return out, f_groups

    return per_worker


def _finalize_groupby_fn(mesh: Mesh, key_dtypes, val_dtypes, agg_ops,
                         acc_cap: int):
    """After the last round: divide the avg partials (no collective)."""
    plan = _update_plan(agg_ops, val_dtypes)
    partial_dtypes = [t for cols in plan for (_op, t) in cols]
    nk = len(key_dtypes) * 2

    def per_worker(acc, acc_n):
        keys = _rebuild_columns(key_dtypes, acc[:nk])
        aggs = _rebuild_columns(partial_dtypes, acc[nk:])
        return _column_arrays(keys) + _column_arrays(
            _finalize(agg_ops, plan, aggs)), acc_n

    return per_worker


def run_distributed_groupby_streaming(mesh: Mesh,
                                      batches: List[ColumnarBatch],
                                      key_idx: List[int],
                                      val_idx: List[int],
                                      agg_ops: List[str],
                                      window_rows: int,
                                      acc_cap: Optional[int] = None
                                      ) -> List[ColumnarBatch]:
    """Multi-round windowed SPMD group-by: each round slices
    ``window_rows`` rows per worker, runs one exchange-and-merge round and
    carries the group partials in a bounded accumulator. One read of the
    group counts per round checks for an accumulator overflow."""
    n = mesh.size
    assert len(batches) == n, "one shard per worker"
    key_dtypes = [batches[0].columns[i].dtype for i in key_idx]
    val_dtypes = [batches[0].columns[i].dtype for i in val_idx]
    plan = _update_plan(agg_ops, val_dtypes)
    partial_dtypes = [t for cols in plan for (_op, t) in cols]
    w_cap = bucket(window_rows)
    acc_cap = acc_cap or n * w_cap
    rounds = max(1, -(-max(b.num_rows for b in batches) // window_rows))
    fn = distributed_groupby_round_fn(mesh, key_dtypes, val_dtypes, agg_ops,
                                      w_cap, acc_cap)
    # a zeroed accumulator per worker: data and validity per key/partial
    accs: List[List[torch.Tensor]] = []
    for device in mesh.devices:
        acc = []
        for t in key_dtypes + partial_dtypes:
            acc.append(torch.zeros(acc_cap, dtype=storage_dtype(t),
                                   device=device))
            acc.append(torch.zeros(acc_cap, dtype=torch.bool, device=device))
        accs.append(acc)
    acc_ns = [0] * n
    for r in range(rounds):
        lo = r * window_rows
        inputs = []
        for w, (b, device) in enumerate(zip(batches, mesh.devices)):
            take = min(max(b.num_rows - lo, 0), window_rows)
            win = []
            for i in key_idx + val_idx:
                c = K.slice_column(b.columns[i], lo, w_cap, take)
                win.extend(a.to(device) for a in c.arrays())
            inputs.append((win, take, accs[w], acc_ns[w]))
        outs = run_spmd(mesh, fn, inputs)
        groups = _host_counts([o[1] for o in outs])
        if max(groups) > acc_cap:
            raise RuntimeError(
                f"streaming group-by accumulator overflow: a worker owns "
                f"{max(groups)} groups > capacity {acc_cap}; raise the "
                "mesh window/accumulator size")
        accs = [o[0] for o in outs]
        acc_ns = groups
    ffn = _finalize_groupby_fn(mesh, key_dtypes, val_dtypes, agg_ops,
                               acc_cap)
    outs = run_spmd(mesh, ffn, list(zip(accs, acc_ns)))
    agg_dtypes = output_dtypes(agg_ops, val_dtypes)
    schema = _agg_schema(key_dtypes, agg_dtypes)
    return [ColumnarBatch(schema, _rebuild_columns(
        key_dtypes + agg_dtypes, arrays), int(acc_n))
        for arrays, acc_n in outs]


def _string_key_words(col: Column, w8: int) -> List[Column]:
    """Exact fixed-width encoding of a STRING key column: the zero-padded
    byte matrix viewed as ``w8 / 8`` little-endian int64 word columns,
    plus one length column, so string keys ride the streaming path's
    fixed-width machinery (no hashing, no collisions). Bytes past a
    length and the bytes of NULL rows are zeroed first: the port's
    kernels leave junk there, and equal strings must give equal words."""
    data = col.data
    w = data.shape[1]
    keep = (torch.arange(w, device=data.device)[None, :] <
            col.lengths[:, None]) & col.validity[:, None]
    data = torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))
    if w < w8:
        data = torch.nn.functional.pad(data, (0, w8 - w))
    words = data.contiguous().view(torch.int64)
    out = [Column(dt.INT64, words[:, j].contiguous(), col.validity)
           for j in range(w8 // 8)]
    lengths = torch.where(col.validity, col.lengths, 0).to(torch.int64)
    out.append(Column(dt.INT64, lengths, col.validity))
    return out


def _string_from_words(word_cols: List[Column], length_col: Column
                       ) -> Column:
    """Inverse of :func:`_string_key_words`."""
    data = torch.stack([wc.data for wc in word_cols], dim=1).contiguous(
    ).view(torch.uint8)
    validity = length_col.validity
    lens = torch.where(validity, length_col.data, 0).to(torch.int32)
    data = torch.where(validity[:, None], data,
                       torch.zeros((), dtype=torch.uint8,
                                   device=data.device))
    return Column(dt.STRING, data, validity, lens)


def _run_streaming_string_keys(mesh: Mesh, batches: List[ColumnarBatch],
                               key_idx: List[int], val_idx: List[int],
                               agg_ops: List[str], window_rows: int
                               ) -> List[ColumnarBatch]:
    """Streaming SPMD group-by with STRING keys: word-encode per shard,
    stream fixed-width, decode the result keys."""
    key_dtypes = [batches[0].columns[i].dtype for i in key_idx]
    # one width per string key across all shards
    w8s = {}
    for ki, t in zip(key_idx, key_dtypes):
        if t == dt.STRING:
            w = max(int(b.columns[ki].data.shape[1]) for b in batches)
            w8s[ki] = ((w + 7) // 8) * 8
    enc_batches = []
    for b in batches:
        cols: List[Column] = []
        for ki in key_idx:
            c = b.columns[ki]
            cols.extend(_string_key_words(c, w8s[ki]) if ki in w8s else [c])
        cols.extend(b.columns[vi] for vi in val_idx)
        fields = [dt.Field(f"e{i}", c.dtype) for i, c in enumerate(cols)]
        enc_batches.append(ColumnarBatch(dt.Schema(fields), cols,
                                         b.num_rows))
    n_enc_keys = len(enc_batches[0].columns) - len(val_idx)
    res = run_distributed_groupby_streaming(
        mesh, enc_batches, list(range(n_enc_keys)),
        list(range(n_enc_keys, n_enc_keys + len(val_idx))), agg_ops,
        window_rows)
    # decode: w8 / 8 + 1 encoded key columns per string key
    out = []
    for rb in res:
        dec_keys: List[Column] = []
        i = 0
        for ki in key_idx:
            if ki in w8s:
                nw = w8s[ki] // 8
                dec_keys.append(_string_from_words(
                    rb.columns[i:i + nw], rb.columns[i + nw]))
                i += nw + 1
            else:
                dec_keys.append(rb.columns[i])
                i += 1
        aggs = list(rb.columns[i:])
        out.append(ColumnarBatch(
            _agg_schema([c.dtype for c in dec_keys], [c.dtype for c in aggs]),
            dec_keys + aggs, rb.num_rows))
    return out
