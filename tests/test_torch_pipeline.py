"""The PyTorch port's deferred-scalar window (exec/pipeline.py) and the
aggregate's pipelined update stream built on it.

The window's cases are those of tests/test_pipeline_window.py for the
JAX package's PipelineWindow, on torch tensors. On the CPU a pushed tensor
is already a host value; the one-copy read of device tensors is the
pack/unpack pair tested here, and on the card chip_smoke.py drives it. The
exec-level tests hold the update stream to the same rows at every window
depth, on both group-by routes, with the batched reads counted.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import queries
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.exec import pipeline
from spark_rapids_tpu_torch.exec.pipeline import PipelineWindow
from spark_rapids_tpu_torch.plan import physical as ph


def test_depth1_degenerates_to_blocking():
    win = PipelineWindow(1)
    out = win.push(lambda v: ("r", int(v)), torch.tensor(7, dtype=torch.int32))
    assert out == [("r", 7)]
    assert len(win) == 0
    assert win.flush() == []
    assert win.resolves == 1


def test_window_fills_then_lands_oldest_half():
    win = PipelineWindow(4)
    res = []
    for i in range(3):
        res += win.push(lambda v, i=i: (i, int(v)),
                        torch.tensor(i * 10, dtype=torch.int32))
    assert res == [] and win.resolves == 0
    res += win.push(lambda v: (3, int(v)), torch.tensor(30))
    assert res == [(0, 0), (1, 10)]       # oldest half, FIFO
    assert win.resolves == 1              # in ONE batched read
    res += win.flush()
    assert res == [(0, 0), (1, 10), (2, 20), (3, 30)]
    assert len(win) == 0


def test_partition_end_flush_empty_window():
    assert PipelineWindow(8).flush() == []


def test_scalar_free_entries_ride_through():
    win = PipelineWindow(8)
    assert win.push(lambda: "now") == ["now"]
    assert win.push(lambda v: int(v), torch.tensor(5)) == []
    assert win.push(lambda: "later") == []     # FIFO: must not overtake
    assert win.flush() == [5, "later"]


def test_mixed_dtypes_arrays_and_host_values():
    win = PipelineWindow(4)
    stats = torch.tensor([3.0, 1.5e9], dtype=torch.float64)
    got = []
    win.push(lambda a, b, c: got.append((a, b, c)),
             torch.tensor(1 << 25, dtype=torch.int32), stats, 42)
    win.push(lambda v: got.append(v), torch.tensor(2, dtype=torch.int32))
    win.flush()
    a, b, c = got[0]
    assert int(a) == 1 << 25
    assert b.shape == (2,) and np.allclose(b, [3.0, 1.5e9])
    assert c == 42
    assert int(got[1]) == 2


def test_batched_resolve_is_one_read_per_landing():
    win = PipelineWindow(16)
    for i in range(8):
        win.push(lambda v: int(v), torch.tensor(i, dtype=torch.int32) + 1)
    assert win.flush() == [i + 1 for i in range(8)]
    assert win.resolves == 1 and win.resolved_scalars == 8


def test_packed_bytes_round_trip_every_dtype_and_shape():
    """What one device copy carries: every tensor's bytes, 8-byte aligned,
    read back with its dtype and shape (int64 beyond 2^53, NaN, bools)."""
    ts = [torch.tensor(True), torch.tensor([1, 2, 3], dtype=torch.int8),
          torch.tensor((1 << 62) + 1, dtype=torch.int64),
          torch.tensor([[1.5, float("nan")], [-0.0, 2.0]],
                       dtype=torch.float64),
          torch.tensor([7, -9], dtype=torch.int32)[1:],
          torch.tensor(2.5, dtype=torch.float32)]
    packed, spans = pipeline.pack_bytes(ts)
    assert packed.dtype == torch.uint8 and all(o % 8 == 0 for o, _n in spans)
    back = pipeline.unpack_bytes(packed, ts, spans)
    for t, b in zip(ts, back):
        np.testing.assert_array_equal(np.asarray(b), t.numpy())
        assert np.asarray(b).dtype == t.numpy().dtype
        assert np.shape(b) == tuple(t.shape)


def _run(depth, matmul: str, grouping: str = "k", batch_rows=1024,
         session=None):
    """Rows and aggregate node of a group-by over 8 update batches; depth
    None keeps the default."""
    conf = {"spark.rapids.torch.device": "cpu",
            "spark.rapids.tpu.sql.reader.batchSizeRows": batch_rows,
            "spark.rapids.tpu.sql.agg.matmul.enabled": matmul}
    if depth is not None:
        conf["spark.rapids.tpu.sql.agg.pipelineDepth"] = depth
    session = session or TpuSession.builder.config(conf).getOrCreate()
    data = queries.headline_table(8192)
    data["s"] = np.array([f"g{k % 7}" for k in data["k"]])
    df = session.createDataFrame(data)
    rows = (df.filter(F.col("flag") & (F.col("v") > F.lit(0.0)))
            .groupBy(grouping)
            .agg(F.sum("v").alias("sv"), F.count("v").alias("n"),
                 F.avg("v").alias("av"))
            .collect())
    agg = session.last_plan()
    while not isinstance(agg, ph.TpuHashAggregateExec):
        agg = agg.children[0]
    return sorted(rows), agg


@pytest.mark.parametrize("matmul,grouping", [("true", "k"), ("false", "k"),
                                             ("true", "s")])
def test_update_stream_same_rows_at_every_depth(matmul, grouping):
    """8 update batches: depth 1 reads each batch's stats as it comes
    (8 reads), depth 48 lands them all in one batched read."""
    r1, a1 = _run(1, matmul, grouping)
    r48, a48 = _run(48, matmul, grouping)
    keys, _kv, vals, valid, flags = queries.build_inputs(8192, 8192)
    kept = keys[flags & (vals > 0) & valid]
    assert r1 == r48
    assert len(r1) == len(np.unique(kept if grouping == "k" else kept % 7))
    assert a1.window.resolves == 8 and a48.window.resolves == 1
    assert a48.window.resolved_scalars == 8


def test_failed_batched_read_degrades_to_per_batch_reads(monkeypatch):
    want, _agg = _run(48, "true")
    monkeypatch.setattr(PipelineWindow, "_resolve",
                        lambda self, flat: [None] * len(flat))
    got, _agg = _run(48, "true")
    assert got == want


def test_default_depth_and_a_depth_set_on_the_session():
    """The default window (8) lands the 8 update batches in two reads of
    four; a depth set on the live session plans the next query with it."""
    rows, agg = _run(None, "true")
    assert agg.window.depth == 8 and agg.window.resolves == 2
    session = TpuSession.builder.config({
        "spark.rapids.torch.device": "cpu",
        "spark.rapids.tpu.sql.reader.batchSizeRows": 1024,
        "spark.rapids.tpu.sql.agg.matmul.enabled": "true"}).getOrCreate()
    session.conf.set("spark.rapids.tpu.sql.agg.pipelineDepth", 1)
    again, agg1 = _run(None, "true", session=session)
    assert again == rows
    assert agg1.window.depth == 1 and agg1.window.resolves == 8
