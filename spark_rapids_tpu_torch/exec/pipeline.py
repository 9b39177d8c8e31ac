"""Deferred-scalar pipeline window: the port of
spark_rapids_tpu/exec/pipeline.py (``PipelineWindow``).

An operator that sizes its next step from a device value (a group count,
the dense route's key statistics) would stall the stream if it read that
value per batch: the host waits for the device to drain. The window lets
the operator queue the batch's second half instead:

* ``push(continuation, *device_values)`` queues the continuation, which is
  called later with the HOST values of the pushed tensors;
* when the window holds ``depth`` entries, the oldest half lands: every
  landing entry's tensors come back in ONE device -> host copy into pinned
  memory (their bytes packed together), followed by one event wait, and
  the continuations run in FIFO order;
* ``flush()`` lands everything at the end of the stream.

depth=1 reads every entry as it is pushed. An entry with no tensors runs at
once when nothing older is pending, so scalar-free streams stay incremental.
If the batched read fails, each landing continuation gets ``None`` per
value and re-reads its own.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, List

import torch

_ALIGN = 8


class PipelineWindow:
    """FIFO window of (device values, continuation) pairs read back in
    batched copies. One window per partition drain."""

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._pending: deque = deque()
        # how many batched reads ran, how many values they carried, how
        # many device -> host copies they made, and how many failed
        self.resolves = 0
        self.resolved_scalars = 0
        self.copies = 0
        self.resolve_failures = 0

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, continuation: Callable[..., Any], *values) -> List[Any]:
        """Queue one entry; returns the results of the entries that landed
        because of it (FIFO order, possibly none)."""
        if not values and not self._pending:
            return [continuation()]
        self._pending.append((list(values), continuation))
        if len(self._pending) >= self.depth:
            return self._land(max(self.depth // 2, 1))
        return []

    def flush(self) -> List[Any]:
        """Land every pending entry (end of the stream)."""
        out: List[Any] = []
        while self._pending:
            out.extend(self._land(max(self.depth // 2, 1)))
        return out

    def _land(self, k: int) -> List[Any]:
        k = min(k, len(self._pending))
        entries = [self._pending.popleft() for _ in range(k)]
        flat = [v for values, _cont in entries for v in values]
        vals = self._resolve(flat)
        if flat:
            self.resolves += 1
            self.resolved_scalars += len(flat)
        results: List[Any] = []
        pos = 0
        for values, cont in entries:
            results.append(cont(*vals[pos:pos + len(values)]))
            pos += len(values)
        return results

    def _resolve(self, flat: List[Any]) -> List[Any]:
        """Host values of the pushed tensors (0-d -> numpy scalar, else a
        numpy array of the same shape); anything else passes through."""
        vals: List[Any] = list(flat)
        on_device = [i for i, v in enumerate(flat)
                     if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
        for i, v in enumerate(flat):
            if isinstance(v, torch.Tensor) and v.device.type == "cpu":
                vals[i] = _host_value(v.detach().numpy(), v.shape)
        if not on_device:
            return vals
        try:
            for i, host in zip(on_device,
                               self._read_back([flat[i] for i in on_device])):
                vals[i] = host
        except Exception as e:   # a launched kernel failed: degrade per entry
            self.resolve_failures += 1
            logging.getLogger("spark_rapids_tpu_torch.pipeline").warning(
                "pipeline window batched read failed (landing entries "
                "re-read their own values): %s", e)
            for i in on_device:
                vals[i] = None
        return vals

    def _read_back(self, tensors: List[torch.Tensor]) -> List[Any]:
        """One copy for all: the tensors' bytes packed on the device, copied
        non_blocking into pinned memory, then one event wait."""
        packed, spans = pack_bytes(tensors)
        host = torch.empty(packed.numel(), dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))
        done.synchronize()
        self.copies += 1
        return unpack_bytes(host, tensors, spans)


def pack_bytes(tensors: List[torch.Tensor]):
    """(uint8 tensor on the tensors' device, (offset, bytes) of each): every
    tensor's bytes, each padded to 8 bytes so every view stays aligned."""
    device = tensors[0].device
    chunks, spans, off = [], [], 0
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % _ALIGN
        chunks.append(b)
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8, device=device))
        spans.append((off, b.numel()))
        off += b.numel() + pad
    return (torch.cat(chunks) if len(chunks) > 1 else chunks[0]), spans


def unpack_bytes(host: torch.Tensor, tensors: List[torch.Tensor], spans):
    """The host values of ``tensors`` from their packed bytes."""
    return [_host_value(host[o:o + n].view(t.dtype).numpy(), t.shape)
            for t, (o, n) in zip(tensors, spans)]


def _host_value(arr, shape):
    arr = arr.reshape(tuple(shape))
    return arr[()] if arr.ndim == 0 else arr
