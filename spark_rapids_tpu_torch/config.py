"""Configuration of the PyTorch port: the keys of spark_rapids_tpu/config.py
that the main path reads, plus the device key.

A small copy of the reference's typed registry (it imports no jax, but the
port never imports the JAX package at all).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfEntry:
    key: str
    doc: str
    default: Any
    converter: Callable[[Any], Any]


DEVICE = ConfEntry(
    "spark.rapids.torch.device",
    "Torch device the session runs on: 'cuda' (default), 'cuda:N' or "
    "'cpu'. Session creation raises when a CUDA device is asked for and "
    "none is available: the port never moves to the CPU by itself.",
    "cuda", str)

BATCH_ROWS = ConfEntry(
    "spark.rapids.tpu.sql.reader.batchSizeRows",
    "Rows per scan batch, and the coalesce target below an aggregate.",
    1 << 20, int)


AGG_MATMUL = ConfEntry(
    "spark.rapids.tpu.sql.agg.matmul.enabled",
    "Group-by reductions over at most 4096 slots in any row order (K9): "
    "the dense-range route and the few-groups form of the sort route. "
    "'auto' turns them on for a CUDA device and off for the CPU, as the "
    "reference turns its MXU matmul reductions on for accelerators only; "
    "'true' or 'false' force it.",
    "auto", str)

AGG_PIPELINE_DEPTH = ConfEntry(
    "spark.rapids.tpu.sql.agg.pipelineDepth",
    "Update batches of a grouped aggregate in flight on the deferred-scalar "
    "window (exec/pipeline.PipelineWindow): each batch's stats read lands "
    "with its half-window peers in one device -> host copy. 1 reads every "
    "batch's stats as it comes. The reference's default is 48; on an H100 "
    "48 held ~3 GB more of q1's sort-route state than 8 and was no faster "
    "(chip_smoke.py's window_depth_ab).",
    8, int)


def matmul_agg_enabled(conf: "TorchConf", device) -> bool:
    """AGG_MATMUL resolved for a device (the reference's
    _matmul_agg_enabled)."""
    mode = str(conf.get(AGG_MATMUL)).lower()
    if mode in ("true", "1"):
        return True
    if mode in ("false", "0"):
        return False
    return getattr(device, "type", str(device)) == "cuda"


class TorchConf:
    """Typed view over a session's key -> value settings."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.converter(raw)

    def set(self, key: str, value: Any) -> None:
        """Change a setting; the next query plans with it."""
        self._settings[key] = value
