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


class TorchConf:
    """Typed view over a session's key -> value settings."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.converter(raw)
