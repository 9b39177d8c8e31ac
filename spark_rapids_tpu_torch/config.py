"""Configuration of the PyTorch port: the keys of spark_rapids_tpu/config.py
that the ported paths read, plus the device key.

A small copy of the reference's typed registry (it imports no jax, but the
port never imports the JAX package at all).
"""

from __future__ import annotations

import re
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


SHUFFLE_PARTITIONS = ConfEntry(
    "spark.rapids.tpu.sql.shuffle.partitions",
    "Partitions of a hash exchange (the two sides of a shuffled join, the "
    "partial -> final step of a grouped aggregate) and the most a range "
    "exchange makes (ref: spark.sql.shuffle.partitions).",
    8, int)

SHUFFLE_PIPELINE_DEPTH = ConfEntry(
    "spark.rapids.tpu.sql.shuffle.pipelineDepth",
    "Map-side split batches in flight before the oldest batch's sizing "
    "read lands: batch k + 1's split launches before batch k's counts are "
    "read, and half a window's counts come back in one copy. 1 reads "
    "every batch's counts as it comes.",
    8, int)


def parse_bool(value: Any) -> bool:
    """'true'/'false' and their kin (the reference's boolean conf)."""
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"cannot parse boolean value: {value!r}")


INCOMPATIBLE_OPS = ConfEntry(
    "spark.rapids.tpu.sql.incompatibleOps.enabled",
    "Enable ops whose results differ from Spark's in corner cases: the "
    "ASCII-only case mappings Upper, Lower and InitCap (ref: "
    "spark.rapids.sql.incompatibleOps.enabled). Off, a plan that uses one "
    "raises NotImplementedError: the reference runs them on its host "
    "engine, which the port does not have yet.",
    False, parse_bool)


WHOLESTAGE_FUSION = ConfEntry(
    "spark.rapids.tpu.sql.wholeStageFusion.enabled",
    "MASTER fusion switch: per-operator fused stages (a project's or a "
    "filter's expressions, an aggregate's update inputs) run as one "
    "generated CUDA kernel per batch (plan/stage_codegen.py: K19 "
    "fused_stage, K20 fused_reduce). Off also disables the stage-level "
    "compiler gated by fusion.wholeStage, and every stage runs its eager "
    "torch ops.",
    True, parse_bool)

FUSION_WHOLE_STAGE = ConfEntry(
    "spark.rapids.tpu.sql.fusion.wholeStage",
    "STAGE-level fusion (plan/stage_compiler.py): a chain of filters and "
    "projects becomes one TpuWholeStageExec, and the chain directly below "
    "an aggregate folds into its update; each runs as one generated "
    "kernel per batch. Off, an aggregate folds a single filter only and "
    "the per-operator fused stages stay governed by "
    "wholeStageFusion.enabled.",
    True, parse_bool)


_BYTE_SUFFIXES = {"b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20,
                  "mb": 1 << 20, "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40,
                  "tb": 1 << 40}


def parse_bytes(value: Any) -> int:
    """'10m', '2g', '1024', -1 -> a byte count (Spark's byte strings)."""
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*([a-z]*)",
                     str(value).strip().lower())
    mult = _BYTE_SUFFIXES.get(m.group(2) or "b") if m else None
    if mult is None:
        raise ValueError(f"cannot parse byte value: {value!r}")
    return int(float(m.group(1)) * mult)


AUTO_BROADCAST_JOIN_THRESHOLD = ConfEntry(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold",
    "Build sides at or under this many bytes (the table bytes below them, "
    "counted as arrow counts them) are broadcast; larger builds "
    "hash-exchange both sides into a shuffled join (ref: "
    "spark.sql.autoBroadcastJoinThreshold). -1 turns broadcast off.",
    10 * 1024 * 1024, parse_bytes)


def _one_of(*allowed: str) -> Callable[[Any], str]:
    def check(value: Any) -> str:
        s = str(value).strip().lower()
        if s not in allowed:
            raise ValueError(f"{value!r} is not one of {'/'.join(allowed)}")
        return s
    return check


def _at_least(lo: int) -> Callable[[Any], int]:
    def check(value: Any) -> int:
        v = int(value)
        if v < lo:
            raise ValueError(f"{value!r} is below {lo}")
        return v
    return check


SHUFFLE_PLANE = ConfEntry(
    "spark.rapids.tpu.sql.shuffle.plane",
    "Shuffle exchange data plane: 'auto' (the device mesh's all_to_all "
    "when a mesh is active and the stage fits, the local split "
    "otherwise), 'ici' (force the mesh; planning fails without one), "
    "'dcn' (force the local split; the reference's host/TCP plane).",
    "auto", _one_of("auto", "ici", "dcn"))

MESH_ENABLED = ConfEntry(
    "spark.rapids.tpu.sql.mesh.enabled",
    "SPMD execution over a mesh of workers (parallel/mesh.py): 'auto' (a "
    "CUDA session with at least 2 workers), 'true' (force; fewer than 2 "
    "workers raises), 'false'. Routes supported group-by, join and sort "
    "plans through all_to_all pipelines instead of the local exchanges.",
    "auto", _one_of("auto", "true", "false", "1", "0"))

MESH_MAX_STAGE_BYTES = ConfEntry(
    "spark.rapids.tpu.sql.mesh.maxStageBytes",
    "Upper bound on the estimated input of a single-shot mesh stage (the "
    "whole input staged at once, receive windows workers x cap). "
    "Fixed-width and string-keyed group-bys above it stream in windows "
    "of mesh.streamWindowRows; other stages keep the local exchanges.",
    2 * 1024 * 1024 * 1024, parse_bytes)

MESH_STREAM_WINDOW_ROWS = ConfEntry(
    "spark.rapids.tpu.sql.mesh.streamWindowRows",
    "Rows per worker per round of the streaming mesh group-by (stages "
    "above mesh.maxStageBytes): a round holds workers x window input rows "
    "plus the group accumulator.",
    1 << 17, _at_least(1024))

MESH_WORKERS = ConfEntry(
    "spark.rapids.torch.mesh.workers",
    "Workers of the mesh, placed round robin on the visible devices of the "
    "session's device type (the counterpart of the XLA flag "
    "--xla_force_host_platform_device_count the reference's tests set). "
    "Workers that share a device exchange through one transpose. Default: "
    "the number of those devices.",
    None, _at_least(1))


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
