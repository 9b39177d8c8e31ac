"""TpuSession for the PyTorch port: ``TpuSession.builder.config(...)
.getOrCreate()`` and ``createDataFrame``, ported from
spark_rapids_tpu/api/session.py.

The session runs on one torch device, from ``spark.rapids.torch.device``
(default ``"cuda"``). Asking for CUDA where there is none raises: the port
never moves to the CPU by itself. The main path takes a dict of numpy
arrays (the masked entries of a masked array are NULL); pyarrow tables
and pandas frames are accepted too, with pyarrow or pandas imported only
for them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config as cfg
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..plan import logical as lp
from ..plan import physical as ph
from ..plan.overrides import Overrides
from .dataframe import DataFrame


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"spark.rapids.torch.device={name!r} but no CUDA device is "
                "available; set it to 'cpu' to run on the CPU")
        return device
    if device.type == "cpu":
        return device
    raise ValueError(f"unsupported device {name!r}")


class TpuSessionBuilder:
    def __init__(self):
        self._settings: Dict[str, Any] = {}

    def config(self, key: Union[str, Dict[str, Any]], value: Any = None
               ) -> "TpuSessionBuilder":
        if isinstance(key, dict):
            self._settings.update(key)
        else:
            self._settings[key] = value
        return self

    def getOrCreate(self) -> "TpuSession":
        return TpuSession(cfg.TorchConf(self._settings))


class _BuilderAccessor:
    """A fresh builder per access: settings never leak across sessions."""

    def __get__(self, obj, objtype=None):
        return TpuSessionBuilder()


SchemaLike = Union[None, dt.Schema, Sequence[Tuple[str, Any]], Dict[str, Any]]


class TpuSession:
    builder = _BuilderAccessor()

    def __init__(self, conf: Optional[cfg.TorchConf] = None):
        self.conf = conf or cfg.TorchConf()
        self.device = resolve_device(self.conf.get(cfg.DEVICE))
        self.scan_cache = ph.ScanCache()
        self._last_plan: Optional[ph.TpuExec] = None
        self._last_decisions = None

    # -- data --------------------------------------------------------------
    def createDataFrame(self, data, schema: SchemaLike = None) -> DataFrame:
        """A DataFrame over an in-memory table: a dict of numpy arrays (or
        lists), a pyarrow Table or a pandas DataFrame. ``schema`` (a
        Schema, (name, type) pairs or a name -> type dict) gives the SQL
        types, e.g. DATE for int32 day counts; the rest are inferred."""
        columns, validity, types = _columns_of(data)
        want = {**types, **_schema_types(schema)}
        fields = []
        for name, values in columns.items():
            t = want.get(name) or _infer_dtype(values)
            fields.append(dt.Field(name, t))
            if t == dt.STRING and values.dtype.kind == "O":
                nulls = np.array([v is None for v in values], np.bool_)
                if nulls.any():
                    validity[name] = ~nulls & validity.get(
                        name, np.ones(len(values), np.bool_))
        table = lp.HostTable(columns, dt.Schema(fields), validity)
        return DataFrame(lp.LocalScan(table), self)

    # -- execution -----------------------------------------------------------
    def plan(self, analyzed: lp.LogicalPlan) -> ph.TpuExec:
        planner = Overrides(self.conf, self.device, self.scan_cache)
        node = planner.apply(analyzed)
        self._last_decisions = planner.decisions
        return node

    def _run(self, analyzed: lp.LogicalPlan) -> ColumnarBatch:
        exec_plan = self.plan(analyzed)
        self._last_plan = exec_plan
        # the scan cache evicts no column this query reads while it runs
        self.scan_cache.pin(k for scan in _scans(exec_plan)
                            for k in scan.cache_keys().values())
        try:
            return exec_plan.execute_collect()
        finally:
            self.scan_cache.pin(())
            for node in _nodes(exec_plan):
                node.release()

    def last_plan(self) -> Optional[ph.TpuExec]:
        return self._last_plan

    def last_fusion_decisions(self):
        """The stage compiler's record of the last plan
        (stage_compiler.FusionDecisions): stage notes, the units given a
        generated kernel and the ones left eager, with their reasons."""
        return self._last_decisions


def _nodes(node: ph.TpuExec):
    yield node
    for c in node.children:
        yield from _nodes(c)


def _scans(node: ph.TpuExec):
    return (n for n in _nodes(node) if isinstance(n, ph.TpuLocalScanExec))


def _schema_types(schema: SchemaLike) -> Dict[str, dt.DType]:
    if schema is None:
        return {}
    if isinstance(schema, dt.Schema):
        return {f.name: f.dtype for f in schema}
    items = schema.items() if isinstance(schema, dict) else schema
    return {name: dt.of(t) for name, t in items}


def _infer_dtype(values: np.ndarray) -> dt.DType:
    if values.dtype.kind in ("U", "S", "O"):
        return dt.STRING
    return dt.of(values.dtype)


def _columns_of(data) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                               Dict[str, dt.DType]]:
    """(numpy columns, validity masks of the columns that have NULLs, SQL
    types the input itself states)."""
    if isinstance(data, dict):
        cols, validity = {}, {}
        for name, values in data.items():
            if isinstance(values, np.ma.MaskedArray):   # masked = NULL
                validity[name] = ~np.ma.getmaskarray(values)
                cols[name] = values.filled(0)
                continue
            arr = np.asarray(values)
            if arr.dtype.kind == "O" and any(v is None for v in arr) and \
                    not any(isinstance(v, (str, bytes)) for v in arr):
                nulls = np.array([v is None for v in arr], np.bool_)
                filled = [0 if v is None else v for v in arr]
                arr = np.asarray(filled)
                validity[name] = ~nulls
            cols[name] = arr
        return cols, validity, {}
    mod = type(data).__module__
    if mod.startswith("pandas"):
        cols, validity = {}, {}
        for name in data.columns:
            s = data[name]
            nulls = s.isna().to_numpy()
            if s.dtype.kind == "O":
                cols[name] = np.asarray(
                    [None if n else v for v, n in zip(s.tolist(), nulls)],
                    dtype=object)
            else:
                cols[name] = s.to_numpy()
            if nulls.any() and s.dtype.kind != "f":
                validity[name] = ~nulls
        return cols, validity, {}
    if mod.startswith("pyarrow"):
        import pyarrow as pa
        cols, validity, types = {}, {}, {}
        for name in data.column_names:
            arr = data.column(name).combine_chunks()
            types[name] = dt.from_arrow(arr.type)
            if pa.types.is_date32(arr.type):
                arr = arr.view(pa.int32())
            if pa.types.is_string(arr.type) or \
                    pa.types.is_large_string(arr.type):
                cols[name] = np.asarray(arr.to_pylist(), dtype=object)
            else:
                cols[name] = arr.fill_null(0).to_numpy(zero_copy_only=False)
            if arr.null_count:
                validity[name] = np.asarray(arr.is_valid())
        return cols, validity, types
    raise TypeError(f"cannot build a DataFrame from {type(data).__name__}")
