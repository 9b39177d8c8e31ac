"""TpuSession for the PyTorch port: ``TpuSession.builder.config(...)
.getOrCreate()`` and ``createDataFrame``, ported from
spark_rapids_tpu/api/session.py.

The session runs on one torch device, from ``spark.rapids.torch.device``
(default ``"cuda"``). Asking for CUDA where there is none raises: the port
never moves to the CPU by itself. The main path takes a dict of numpy
arrays (the masked entries of a masked array are NULL); pyarrow tables
and pandas frames are accepted too, with pyarrow or pandas imported only
for them. A column of python lists or dicts (or an arrow list, map or
struct column) is an ARRAY, MAP or STRUCT column, converted once to its
device layout on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config as cfg
from ..columnar import dtypes as dt
from ..columnar.batch import ColumnarBatch
from ..columnar.column import HostNested, is_nested
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
            if is_nested(t):
                columns[name] = HostNested.from_pylist(values, t)
                continue
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


def _infer_dtype(values) -> dt.DType:
    if isinstance(values, list):
        return _infer_nested(values)
    if values.dtype.kind in ("U", "S", "O"):
        return dt.STRING
    return dt.of(values.dtype)


def _is_nested_values(values) -> bool:
    return isinstance(values, (list, tuple)) and any(
        isinstance(v, (dict, list, tuple)) for v in values)


def _infer_nested(values: list) -> dt.DType:
    """The reference's inference (columnar/batch.py _infer_dtype): dicts
    are MAPs and lists ARRAYs, their key and value types widened across
    every row (an empty-map-only column is map<bigint,bigint>)."""
    if any(isinstance(v, dict) for v in values):
        ks = [k for d in values if isinstance(d, dict) for k in d]
        vs = [x for d in values if isinstance(d, dict) for x in d.values()
              if x is not None]
        if not ks:
            return dt.MAP(dt.INT64, dt.INT64)
        return dt.MAP(_widen_across(ks), _widen_across(vs or [0]))
    elems = [x for lst in values if isinstance(lst, (list, tuple))
             for x in lst if x is not None]
    if any(isinstance(x, str) for x in elems):
        return dt.ARRAY_STRING
    return dt.ARRAY(_widen_across(elems or [0]))


def _widen_across(values) -> dt.DType:
    """Widest primitive type across python values: a float widens ints to
    double, a string wins outright."""
    out = None
    for v in values:
        t = (dt.BOOL if isinstance(v, (bool, np.bool_)) else
             dt.INT64 if isinstance(v, (int, np.integer)) else
             dt.FLOAT64 if isinstance(v, (float, np.floating)) else dt.STRING)
        if out is None or out == t:
            out = t
        elif {out, t} == {dt.INT64, dt.FLOAT64}:
            out = dt.FLOAT64
        else:
            out = dt.STRING if dt.STRING in (out, t) else dt.FLOAT64
    return out or dt.INT64


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
            if _is_nested_values(values):    # lists / dicts: nested rows
                cols[name] = list(values)
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
            if is_nested(types[name]):
                cols[name] = arr.to_pylist()
                continue
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
