"""SQL type system for the PyTorch port's columnar data.

A copy of spark_rapids_tpu/columnar/dtypes.py (which imports no jax), kept
in the port so the port never imports the JAX package. Storage types are
numpy dtypes; columnar/column.py maps them to torch dtypes.

The reference piggybacks on Spark's Catalyst ``DataType`` and cuDF ``DType``
(type mapping in ``GpuColumnVector.java:40-535``). Here we define a small standalone
type lattice with mappings to numpy dtypes and Arrow types.

Timestamps are int64 microseconds since epoch (Spark semantics); dates are int32 days
since epoch — both match the reference's cuDF TIMESTAMP_MICROSECONDS / TIMESTAMP_DAYS
choices (GpuColumnVector.java type mapping).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass(frozen=True)
class DType:
    name: str
    numpy_dtype: Optional[np.dtype]   # physical storage dtype (None for STRING: uint8 matrix)
    is_numeric: bool = False
    is_integral: bool = False
    is_floating: bool = False
    byte_width: int = 0               # fixed-width storage bytes (0 for string)
    var_width: bool = False           # 2-D padded data + lengths (string/array)
    element: Optional["DType"] = None  # ARRAY element type / MAP value type
    key: Optional["DType"] = None      # MAP key type
    fields: Optional[tuple] = None     # STRUCT (name, DType) pairs

    def __repr__(self) -> str:
        return self.name


BOOL = DType("boolean", np.dtype(np.bool_), byte_width=1)
INT8 = DType("tinyint", np.dtype(np.int8), True, True, byte_width=1)
INT16 = DType("smallint", np.dtype(np.int16), True, True, byte_width=2)
INT32 = DType("int", np.dtype(np.int32), True, True, byte_width=4)
INT64 = DType("bigint", np.dtype(np.int64), True, True, byte_width=8)
FLOAT32 = DType("float", np.dtype(np.float32), True, is_floating=True, byte_width=4)
FLOAT64 = DType("double", np.dtype(np.float64), True, is_floating=True, byte_width=8)
STRING = DType("string", None, byte_width=0, var_width=True)
DATE = DType("date", np.dtype(np.int32), byte_width=4)            # days since epoch
TIMESTAMP = DType("timestamp", np.dtype(np.int64), byte_width=8)  # micros since epoch
NULLTYPE = DType("null", np.dtype(np.bool_), byte_width=1)

ALL_TYPES = [BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, STRING, DATE, TIMESTAMP]
_BY_NAME = {t.name: t for t in ALL_TYPES}
_ALIASES = {
    "long": INT64, "integer": INT32, "short": INT16, "byte": INT8,
    "bool": BOOL, "str": STRING, "float32": FLOAT32, "float64": FLOAT64,
    "real": FLOAT32,
}

INTEGRAL_TYPES = [INT8, INT16, INT32, INT64]
NUMERIC_TYPES = INTEGRAL_TYPES + [FLOAT32, FLOAT64]
ORDERABLE_TYPES = NUMERIC_TYPES + [BOOL, STRING, DATE, TIMESTAMP]

_ARRAY_CACHE: dict = {}


def ARRAY(element: DType) -> DType:
    """ARRAY<element> of a fixed-width primitive: stored like strings —
    padded element matrix ``elem_dtype[cap, W]`` + per-row lengths
    (complexTypeExtractors.scala's list scope, TPU-first layout)."""
    if element.var_width:
        raise TypeError(f"nested var-width array element {element} "
                        "not supported")
    t = _ARRAY_CACHE.get(element.name)
    if t is None:
        t = DType(f"array<{element.name}>", element.numpy_dtype,
                  var_width=True, element=element)
        _ARRAY_CACHE[element.name] = t
        _BY_NAME[t.name] = t
    return t


# array<string>: only flows through the CPU engine / explode fusion —
# the padded-matrix device layout is primitive-element only
ARRAY_STRING = DType("array<string>", None, var_width=True, element=STRING)
_BY_NAME[ARRAY_STRING.name] = ARRAY_STRING

_MAP_CACHE: dict = {}


def MAP(key: DType, value: DType) -> DType:
    """MAP<key, value> of fixed-width primitives. Physical layout (DESIGN
    stance: keep every transport/spill path ignorant of maps): ONE
    ``int64[cap, 3W]`` matrix of INTERLEAVED per-entry lanes —
    ``[k0, v0, ok0, k1, v1, ok1, ...]`` (key bitpattern, value bitpattern,
    value-validity flag) — plus per-row entry counts in ``lengths``.
    Interleaving makes the layout safe under the var-width width
    harmonization every concat/join/conditional path performs: right-
    padding appends whole empty lanes, which the entry count already
    masks. Map ops bitcast the strided planes back to the logical dtypes
    (complexTypeExtractors.scala's GetMapValue scope, TPU-first layout).
    String keys/values take the CPU path."""
    name = f"map<{key.name},{value.name}>"
    t = _MAP_CACHE.get(name)
    if t is None:
        if key.var_width or value.var_width or key.numpy_dtype is None or \
                value.numpy_dtype is None:
            # string/nested keys or values: CPU-engine-only dtype (the
            # planner's type gate tags it off the device, like ARRAY_STRING)
            t = DType(name, None, var_width=True, element=value, key=key)
        else:
            t = DType(name, np.dtype(np.int64), var_width=True,
                      element=value, key=key)
        _MAP_CACHE[name] = t
        _BY_NAME[name] = t
    return t


_STRUCT_CACHE: dict = {}


def STRUCT(fields) -> DType:
    """STRUCT<name:type,...>. No device layout of its own: the planner
    SHREDS referenced fields into flat child columns at the scan (the
    columnar-storage move — parquet stores structs shredded anyway), and a
    whole-struct value only materializes host-side through the
    python-object column path (like map<string,_>). The reference's analog
    is GpuColumnVector's nested-type matrix + complexTypeExtractors."""
    fields = tuple((n, t) for n, t in fields)
    name = "struct<" + ",".join(f"{n}:{t.name}" for n, t in fields) + ">"
    t = _STRUCT_CACHE.get(name)
    if t is None:
        t = DType(name, None, var_width=True, fields=fields)
        _STRUCT_CACHE[name] = t
        _BY_NAME[name] = t
    return t


def is_array(t: DType) -> bool:
    return t.element is not None and t.key is None


def is_map(t: DType) -> bool:
    return t.key is not None


def is_struct(t: DType) -> bool:
    return t.fields is not None


def of(name_or_dtype: Any) -> DType:
    """Resolve a DType from a name, numpy dtype, or python type."""
    if isinstance(name_or_dtype, DType):
        return name_or_dtype
    if isinstance(name_or_dtype, str):
        t = _BY_NAME.get(name_or_dtype) or _ALIASES.get(name_or_dtype)
        if t is None and name_or_dtype.startswith("array<") and \
                name_or_dtype.endswith(">"):
            return ARRAY(of(name_or_dtype[6:-1]))
        if t is None and name_or_dtype.startswith("map<") and \
                name_or_dtype.endswith(">"):
            inner = name_or_dtype[4:-1]
            depth = 0
            for i, ch in enumerate(inner):
                if ch == "<":
                    depth += 1
                elif ch == ">":
                    depth -= 1
                elif ch == "," and depth == 0:
                    return MAP(of(inner[:i].strip()),
                               of(inner[i + 1:].strip()))
        if t is None and name_or_dtype.startswith("struct<") and \
                name_or_dtype.endswith(">"):
            inner = name_or_dtype[7:-1]
            fields = []
            depth = 0
            start = 0
            for i, ch in enumerate(inner + ","):
                if ch == "<":
                    depth += 1
                elif ch == ">":
                    depth -= 1
                elif ch == "," and depth == 0:
                    part = inner[start:i].strip()
                    if part:
                        fname, _, ftype = part.partition(":")
                        fields.append((fname, of(ftype)))
                    start = i + 1
            return STRUCT(fields)
        if t is None:
            raise ValueError(f"unknown SQL type name {name_or_dtype!r}")
        return t
    if name_or_dtype is int:
        return INT64
    if name_or_dtype is float:
        return FLOAT64
    if name_or_dtype is bool:
        return BOOL
    if name_or_dtype is str:
        return STRING
    npdt = np.dtype(name_or_dtype)
    for t in ALL_TYPES:
        if t.numpy_dtype == npdt and t not in (DATE, TIMESTAMP):
            return t
    raise ValueError(f"cannot map {name_or_dtype!r} to a SQL type")


def from_arrow(arrow_type) -> DType:
    import pyarrow as pa
    if pa.types.is_boolean(arrow_type): return BOOL
    if pa.types.is_int8(arrow_type): return INT8
    if pa.types.is_int16(arrow_type): return INT16
    if pa.types.is_int32(arrow_type): return INT32
    if pa.types.is_int64(arrow_type): return INT64
    if pa.types.is_float32(arrow_type): return FLOAT32
    if pa.types.is_float64(arrow_type): return FLOAT64
    if pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type): return STRING
    if pa.types.is_date32(arrow_type): return DATE
    if pa.types.is_timestamp(arrow_type): return TIMESTAMP
    if pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type):
        return ARRAY(from_arrow(arrow_type.value_type))
    if pa.types.is_map(arrow_type):
        return MAP(from_arrow(arrow_type.key_type),
                   from_arrow(arrow_type.item_type))
    if pa.types.is_struct(arrow_type):
        return STRUCT([(arrow_type.field(i).name,
                        from_arrow(arrow_type.field(i).type))
                       for i in range(arrow_type.num_fields)])
    raise ValueError(f"unsupported arrow type {arrow_type}")


def to_arrow(t: DType):
    import pyarrow as pa
    mapping = {
        BOOL: pa.bool_(), INT8: pa.int8(), INT16: pa.int16(), INT32: pa.int32(),
        INT64: pa.int64(), FLOAT32: pa.float32(), FLOAT64: pa.float64(),
        STRING: pa.string(), DATE: pa.date32(), TIMESTAMP: pa.timestamp("us"),
    }
    if is_map(t):
        return pa.map_(to_arrow(t.key), to_arrow(t.element))
    if is_array(t):
        return pa.list_(to_arrow(t.element))
    if is_struct(t):
        return pa.struct([(n, to_arrow(ft)) for n, ft in t.fields])
    return mapping[t]


_NUMERIC_PRECEDENCE = [BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]


def promote(a: DType, b: DType) -> DType:
    """Numeric widening per Spark's TypeCoercion precedence
    (Byte < Short < Int < Long < Float < Double): the result is the higher-
    precedence type, so e.g. long + float -> float, int + smallint -> int."""
    if a == b:
        return a
    try:
        ia, ib = _NUMERIC_PRECEDENCE.index(a), _NUMERIC_PRECEDENCE.index(b)
    except ValueError:
        raise ValueError(f"cannot promote {a} and {b}") from None
    return _NUMERIC_PRECEDENCE[max(ia, ib)]


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True


class Schema:
    def __init__(self, fields):
        self.fields = [f if isinstance(f, Field) else Field(f[0], of(f[1])) for f in fields]
        # first occurrence wins on duplicate names (post-join schemas carry
        # both sides; USING-join dedup keeps the left copy, Spark semantics)
        self._index = {}
        for i, f in enumerate(self.fields):
            self._index.setdefault(f.name, i)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        return self.fields[self._index[key]]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def names(self):
        return [f.name for f in self.fields]

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self):
        inner = ", ".join(f"{f.name}: {f.dtype}" for f in self.fields)
        return f"Schema({inner})"
