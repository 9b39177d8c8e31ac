"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (``_build/lib<name>.so``), loaded
with ``ctypes``. The build runs at first use from the sources in the
checkout, one ``nvcc`` per source, all started together, and is skipped
for a library newer than its sources. Nothing here runs at import time.

The only process state is the loaded library handles, ``LAUNCHES``: one
plain integer per kernel (K7's outer mode and K13's locate mode have their
own), bumped by its wrapper where it launches, so a run can show which
kernels the main path went through; and ``HOST_STRING_PASSES``: one
integer per string expression that the reference itself runs on the host
(the general LIKE, replace, locate from a position past 1), bumped once
for each device -> host copy of a column it makes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel with its own launch counter; a mode of a kernel that is
# counted apart names its library in LIBRARY_OF
KERNELS = ("masked_reduce", "sort_key_lanes", "segment_bounds",
           "segment_reduce", "compact_scan", "join_probe", "join_expand",
           "join_expand_outer", "dense_stats", "slot_aggregate",
           "singleword_rank", "murmur3", "partition_split", "find_pattern",
           "build_matched", "cross_expand", "string_map", "string_slice",
           "string_place", "find_pattern_locate")
LIBRARY_OF = {"join_expand_outer": "join_expand",
              "find_pattern_locate": "find_pattern"}
# the libraries, one csrc/<name>.cu each
SOURCES = tuple(k for k in KERNELS if k not in LIBRARY_OF)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
# the string expressions the reference runs on the host, not TPU kernels
HOST_STRING_EXPRS = ("like", "replace", "locate")
HOST_STRING_PASSES: Dict[str, int] = {k: 0 for k in HOST_STRING_EXPRS}
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)


class KeyDesc(ctypes.Structure):
    """Mirror of ``KeyDesc`` in csrc/keys_common.cuh."""
    _fields_ = [("data", _P), ("valid", _P), ("lengths", _P),
                ("kind", _I), ("width", _I), ("len_bits", _I),
                ("ascending", _I), ("nulls_first", _I), ("pad", _I)]


class Operand(ctypes.Structure):
    """Mirror of ``Operand`` in csrc/string_place.cu."""
    _fields_ = [("data", _P), ("lengths", _P), ("valid", _P),
                ("width", _I), ("stride", _I)]


_SIGNATURES = {
    "masked_reduce": {
        "masked_reduce": (_I, [_I, _I, _P, _P, _P, _L, _I, _P, _P, _P, _I,
                               _P]),
        "masked_reduce_scratch_bytes": (_L, [_L]),
    },
    "sort_key_lanes": {
        "sort_key_lanes": (_I, [ctypes.POINTER(KeyDesc), _I, _P, _P, _L, _I,
                                _P, _P]),
    },
    "segment_bounds": {
        "segment_bounds": (_I, [ctypes.POINTER(KeyDesc), _I, _I, _I, _P, _L,
                                _P, _P, _P, _P, _P, _P]),
        "segment_bounds_scratch_bytes": (_L, [_L]),
    },
    "segment_reduce": {
        "segment_reduce": (_I, [_I, _I, _P, _P, _P, _P, _L, _I, _L, _P, _P,
                                _P, _P]),
        "segment_reduce_scratch_bytes": (_L, [_L]),
    },
    "compact_scan": {
        "compact_scan": (_I, [_P, _L, _P, _P, _P, _P]),
        "compact_scan_scratch_bytes": (_L, [_L]),
    },
    "join_probe": {
        "join_probe": (_I, [_P, _L, _P, _P, _L, _I,
                            ctypes.POINTER(ctypes.c_void_p), _I, _P, _P, _P,
                            _P, _P]),
    },
    "join_expand": {
        "join_expand": (_I, [_P, _P, _L, _I, _P, _P, _L, _P, _P, _P, _P,
                             _P]),
        "join_expand_scratch_bytes": (_L, [_L]),
    },
    "dense_stats": {
        "dense_stats": (_I, [_I, _P, _P, _P, _P, _L, _PP, _PP, _PI, _I, _P,
                             _P, _P, _P]),
        "dense_stats_scratch_bytes": (_L, [_L, _I]),
        "dense_stats_max_float_cols": (_I, []),
    },
    "slot_aggregate": {
        "slot_aggregate": (_I, [_P, _P, _P, _I, _P, _P, _P, _L, _I, _PP,
                                _PP, _PI, _PI, _I, _I, _P, _P, _P, _P]),
        "slot_aggregate_scratch_bytes": (_L, [_L, _I, _I, _I]),
        "slot_aggregate_max_features": (_I, []),
    },
    "singleword_rank": {
        "singleword_rank": (_I, [_I, _P, _P, _P, _P, _L, _P, _I, _I, _I, _P,
                                 _P]),
    },
    "murmur3": {
        "murmur3": (_I, [ctypes.POINTER(KeyDesc), _I, ctypes.c_uint, _P, _L,
                         _P, _I, _P, _P, _P]),
    },
    "partition_split": {
        "partition_split": (_I, [_P, _P, _L, _I, _P, _P, _P, _P]),
        "partition_split_scratch_bytes": (_L, [_L, _I]),
    },
    "find_pattern": {
        "find_pattern": (_I, [_P, _P, _L, _I, _P, _I, _I, _P, _P]),
    },
    "build_matched": {
        "build_matched": (_I, [_P, _P, _L, _P, _L, _P, _P, _P]),
        "build_matched_scratch_bytes": (_L, [_L]),
    },
    "cross_expand": {
        "cross_expand": (_I, [_P, _P, _L, _P, _P, _P, _P]),
    },
    "string_map": {
        "string_map": (_I, [_P, _P, _P, _L, _I, _I, _P, _P, _P]),
    },
    "string_slice": {
        "string_slice": (_I, [_P, _P, _P, _L, _I, _I, _P, _I, _P, _I, _P,
                              _P, _P]),
    },
    "string_place": {
        "string_place": (_I, [ctypes.POINTER(Operand), _I, _L, _I, _I, _I,
                              _P, _I, _P, _P, _P, _P]),
    },
}


def pointers(values) -> ctypes.Array:
    """A C array of pointers (None for NULL) to pass as ``void**``."""
    return (ctypes.c_void_p * max(len(values), 1))(*values)


def ints(values) -> ctypes.Array:
    """A C array of ints to pass as ``int*``."""
    return (ctypes.c_int * max(len(values), 1))(*values)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    srcs = [CSRC / f"{name}.cu"] + list(CSRC.glob("*.cuh"))
    return any(s.stat().st_mtime > built for s in srcs)


def build(names=SOURCES, force: bool = False) -> None:
    """Compile every stale kernel library (every one with ``force``), all
    ``nvcc`` processes started together. Raises with the compiler's output
    when a build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed: List[str] = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _LIBS[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def bump(name: str) -> None:
    LAUNCHES[name] += 1


def bump_host(name: str) -> None:
    HOST_STRING_PASSES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in HOST_STRING_PASSES:
        HOST_STRING_PASSES[k] = 0


def counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def host_counts() -> Dict[str, int]:
    return dict(HOST_STRING_PASSES)


def build_seconds() -> float:
    """Rebuild every kernel from its sources and load it: the seconds of a
    whole build, comparable from run to run whatever ``_build/`` held."""
    if _LIBS:
        raise RuntimeError("kernels already loaded: a rebuild would not be "
                           "the code that runs")
    t0 = time.perf_counter()
    build(SOURCES, force=True)
    for n in SOURCES:
        library(n)
    return time.perf_counter() - t0
