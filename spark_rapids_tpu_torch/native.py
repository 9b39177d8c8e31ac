"""Build, load and count the port's CUDA kernels.

Each hand-written ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface
(``_build/lib<name>.so``), loaded with ``ctypes``. The build runs at first
use from the sources in the checkout, one ``nvcc`` per source, all started
together, and is skipped for a library newer than its sources. Nothing
here runs at import time.

The generated stage kernels (plan/stage_codegen.py: K19 ``fused_stage``,
K20 ``fused_reduce``) compile at first use with NVRTC, through ``ctypes``,
for ``sm_90a`` with FMA contraction off (``--fmad=false``) and without
fast math, into a cubin cached under ``_build/gen/<entry>.cubin`` (the
entry name carries the source's hash). They load through libcuda
(``cuModuleLoadData``) in PyTorch's primary context and launch with
``cuLaunchKernel`` on PyTorch's current stream. NVRTC takes a fraction of
a second per kernel where ``nvcc`` takes seconds, and a plan may hold a
few stages: that is why it, and not ``nvcc``, builds them.
``generated_stats()`` gives the kernels compiled, the cubins read from the
cache and the compile seconds. A compile or launch failure raises.

The only process state is the loaded libraries, modules and generated
functions, the generated kernels' stats, ``LAUNCHES``: one plain integer
per kernel (K7's outer mode, K13's locate mode, K1's fold and K21's
offset mode have their own; K6's lower-bound mode bumps ``join_probe``
and ``join_probe_lower``), bumped by its wrapper where it launches, so a
run can show which kernels the main path went through; and
``HOST_STRING_PASSES``: one integer per string expression that the
reference itself runs on the host (the general LIKE, replace, locate from
a position past 1), bumped once for each device -> host copy of a column
it makes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel with its own launch counter; a mode of a kernel that is
# counted apart names its library in LIBRARY_OF
KERNELS = ("masked_reduce", "sort_key_lanes", "segment_bounds",
           "segment_reduce", "compact_scan", "join_probe",
           "join_probe_lower", "join_expand",
           "join_expand_outer", "dense_stats", "slot_aggregate",
           "singleword_rank", "murmur3", "partition_split", "find_pattern",
           "build_matched", "cross_expand", "string_map", "string_slice",
           "string_place", "find_pattern_locate", "masked_reduce_fold",
           "fused_stage", "fused_reduce", "window_rank", "window_offset",
           "segmented_scan", "frame_bounds", "frame_aggregate",
           "explode_expand", "split_parts", "map_lookup", "map_build",
           "exchange_bucket", "exchange_flatten")
LIBRARY_OF = {"join_probe_lower": "join_probe",
              "join_expand_outer": "join_expand",
              "find_pattern_locate": "find_pattern",
              "masked_reduce_fold": "masked_reduce",
              "window_offset": "window_rank"}
# the kernels generated from plan/stage_codegen.py, built by NVRTC
GENERATED = ("fused_stage", "fused_reduce")
# the libraries, one csrc/<name>.cu each
SOURCES = tuple(k for k in KERNELS
                if k not in LIBRARY_OF and k not in GENERATED)
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


class ExchangeArray(ctypes.Structure):
    """Mirror of ``exch::Array`` in csrc/exchange_common.cuh."""
    _fields_ = [("src", _P), ("dst", _P), ("row_bytes", _L), ("unit", _I),
                ("pad", _I)]


class Operand(ctypes.Structure):
    """Mirror of ``Operand`` in csrc/string_place.cu."""
    _fields_ = [("data", _P), ("lengths", _P), ("valid", _P),
                ("width", _I), ("stride", _I)]


_SIGNATURES = {
    "masked_reduce": {
        "masked_reduce": (_I, [_I, _I, _P, _P, _P, _L, _I, _P, _P, _P, _I,
                               _P]),
        "masked_reduce_scratch_bytes": (_L, [_L]),
        "masked_reduce_num_parts": (_I, [_L]),
        "masked_reduce_fold": (_I, [_I, _I, _P, _P, _P, _I, _P, _P, _I,
                                    _P]),
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
        "join_probe": (_I, [_P, _L, _L, _I, _P, _L, _P, _L, _I,
                            ctypes.POINTER(ctypes.c_void_p), _I, _P, _L, _P,
                            _P, _P, _I, _P]),
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
        "cross_expand": (_I, [_L, _L, _L, ctypes.c_ulonglong, _P, _P, _P,
                              _P]),
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
    "window_rank": {
        "window_rank": (_I, [_I, _P, _P, _P, _P, _P, _L, _P, _P]),
        "window_offset": (_I, [_P, _P, _L, _L, _P, _P, _P]),
    },
    "segmented_scan": {
        "segmented_scan": (_I, [_I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                                _P, _P]),
        "segmented_scan_scratch_bytes": (_L, [_L]),
    },
    "frame_bounds": {
        "frame_bounds": (_I, [_I, _P, _P, _P, _P, _L, _I, _L, _I, _L, _P, _I,
                              _P, _I, _P, _P, _P]),
    },
    "frame_aggregate": {
        "frame_aggregate": (_I, [_I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                                 _P, _P, _I, _P, _P, _P]),
        "frame_aggregate_block_rows": (_I, []),
    },
    "explode_expand": {
        "explode_scratch_bytes": (_L, [_L]),
        "explode_scan": (_I, [_P, _P, _P, _L, _P, _P, _P]),
        "explode_expand": (_I, [_P, _P, _P, _L, _L, _P, _P, _P, _L, _I, _P,
                                _P, _P, _P, _P, _P]),
    },
    "split_parts": {
        "split_count": (_I, [_P, _P, _P, _L, _L, _I, _P, _P]),
        "split_place": (_I, [_P, _P, _L, _I, _P, _P, _L, _P, _P, _P, _P,
                             _P]),
    },
    "map_lookup": {
        "map_lookup": (_I, [_P, _P, _P, _L, _I, _I, _P, _P, _I, _L,
                            ctypes.c_double, _I, _I, _P, _P, _P]),
    },
    "exchange_bucket": {
        "exchange_bucket_max_arrays": (_I, []),
        "exchange_bucket_max_workers": (_I, []),
        "exchange_bucket": (_I, [ctypes.POINTER(ExchangeArray), _I, _P, _P,
                                 _I, _L, _P]),
    },
    "exchange_flatten": {
        "exchange_flatten_max_arrays": (_I, []),
        "exchange_flatten": (_I, [ctypes.POINTER(ExchangeArray), _I, _P, _I,
                                  _L, _L, _P, _P]),
    },
    "map_build": {
        "map_build_max_pairs": (_I, []),
        "map_build": (_I, [_PP, _PP, _PI, _PP, _PP, _PI, _I, _P, _L, _I, _P,
                           _P, _P, _P]),
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
    """PyTorch's current stream on ``device`` (a torch.device or its
    name), as a raw cudaStream_t: the calls that build no
    ``torch.cuda.Stream``, a microsecond or two less host time a launch."""
    index = getattr(device, "index", None)
    if index is None:
        index = _device_index(torch.device(device))
    return torch._C._cuda_getCurrentRawStream(index)


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


# ---------------------------------------------------------------------------
# Generated kernels: NVRTC -> cubin -> libcuda
# ---------------------------------------------------------------------------

GEN_DIR = BUILD_DIR / "gen"
NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "--fmad=false",
                 "--std=c++17")
_GEN_STATS = {"compiled": 0, "cached": 0, "seconds": 0.0}
_GEN_FUNCS: Dict[tuple, ctypes.c_void_p] = {}
_GEN_MODULES: List[ctypes.c_void_p] = []
_CUDA_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvrtc() -> ctypes.CDLL:
    lib = _CUDA_LIBS.get("nvrtc")
    if lib is not None:
        return lib
    import glob
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    found = [p for r in roots if r
             for p in sorted(glob.glob(os.path.join(r, "lib64",
                                                    "libnvrtc.so*")))]
    try:
        import nvidia.cuda_nvrtc  # noqa: F401 - PyTorch's CUDA wheels
        base = os.path.dirname(nvidia.cuda_nvrtc.__file__)
        found += sorted(glob.glob(os.path.join(base, "lib",
                                               "libnvrtc.so*")))
    except ImportError:
        pass
    found = [p for p in found if "builtins" not in p] + ["libnvrtc.so"]
    errors = []
    for path in found:
        try:
            lib = ctypes.CDLL(path)
            break
        except OSError as e:
            errors.append(str(e))
    else:
        raise RuntimeError("NVRTC not found: the generated stage kernels "
                           "cannot be built (" + "; ".join(errors) + ")")
    _declare(lib, _NVRTC_SIGNATURES)
    _CUDA_LIBS["nvrtc"] = lib
    return lib


_PSZ = ctypes.POINTER(ctypes.c_size_t)
_NVRTC_SIGNATURES = {
    "nvrtcCreateProgram": (_I, [_PP, ctypes.c_char_p, ctypes.c_char_p, _I,
                                _P, _P]),
    "nvrtcCompileProgram": (_I, [_P, _I, ctypes.POINTER(ctypes.c_char_p)]),
    "nvrtcGetProgramLogSize": (_I, [_P, _PSZ]),
    "nvrtcGetProgramLog": (_I, [_P, ctypes.c_char_p]),
    "nvrtcGetCUBINSize": (_I, [_P, _PSZ]),
    "nvrtcGetCUBIN": (_I, [_P, ctypes.c_char_p]),
    "nvrtcDestroyProgram": (_I, [_PP]),
    "nvrtcGetErrorString": (ctypes.c_char_p, [_I]),
}
_CUDA_SIGNATURES = {
    "cuInit": (_I, [ctypes.c_uint]),
    "cuGetErrorString": (_I, [_I, ctypes.POINTER(ctypes.c_char_p)]),
    "cuCtxGetCurrent": (_I, [_PP]),
    "cuDeviceGet": (_I, [_PI, _I]),
    "cuDevicePrimaryCtxRetain": (_I, [_PP, _I]),
    "cuCtxSetCurrent": (_I, [_P]),
    "cuModuleLoadData": (_I, [_PP, ctypes.c_char_p]),
    "cuModuleGetFunction": (_I, [_PP, _P, ctypes.c_char_p]),
    "cuLaunchKernel": (_I, [_P, ctypes.c_uint, ctypes.c_uint,
                            ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                            ctypes.c_uint, ctypes.c_uint, _P, _PP, _PP]),
}


def _declare(lib: ctypes.CDLL, signatures: dict) -> None:
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes


def _cuda() -> ctypes.CDLL:
    lib = _CUDA_LIBS.get("cuda")
    if lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        _declare(lib, _CUDA_SIGNATURES)
        _cu(lib, lib.cuInit(0), "cuInit")
        _CUDA_LIBS["cuda"] = lib
    return lib


def _cu(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUresult {rc} "
                           f"({(msg.value or b'').decode()})")


def _rtc(lib, rc: int, what: str, prog=None) -> None:
    if rc != 0:
        log = ""
        if prog is not None:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            buf = ctypes.create_string_buffer(size.value + 1)
            lib.nvrtcGetProgramLog(prog, buf)
            log = buf.value.decode(errors="replace")
        raise RuntimeError(f"{what} failed: "
                           f"{lib.nvrtcGetErrorString(rc).decode()}\n{log}")


def compile_generated(source: str, entry: str) -> bytes:
    """The sm_90a cubin of a generated kernel: from the cache, or compiled
    by NVRTC and cached."""
    path = GEN_DIR / f"{entry}.cubin"
    if path.exists():
        _GEN_STATS["cached"] += 1
        return path.read_bytes()
    lib = _nvrtc()
    t0 = time.perf_counter()
    prog = ctypes.c_void_p()
    _rtc(lib, lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                     f"{entry}.cu".encode(), 0, None, None),
         "nvrtcCreateProgram")
    try:
        opts = (ctypes.c_char_p * len(NVRTC_OPTIONS))(
            *[o.encode() for o in NVRTC_OPTIONS])
        _rtc(lib, lib.nvrtcCompileProgram(prog, len(NVRTC_OPTIONS), opts),
             f"NVRTC compile of {entry}", prog)
        size = ctypes.c_size_t()
        _rtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
             "nvrtcGetCUBINSize", prog)
        buf = ctypes.create_string_buffer(size.value)
        _rtc(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN", prog)
        cubin = buf.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    _GEN_STATS["compiled"] += 1
    _GEN_STATS["seconds"] += time.perf_counter() - t0
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    tmp = GEN_DIR / f"{entry}.cubin.tmp{os.getpid()}"
    tmp.write_bytes(cubin)
    os.replace(tmp, path)
    return cubin


def _device_index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def generated_kernel(source: str, entry: str, device) -> ctypes.c_void_p:
    """The loaded function of a generated kernel on ``device``."""
    key = (entry, _device_index(device))
    fn = _GEN_FUNCS.get(key)
    if fn is not None:
        return fn
    torch.cuda.init()
    cubin = compile_generated(source, entry)
    cuda = _cuda()
    _current_context(cuda, key[1])
    module = ctypes.c_void_p()
    _cu(cuda, cuda.cuModuleLoadData(ctypes.byref(module), cubin),
        f"cuModuleLoadData({entry})")
    _GEN_MODULES.append(module)
    fn = ctypes.c_void_p()
    _cu(cuda, cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                       entry.encode()),
        f"cuModuleGetFunction({entry})")
    _GEN_FUNCS[key] = fn
    return fn


def _current_context(cuda, index: int) -> None:
    """PyTorch's primary context of the device, current on this thread."""
    ctx = ctypes.c_void_p()
    _cu(cuda, cuda.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if ctx.value:
        return
    dev = ctypes.c_int()
    _cu(cuda, cuda.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
    _cu(cuda, cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
        "cuDevicePrimaryCtxRetain")
    _cu(cuda, cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def launch_generated(fn: ctypes.c_void_p, blocks: int, threads: int,
                     args: ctypes.Array, device) -> None:
    """One launch of a generated kernel whose only parameter is the packed
    argument block ``args``, on PyTorch's current stream."""
    cuda = _cuda()
    _current_context(cuda, _device_index(device))
    params = (ctypes.c_void_p * 1)(ctypes.addressof(args))
    rc = cuda.cuLaunchKernel(fn, blocks, 1, 1, threads, 1, 1, 0,
                             stream_ptr(device), params, None)
    _cu(cuda, rc, "cuLaunchKernel")


def build_generated(kernels, device) -> float:
    """Compile (dropping any cached cubin) and load every generated
    kernel of ``kernels`` (plan/stage_codegen.StageKernel objects): the
    seconds of a whole build."""
    t0 = time.perf_counter()
    for k in kernels:
        (GEN_DIR / f"{k.entry}.cubin").unlink(missing_ok=True)
        _GEN_FUNCS.pop((k.entry, _device_index(device)), None)
        generated_kernel(k.source, k.entry, device)
    return time.perf_counter() - t0


def generated_stats() -> Dict[str, float]:
    """Generated kernels compiled by NVRTC, read from the cubin cache,
    and the compile seconds, since the process started."""
    return dict(_GEN_STATS)
