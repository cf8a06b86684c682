"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with a
plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/cruise_control_torch/lib<name>-<hash>.so

`-fmad=false` (and no fast-math flag) keeps every add, multiply, divide and
compare IEEE-identical to the plain PyTorch versions. Libraries land in
`build/cruise_control_torch/` at the repository root, named by the hash of
their source (and of the shared headers `*.cuh`), so an edited source
rebuilds and an unchanged one is reused. Builds happen at first use, never at import;
`build_all()` starts one `nvcc` per source, all at once.

That directory is the build cache: `compile_cache.enable_persistent_cache`
points it elsewhere (`set_build_dir`). Each library loaded into this process
leaves a `BuildRecord` (its name, the seconds its build or load took, and
whether nvcc built it or the cache held it) in `records()`; building a
library removes the stale ones of the same kernel from the cache
(`evictions()`).

Every wrapper calls its C entry point through `entry()`, whose argument
types are set once (each argument one by one: a device address, a 64-bit
integer, the stream last), with the stream from `raw_stream()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "cruise_control_torch"
KERNEL_SOURCES = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave",
                  "score_swaps", "pair_picks", "window_sum", "state_fingerprint",
                  "cluster_stats", "grid_shortlist", "delta_scatter", "elect_preferred",
                  "shard_merge", "partition_stats")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class BuildRecord(NamedTuple):
    """One kernel library loaded into this process."""

    name: str
    seconds: float  # from the start of its build_all call until it was loaded
    built: bool  # True: nvcc built it; False: the build cache held it


_RECORDS: List[BuildRecord] = []
_EVICTIONS = [0]


def set_build_dir(path) -> pathlib.Path:
    """Build and look up the libraries in `path` from now on."""
    global BUILD_DIR
    BUILD_DIR = pathlib.Path(path)
    return BUILD_DIR


def records() -> List[BuildRecord]:
    """Every library loaded into this process so far, in load order."""
    with _LOCK:
        return list(_RECORDS)


def loaded() -> int:
    """How many kernel libraries this process holds."""
    return len(_LIBS)


def evictions() -> int:
    """Stale libraries removed from the build cache by this process."""
    return _EVICTIONS[0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(name: str, out: pathlib.Path, pending) -> None:
    if pending is None:
        return
    proc, tmp, cmd = pending
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, out)
    # the library of an older source of the same kernel is stale for good
    for stale in out.parent.glob(f"lib{name}-*.so"):
        if stale != out:
            try:
                stale.unlink()
                _EVICTIONS[0] += 1
            except OSError:
                pass


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> float:
    """Compile every kernel library not built yet, one nvcc per source in
    parallel, and load them. Returns the seconds spent."""
    t0 = time.monotonic()
    with _LOCK:
        started = [(n, *_start(n)) for n in names if n not in _LIBS]
        for n, out, pending in started:
            # every nvcc started at t0: a library is ready when its own ends
            _finish(n, out, pending)
            _LIBS[n] = ctypes.CDLL(str(out))
            _RECORDS.append(BuildRecord(n, time.monotonic() - t0, pending is not None))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        lib.cc_error_string.restype = ctypes.c_char_p
        msg = lib.cc_error_string(ctypes.c_int(code)).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require(t, dtype, ndim: int, name: str, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank `ndim`
    (on `device` when given): what the C kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


#: argument types of a fast entry point: a device address or a stream, an integer
PTR, INT = ctypes.c_void_p, ctypes.c_longlong
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}


def entry(name: str, argtypes: Sequence) -> "ctypes._CFuncPtr":
    """The C entry point `name` of kernel library `name`, taking its
    arguments one by one (`argtypes`, each PTR or INT) and returning a
    cudaError_t. Set up once: a call converts each Python int straight to its
    C type, with no argument arrays built, and keeps the GIL (the entry point
    only launches, so releasing and taking back the lock would cost more than
    the call)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        load(name)
        fn = getattr(ctypes.PyDLL(str(_lib_path(name))), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def raw_stream(index: int) -> int:
    """The address of device `index`'s current CUDA stream, read without
    building a torch Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)
