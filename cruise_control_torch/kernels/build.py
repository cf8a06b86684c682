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
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "cruise_control_torch"
KERNEL_SOURCES = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave",
                  "score_swaps", "pair_picks", "window_sum", "state_fingerprint",
                  "cluster_stats", "grid_shortlist")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> float:
    """Compile every kernel library not built yet, one nvcc per source in
    parallel, and load them. Returns the seconds spent."""
    t0 = time.monotonic()
    with _LOCK:
        started = [(n, *_start(n)) for n in names if n not in _LIBS]
        for n, out, pending in started:
            _finish(n, out, pending)
        for n, out, _ in started:
            _LIBS[n] = ctypes.CDLL(str(out))
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


def ptrs(*tensors) -> "ctypes.Array":
    """A C array of the tensors' device addresses."""
    return (ctypes.c_longlong * len(tensors))(*(t.data_ptr() for t in tensors))


def ints(*values) -> "ctypes.Array":
    return (ctypes.c_longlong * len(values))(*(int(v) for v in values))


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


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
